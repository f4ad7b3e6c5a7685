"""Fit-integrity helpers of the port (robust reweighting)."""
