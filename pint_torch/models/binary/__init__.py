"""Binary-orbit delay models of the port (DD in this slice)."""
