"""Solve ladders shared by the fitter and the grid."""
