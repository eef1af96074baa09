"""Data: the gaze scan-path simulation and the procedural clip corpus."""
