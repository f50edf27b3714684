"""Training over ranks and serving over several devices."""
