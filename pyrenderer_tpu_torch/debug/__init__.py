"""Ray-path debug records of chosen pixels (debug/logger.py)."""
