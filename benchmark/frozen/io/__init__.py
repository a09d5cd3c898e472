"""The configuration parser of the frozen copy."""
