"""The tracker of the frozen copy (see ``benchmark/frozen/__init__.py``)."""
