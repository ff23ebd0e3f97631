"""Serving steps of the port's LM (``launch.steps``)."""
