"""Runnable entry points of the port (``serve``)."""
