"""Env knobs, logging, metrics and tracing for the port (stdlib only)."""
