"""Probes: scripts that measure one question about the port on the card
and print what they saw. Nothing in the port imports them."""
