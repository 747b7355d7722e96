"""Drivers: one general generator and loop per kind of traffic, which a
traffic file names by ``driver``."""
