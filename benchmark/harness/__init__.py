"""The general parts of the harness: cells found by name, work counted
from shapes, trace reduction and the comparison that decides ``correct``."""
