"""Drivers: one general generator per entry point of the program.  A
traffic file names its driver under ``"driver"``."""
