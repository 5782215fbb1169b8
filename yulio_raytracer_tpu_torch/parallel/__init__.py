"""Rendering over several devices and processes: pixel and triangle
parallelism (sharding.py) and the TCP render servers (network.py)."""
