"""Data-parallel training and slot sharding over cards (`parallel/dist.py`)."""
