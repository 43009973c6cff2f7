"""Data helpers of the port: mini-batch sampling and synthetic datasets."""
