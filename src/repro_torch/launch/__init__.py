"""Entry points of the port and the device layout of its pipeline runtime."""
