"""Runnable models of the port."""
