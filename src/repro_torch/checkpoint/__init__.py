"""Checkpoint-side fault tolerance (the straggler watchdog)."""
