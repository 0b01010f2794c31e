"""Training utilities of the port (the AdamW optimizer and its schedules)."""
