"""Single-GPU predict step."""
