"""Generation loop."""
