"""On-device input preprocessing."""
