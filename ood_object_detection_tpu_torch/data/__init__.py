"""On-device input preprocessing and episode assembly."""
