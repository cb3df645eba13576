"""The harness's general parts: what every cell shares."""
