"""Role entry points of the port (the miner so far)."""
