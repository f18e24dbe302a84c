"""Reading float checkpoints into the port's collapsed parameters."""
