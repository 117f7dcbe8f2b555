"""The training path of the port: losses, steps, optimizer, data, checkpoints, loop."""
