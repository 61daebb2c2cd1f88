"""Frame sources of the port.  Only the synthetic generator is ported so far."""
