"""Device and precision helpers shared by every entry point."""
