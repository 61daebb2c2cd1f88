"""Per-frame models of the port: ORB front-end, RGB-D tracking, odometry."""
