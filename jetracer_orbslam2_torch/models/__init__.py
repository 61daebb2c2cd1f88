"""Per-frame models of the port: ORB front-end (RGB-D and stereo), tracking,
odometry, the IMU prior and the SLAM system."""
