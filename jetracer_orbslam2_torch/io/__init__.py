"""Frame sources of the port: the synthetic generators (`synthetic`), the
TUM RGB-D / EuRoC / KITTI loaders (`datasets`) and the native PNG decoder
(`native_loader`)."""
