"""Map store, bundle adjustment and pose graph (counterparts of the modules
under `jetracer_orbslam2_tpu/models/backend/`)."""
