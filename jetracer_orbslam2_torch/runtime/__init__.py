"""Host runtime of the port: frame pipeline, liveness watchdog,
checkpointing, BSON/WebSocket telemetry.

Counterpart of `jetracer_orbslam2_tpu/runtime/`, the analogue of the
reference's runtime — the event-bus worker threads (src/EventsThread.{h,cpp}),
the frame scheduler (src/SlamGpuPipeline/SlamGpuPipeline.cpp) and the
WebSocket telemetry server (src/WebSocket/WebSocketCom.cpp) — rebuilt as a
thin host layer around the card's work.  Worker threads never touch the
card; every CUDA call stays on the thread that drives the frame loop.
"""

from jetracer_orbslam2_torch.runtime.pipeline import FramePipeline, PipelineStats
from jetracer_orbslam2_torch.runtime.checkpoint import (
    save_checkpoint, load_checkpoint)

__all__ = [
    "FramePipeline",
    "PipelineStats",
    "save_checkpoint",
    "load_checkpoint",
]
