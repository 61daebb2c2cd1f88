"""The benchmark's machinery: what a cell is made of (`spec`), the traffic
generator (`traffic`), the measured window (`window`), the arithmetic of its
metrics (`stats`, `work`), the profiler passes (`trace`) and the comparison
that decides `correct` (`check`)."""
