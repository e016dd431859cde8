"""Host-side helpers of the port: color-space conversion, CUDA-event timing,
profiling and the accuracy metrics."""
