"""Host-side helpers of the port: color-space conversion, CUDA-event timing,
profiling, the accuracy and compression metrics, and the file layer (the
.tdc/.tdcc serializer, the entropy stages on the host C library, image
I/O) and the streamed codec for images beyond device memory."""
