"""The benchmark's harness: the window, the traffic generator, the tracing and
its reduction to metrics, the roofline's work counts and peaks."""
