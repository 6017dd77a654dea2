"""The benchmark's general code: loading cells by name, the traffic
generator, the window and the result line, tracing and its reduction, and
the operation and byte counts."""
