"""The benchmark's own code: loading cells by name, the program's scenes,
timing, the profiler reading and the frozen work counts."""
