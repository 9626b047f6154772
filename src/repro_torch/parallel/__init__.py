"""Split-learning pipelining models (the port of ``repro/parallel``'s numpy
latency model; the microbatched split step comes later)."""
