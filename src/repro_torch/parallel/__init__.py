"""Split-learning pipelining (the port of ``repro/parallel/pipeline.py``:
the microbatched split step and the latency model)."""
