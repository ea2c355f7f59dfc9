"""The caching allocator's calls to the driver (cudaMalloc and cudaFree,
`num_device_alloc + num_device_free` of torch.cuda.memory_stats()) inside
SlidingWindowInpainter.__call__, per traced video. `device_alloc_calls`
is a count that the program's StageTimer returns beside its spans; 0 is
a reading (a count, not a share), and a program or a device without it
reads None. Read for every serving cell (`.hq` and `.f32` are its names
in those cells)."""


def read(run):
    stages = run.get("stages_ms") or {}
    if "device_alloc_calls" not in stages or not run.get("latencies"):
        return None
    return stages["device_alloc_calls"] / len(run["latencies"])
