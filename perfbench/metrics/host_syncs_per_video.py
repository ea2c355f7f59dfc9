"""Points at which the host waited for the device inside
SlidingWindowInpainter.__call__ (blocking copies between host and
device, and any other synchronizing operation), per traced video.
`host_syncs` is a count that the program's StageTimer returns beside its
spans (in `stages_ms`, under a name of its own); a program without it
reads None. Read for every serving cell (`.hq` and `.f32` are its names
in those cells)."""


def read(run):
    stages = run.get("stages_ms") or {}
    if "host_syncs" not in stages or not run.get("latencies"):
        return None
    return stages["host_syncs"] / len(run["latencies"])
