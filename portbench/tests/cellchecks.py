"""The checks that every cell's tests share: the entry's metrics and the
operations a traced call holds."""

from portbench import harness, tracing

#: the layers of the per-layer metrics that every cell reports
SHARED = {"device_idle_pct": "device (H100)", "glue_us": "codec_cuda glue", "idle_in_program_pct": "codec_cuda glue",
          "launch_us": "codec_cuda launch (current device, raw stream handle, ctypes, CUDA runtime)"}
SHARED_READERS = [f"{m}.{d}" for m in SHARED for d in ("compress", "decompress")]
E2E = {"compress_gbps", "decompress_gbps", "compress_p95_ms", "decompress_p95_ms", "setup_s"}


def check_entry_metrics(bench, cell, readers, layer):
    """``cell`` reports every end-to-end metric, its own ``readers`` (layer
    ``layer``, or ``codec_cuda glue`` for the ops a call) and ``SHARED``'s."""
    assert {m["name"] for m in harness.cell_metrics(bench, "end_to_end", cell)} == E2E
    layers = {m["name"]: m for m in harness.cell_metrics(bench, "per_layer", cell)}
    assert set(layers) == set(readers) | set(SHARED_READERS)
    for name, m in layers.items():
        assert m["moves"] == name.rsplit(".", 1)[1] + "_gbps"
        if name in readers:
            assert m["workloads"] == [cell]
            assert m["layer"] == (layer if name.startswith("kernel_roofline") else "codec_cuda glue")
        else:
            assert cell in m["workloads"] and m["layer"] == SHARED[name.split(".")[0]]


def check_ops_a_call(r, compress: int, decompress: int):
    """The traced stretch of ``r`` holds ``compress`` / ``decompress``
    device operations a call of each direction, give or take what the trace
    lost: operations whose launch record is missing, which ``tracing``
    places by their time on the card, in a neighbouring call or in none,
    and launches whose operation is missing (on an H100, the memset and
    kernel of a stretch's first call, where other cells were traced before
    in the process)."""
    lost = r.device["ops_without_launch"] + r.device["launches_without_op"]
    for d, per_call in (("compress", compress), ("decompress", decompress)):
        calls = tracing.calls_of(r.record, d)
        assert abs(sum(len(c.ops) for c in calls) - per_call * len(calls)) <= lost
