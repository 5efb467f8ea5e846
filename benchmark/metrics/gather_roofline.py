"""gather_roofline: the gather stage's bound a step times the graph
replays split, over the device time of the gather stage's events in
those replays.

The bound is ``bounds.step_bounds``' "gather" term (harness/bounds.py
``_gather``): each output a dot of its own 2m taps, counted as the
banded family counts its dot products, 3 (3xTF32) x 2 x 2 planes x 2m
operations an output of each channel at the TF32 peak (495e12/s),
against the block in (the wire's bytes a frame as stage 0, else 8 for
the planes) and the stage's 2m - 1 frames of history planes, and the
outputs out (4 bytes a frame where the stage packs the cs16 wire, else
8), at 3.35 TB/s; the larger of the two.  At the HackRF's step (64 x
256,172 cs8 frames in, 19,064 out, 216 taps) the bytes bind.

The stage's time comes from the traced window's graph replays, split by
the program's stage map (``trace.stage_map()`` in
iq_tool_tpu_torch/pipeline/trace.py: the newest capture's [(stage,
device nodes)] in capture order and the graph's node count).  A replay's
device events are those with the correlation id of a ``cudaGraphLaunch``;
in order of start, the k-th goes to the map's k-th node, and a replay
whose event count is not the map's is not split.  So the gather stage's
torch kernels (cats, copies, ``embedding_bag``), whose names other stages
launch too, are apportioned by where the capture put them.

Nothing is read where the program publishes no map, where the chain has
no gather stage, or where under half the traced replays split.  The
harness's ``run.prof`` is the profiler of the traced window; where the
harness has already let go of it (``run.py`` drops it once the device
trace is read), the reader finds the stopped profiler that is still in
memory."""

import collections
import gc

from benchmark.reference import design as D


def stage_map():
    """The program's newest capture's (stage map, graph nodes), or None
    where the program publishes none."""
    try:
        from iq_tool_tpu_torch.pipeline import trace
    except ImportError:
        return None
    read = getattr(trace, "stage_map", None)
    return read() if read is not None else None


def traced_profile(run):
    """The traced window's finished torch.profiler: ``run.prof``, else
    the one stopped profiler still in memory; None where there is none
    or more than one."""
    if getattr(run, "prof", None) is not None:
        return run.prof
    import torch
    found = [o for o in gc.get_objects() if type(o) is torch.profiler.profile
             and getattr(o.profiler, "kineto_results", None) is not None]
    return found[0] if len(found) == 1 else None


def graph_events(prof) -> tuple:
    """(correlation ids of the window's graph launches, the card's events
    [(correlation id, start ns, duration ns, name)]: kernels, copies and
    memsets, without the card's images of host ranges)."""
    events = prof.profiler.kineto_results.events()
    host = [e for e in events if e.device_type().name != "CUDA"]
    names = {e.name() for e in host}
    launches = {e.correlation_id() for e in host if "GraphLaunch" in e.name()}
    dev = [(e.correlation_id(), e.start_ns(), e.duration_ns(), e.name()) for e in events
           if e.device_type().name == "CUDA" and e.name() not in names]
    return launches, dev


def split_stage(launches, events, stages: list, stage: str) -> tuple:
    """(graph launches traced, launches split, seconds of ``stage``'s
    events in the split launches): each launch's events by start, the
    k-th to the k-th node of ``stages`` ([(stage, nodes)]); a launch
    whose event count is not the map's is not split."""
    names = [name for name, n in stages for _ in range(n)]
    by_launch = collections.defaultdict(list)
    for corr, t0, dur, _ in events:
        if corr in launches:
            by_launch[corr].append((t0, dur))
    split, ns = 0, 0
    for evs in by_launch.values():
        if len(evs) != len(names):
            continue
        split += 1
        ns += sum(dur for (_, dur), name in zip(sorted(evs), names) if name == stage)
    return len(by_launch), split, ns / 1e9


def gather_stage(chain: dict, n_in: int, rows: int = 1) -> str | None:
    """The span of the resampler's gather stage (``chain.resample.<i>``),
    or None where its plan has none."""
    plan = D.plan_resampler(float(chain["target_rate"]) / float(chain["input_rate"]),
                            n_in // rows)
    return next((f"chain.resample.{i}" for i, st in enumerate(plan.stages)
                 if isinstance(st, D.Gather)), None)


def read(run):
    bound = run.bounds.get("gather")
    stage = gather_stage(run.cell.chain, run.n_in, run.rows) if bound else None
    mapped = stage_map() if stage else None
    if mapped is None or sum(n for _, n in mapped[0]) != mapped[1]:
        return None
    prof = traced_profile(run)
    if prof is None:
        return None
    traced, split, sec = split_stage(*graph_events(prof), mapped[0], stage)
    if not traced or 2 * split < traced or sec <= 0:
        return None
    return 100.0 * bound * split / sec
