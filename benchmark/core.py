"""One run of one cell: set-up, the measured window, the traced solves and
the probes, the check against the plain reference, and the result line.

The one traffic generator is a closed loop of solves: one client calls the
cell's entry point (``traffic["entry"]`` of ``lanczos_tpu_torch``, with
``traffic["kwargs"]``) on the configuration's operator, waits for the
answer (``torch.cuda.synchronize()``), and calls again.  Solve i starts
from a vector of Uniform(-1, 1) numbers drawn on the device by a
``torch.Generator`` seeded from (--seed, i).  The window ends with the
first solve that finishes at or after ``seconds``, so it holds whole
solves only.

The answers of ``traffic["check_solves"]`` solves, a reservoir sample of
the window drawn from the seed, stay on the device until the window has
closed; then the program's state is freed and the plain reference under
``benchmark/reference/`` judges them (:func:`judge`): the configuration's
H (``reference/<kind>.py``) and the traffic's algorithm in float64
(``reference/<traffic["reference"]>.py``), run again from each judged
solve's own start vector.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
import types

import numpy as np

from . import manifest, tracefile

__all__ = ["FORBIDDEN", "forbidden_modules", "seed_of", "run", "judge"]

#: Top-level module names that no process of the benchmark may hold: the
#: JAX package the port was made from, and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "lanczos_tpu")

#: Streams of random numbers drawn from --seed, one tag each (5 is the
#: metric probes' own).
START, SAMPLE, OPCHECK = 1, 2, 3

TRACE_DIR = manifest.HERE / "_traces"


def forbidden_modules():
    """The FORBIDDEN top-level names among the loaded modules' (each name
    compared whole, up to its first dot)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def seed_of(seed: int, *tags: int) -> int:
    """A 63-bit generator seed from --seed (any whole number) and tags."""
    ss = np.random.SeedSequence([seed % 2**64, *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Starts:
    """Vectors of Uniform(-1, 1) numbers drawn on the device from (seed,
    tag, index): solve i of the window starts from ``draw(i)``, the two
    warm-up solves from ``draw(-1)`` and ``draw(-2)``; the same draw, made
    again after the window, is the reference's start vector for that
    solve."""

    def __init__(self, seed, m, dtype, device):
        self.seed, self.m, self.dtype, self.device = seed, m, dtype, device

    def draw(self, index: int, tag: int = START):
        import torch

        gen = torch.Generator(device=self.device).manual_seed(
            seed_of(self.seed, tag, index + 2**20))
        return torch.rand(self.m, generator=gen, dtype=self.dtype, device=self.device) * 2 - 1


def card_label():
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def run(cell_name, seed, seconds, trace, *, t0=None, root=manifest.ROOT, device="cuda",
        tf32=None, entry_wrap=None, log=print):
    """Run one cell; returns (result line dict, exit code).

    ``device="cpu"``, ``tf32`` (the control: TF32 matmuls on) and
    ``entry_wrap`` (a fault planted around the entry point) are for the
    benchmark's own tests and control runs; the command line never sets
    them."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = manifest.Cell(manifest.load(root), cell_name, root)
    config, traffic = cell.config, cell.traffic
    import torch

    cuda = torch.device(device).type == "cuda"
    if cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        log(f"needs {cell.chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return None, 2
    setup = {}
    import lanczos_tpu_torch as lt

    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"] if tf32 is None else tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    setup["imports_s"] = time.perf_counter() - t0
    system = manifest.module("systems", config["kind"])
    t = time.perf_counter()
    system.kernels(lt, device)
    setup["kernels_s"] = time.perf_counter() - t
    t = time.perf_counter()
    op = system.build(lt, config, device)
    _sync(device)
    setup["build_s"] = time.perf_counter() - t
    m = op.shape[0]
    starts = Starts(seed, m, op.dtype, op.device)
    entry = getattr(lt, traffic["entry"])
    if entry_wrap is not None:
        entry = entry_wrap(entry)
    kwargs = traffic["kwargs"]

    def solve(v0):
        ts = time.perf_counter()
        res = entry(op, v0=v0, **kwargs)
        _sync(device)
        return res, {"wall_s": time.perf_counter() - ts}

    # The warm-up: every shape of the traffic, and the window's pattern of
    # memory, in which each solve runs while one sampled answer is held, so
    # that the allocator's cache has grown before the window opens.
    t = time.perf_counter()
    held_first, _ = solve(starts.draw(-1))
    solve(starts.draw(-2))
    del held_first
    setup["warmup_s"] = time.perf_counter() - t
    setup_peak = 0
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)

    # The window.
    n_check = int(traffic["check_solves"])
    n_trace = int(traffic["trace_solves"]) if trace else 0
    rng = np.random.default_rng(seed_of(seed, SAMPLE))
    held, solves, prof = [], [], None
    t_start = time.perf_counter()
    setup["total_s"] = t_start - t0
    while True:
        i = len(solves)
        v0 = starts.draw(i)
        if i < n_trace:
            if prof is None:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            with torch.profiler.record_function(tracefile.SOLVE_SPAN):
                res, rec = solve(v0)
            if i == n_trace - 1:
                prof.__exit__(None, None, None)
            rec["traced"] = True
        else:
            res, rec = solve(v0)
            rec["traced"] = False
        solves.append(rec)
        if len(held) < n_check:
            held.append((i, res))
        else:
            j = int(rng.integers(0, i + 1))
            if j < n_check:
                held[j] = (i, res)
        del res, v0
        if time.perf_counter() - t_start >= seconds and len(solves) >= n_trace:
            break
    window_s = time.perf_counter() - t_start
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else None

    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        return None, 3
    record = {"cell": cell.name, "config": config, "traffic": traffic, "setup": setup,
              "solves": solves, "window_s": window_s, "window_peak_bytes": window_peak,
              "trace": None, "probes": {}}
    metrics_wanted = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: manifest.module("metrics", m["name"]) for m in metrics_wanted}
    if trace:
        TRACE_DIR.mkdir(exist_ok=True)
        path = TRACE_DIR / f"{cell.name}.json"
        prof.export_chrome_trace(str(path))
        del prof
        record["trace"] = tracefile.load(path)
        ctx = types.SimpleNamespace(op=op, device=device, starts=starts, config=config,
                                    traffic=traffic)
        for name, mod in readers.items():
            if hasattr(mod, "probe"):
                record["probes"][name] = mod.probe(ctx)
        del ctx
    card = card_label() if cuda else "cpu"

    # The check: the operator's H x, then the held answers, against the
    # reference, once the program's state is gone.
    t_check = time.perf_counter()
    x = starts.draw(0, tag=OPCHECK)
    op_check = {"x": x.double(), "y": op.matvec(x).double()}
    answers = [(i, res.eigenvalues, res.eigenvectors, res.residuals.double().cpu().numpy())
               for i, res in held]
    del op, held, x
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = manifest.module("reference", config["kind"]).build(config, device)
    plain = manifest.module("reference", traffic["reference"])
    numbers = judge(ref, plain, op_check, answers, kwargs, m,
                    lambda i: starts.draw(i).double(), log)
    t_check = time.perf_counter() - t_check
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        return None, 3

    metrics = {}
    for metric in metrics_wanted:
        value = readers[metric["name"]].read(record)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    limits = cell.limits
    correct = bool(limits) and all(numbers[name] <= limits[name] for name in limits)
    # A malformed answer reads inf, which JSON cannot hold: it prints as null.
    numbers = {name: v if math.isfinite(v) else None for name, v in numbers.items()}
    checks = {name: {"value": numbers[name], "limit": limits[name]} for name in limits}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": max(setup_peak, window_peak or 0)}
    line = {"correct": correct, "attempted": len(solves),
            "failed": 0 if correct else max(1, len(answers)), "metrics": metrics, "device": dev}
    if trace:
        tr = record["trace"]
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": [list(o) for o in tr.device_ops()],
                             "idle_gaps": [list(g) for g in tr.named_gaps()]}
    line["readings"] = numbers
    line["checks"] = checks

    walls = [s["wall_s"] for s in solves]
    log(f"card: {card}; cell {cell.name} seed {seed} trace {int(trace)}; "
        f"set-up {json.dumps(setup)}")
    log(f"window: {len(solves)} solves in {window_s:.6f} s; walls {walls}; "
        f"peak {window_peak} B; judged solves {[i for i, *_ in answers]} in {t_check:.3f} s")
    log("readings: " + json.dumps(numbers))
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return line, 0


def _true_residuals(ref, lam, X):
    """||H x_i - lam_i x_i|| / ||x_i|| under the reference's H, numpy."""
    import torch

    R = ref.apply(X) - X * torch.as_tensor(lam, device=X.device)
    return (torch.linalg.vector_norm(R, dim=0) / torch.linalg.vector_norm(X, dim=0)).cpu().numpy()


def judge(ref, plain, op_check, answers, kwargs, m, start_of, log=lambda msg: None):
    """The numbers that decide ``correct`` (see PERF.md), each a share of
    the reference's ||H||_inf but ``orth``:

    * ``op_err``: the largest gap between the program's H x and the
      reference's for one seeded x (float32 values in both), over the
      largest |H x|;
    * ``eig_gap``: for each judged solve i, the plain algorithm
      (``plain.solve``) runs in float64 from the same start vector
      (``start_of(i)``), and the program's eigenvalues, in ascending order,
      are held to its own one by one: the largest gap;
    * ``resid_excess``: the most by which a pair's true residual
      ||H x - lam x|| / ||x|| under the reference's H exceeds the residual
      the program reports for it;
    * ``orth``: the largest entry of |X^T X - I| over the returned vectors
      scaled to unit length.

    A malformed answer (wrong shapes, a non-finite value) reads inf."""
    import torch

    y_ref = ref.apply(op_check["x"])
    yp = op_check["y"].to(y_ref.device)
    out = {"op_err": float((yp - y_ref).abs().max() / y_ref.abs().max()), "eig_gap": 0.0,
           "resid_excess": 0.0, "orth": 0.0}
    nh = ref.norm_inf
    k = int(kwargs["k"])
    for i, lam_t, X, claimed in answers:
        if tuple(lam_t.shape) != (k,) or tuple(X.shape) != (m, k) or claimed.shape != (k,) \
                or not bool(torch.isfinite(lam_t).all()) or not bool(torch.isfinite(X).all()):
            return {**{name: math.inf for name in out}, "op_err": out["op_err"]}
        lam = lam_t.double().cpu().numpy()
        order = np.argsort(lam, kind="stable")
        lam, claimed = lam[order], claimed[order]
        X = X[:, torch.as_tensor(order, device=X.device)].double()
        theta, _, _ = plain.solve(ref.apply, start_of(i), kwargs)
        r = _true_residuals(ref, lam, X)
        Xn = X / torch.linalg.vector_norm(X, dim=0)
        gram = Xn.T @ Xn - torch.eye(k, dtype=Xn.dtype, device=Xn.device)
        del X, Xn
        log(f"solve {i}: eigenvalues {lam.tolist()}; plain {theta.tolist()}; "
            f"true residuals {r.tolist()}; claimed {claimed.tolist()}")
        out["eig_gap"] = max(out["eig_gap"], float(np.abs(lam - theta).max()) / nh)
        out["resid_excess"] = max(out["resid_excess"],
                                  float(np.maximum(r - claimed, 0.0).max()) / nh)
        out["orth"] = max(out["orth"], float(gram.abs().max()))
    return out
