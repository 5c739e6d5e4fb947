"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain torch version on the card (bit-exact: the
kernels count integers), times them, checks the walk's two engines against
each other, and then drives the port's main path: ``repro_torch.compile``
on the 11-kernel suite at 4x4 with a sweep width of 4, with the default
solver and with the GPU walk as the solver. Every phase prints one JSON
line; the last line is ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero without that line, as does a machine without
CUDA or a directory without the port's sources.
"""
import json
import os
import statistics
import subprocess
import sys
import time

# the reference mapper's IIs at 4x4, sweep width 4, default solver; patricia
# is unmappable there (every II up to MII+16 is refuted). A CPU test
# (tests/test_torch_mapper.py) holds this table to the JAX package.
EXPECTED_II_4X4 = {"sha": 7, "sha2": 8, "gsm": 6, "patricia": None,
                   "bitcount": 6, "backprop": 6, "nw": 5, "srand": 3,
                   "hotspot": 7, "basicmath": 8, "stringsearch": 5}
WALKSAT_KERNELS = ("sha", "gsm", "nw")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
INT_OPS_PER_S = 67e12            # H100 SXM non-tensor 32-bit rate
REPS = 50


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(torch, fn, reps=REPS, flush=None):
    """Median device time of ``fn`` over ``reps`` launches, from CUDA
    events around each call, after warm-up. The stream is held by a sleep
    kernel while the host queues the calls, so a fast kernel is timed on
    the device and not at the host's launch rate; ``flush`` (outside the
    events) evicts L2 first where the caller finds it cold."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for s, e in ev:
        if flush is not None:
            flush()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def environment(torch):
    from repro_torch.kernels._cuda import nvcc_path
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    import networkx
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("environment", python=sys.version.split()[0],
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc[-1], triton=triton_version,
         networkx=networkx.__version__, nvidia_smi=smi,
         device=torch.cuda.get_device_name(0))
    return smi


def sha_window(size, k=4):
    from repro_torch.core import suite
    from repro_torch.core.cgra import CGRA
    from repro_torch.core.encode import EncoderSession
    from repro_torch.core.schedule import min_ii
    r, c = int(size[0]), int(size[2])
    g = suite.get("sha")
    cgra = CGRA(r, c)
    mii = min_ii(g, cgra)
    sess = EncoderSession(g, cgra)
    return [sess.encode(ii).cnf for ii in range(mii, mii + k)]


def clause_eval_bound_ms(cvars, v1, B):
    """Least time for the window's counts: the clause tables (int32 var +
    sign byte per literal slot) and assignments read once, the counts
    written once; one compare per (chain, literal) that is not padding."""
    K, C, L = cvars.shape
    nbytes = K * C * L * 5 + K * B * v1 + K * B * C * 4
    ops = int((cvars > 0).sum()) * B
    return max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S) * 1e3, \
        "bytes" if nbytes / HBM_BYTES_PER_S >= ops / INT_OPS_PER_S \
        else "operations"


def flip_update_bound_ms(occ_c):
    K, B, O = occ_c.shape
    valid = int((occ_c >= 0).sum())
    # read v_flip, new_val, occ_c, occ_s; write the assignment byte;
    # read + write each touched true count
    nbytes = K * B * (4 + 1 + 1 + 5 * O) + valid * 8
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def kernel_phase(torch):
    """Parity (bit-exact) and times of every kernel at the main path's
    shapes (the 4x4 window, 24 chains) and at the 8x8 window."""
    from repro_torch.convert import window_from_numpy
    from repro_torch.core.sat import walksat_torch as W
    from repro_torch.kernels.clause_eval import (
        true_counts, true_counts_ref, true_counts_window,
        true_counts_window_ref)
    from repro_torch.kernels.flip_update import flip_update, flip_update_ref
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    out = {}
    # random tables, 0-padding anywhere in a row
    cv = torch.randint(0, 301, (3, 5000, 7), generator=gen, device=dev,
                       dtype=torch.int32)
    cs = torch.rand((3, 5000, 7), generator=gen, device=dev) < 0.5
    a = torch.rand((3, 24, 301), generator=gen, device=dev) < 0.5
    if not torch.equal(true_counts_window(cv, cs, a),
                       true_counts_window_ref(cv, cs, a)):
        raise AssertionError("clause_eval window != plain on random tables")
    if not torch.equal(true_counts(cv[0], cs[0], a[0]),
                       true_counts_ref(cv[0], cs[0], a[0])):
        raise AssertionError("clause_eval K=1 != plain on random tables")
    emit("parity_random", clause_eval_window=True, clause_eval=True)

    windows = {}
    for size, batches in (("4x4", (24,)), ("8x8", (24, 256))):
        t0 = time.perf_counter()
        packed = window_from_numpy(W.pack_cnf_window_np(sha_window(size)),
                                   dev)
        windows[size] = packed
        for B in batches:
            K = packed.cvars.shape[0]
            assign = torch.rand((K, B, packed.n_vars + 1), generator=gen,
                                device=dev) < 0.5
            got = true_counts_window(packed.cvars, packed.csign, assign)
            want = true_counts_window_ref(packed.cvars, packed.csign, assign)
            err = int((got - want).abs().max())
            if err:
                raise AssertionError(f"clause_eval window != plain at "
                                     f"{size} B={B}: max err {err}")
            row = {
                "ms": cuda_ms(torch, lambda: true_counts_window(
                    packed.cvars, packed.csign, assign), flush=flush),
                "plain_ms": cuda_ms(torch, lambda: true_counts_window_ref(
                    packed.cvars, packed.csign, assign), reps=REPS,
                    flush=flush),
                "bound": clause_eval_bound_ms(packed.cvars,
                                              packed.n_vars + 1, B),
                "max_abs_err": err,
                "shape": f"sha {size} K={K} C={packed.cvars.shape[1]} "
                         f"L={packed.cvars.shape[2]} V+1={packed.n_vars + 1}"
                         f" O={packed.ovars.shape[2]} B={B}"}
            emit("clause_eval_window", size=size, B=B,
                 seconds_incl_pack=time.perf_counter() - t0,
                 literals=int((packed.cvars > 0).sum()),
                 slots=packed.cvars.numel(), **row)
            if size == "4x4":
                out["clause_eval_window"] = row
                # the K=1 launch on the window's first formula
                c1, s1, a1 = packed.cvars[0], packed.csign[0], assign[0]
                k1_err = int((true_counts(c1, s1, a1)
                              - true_counts_ref(c1, s1, a1)).abs().max())
                if k1_err:
                    raise AssertionError("clause_eval K=1 != plain at 4x4")
                out["clause_eval"] = {
                    "ms": cuda_ms(torch, lambda: true_counts(c1, s1, a1),
                                  flush=flush),
                    "plain_ms": cuda_ms(torch, lambda: true_counts_ref(
                        c1, s1, a1), flush=flush),
                    "bound": clause_eval_bound_ms(c1[None], a1.shape[1], B),
                    "max_abs_err": k1_err,
                    "shape": row["shape"].replace(f"K={K}", "K=1")}
                emit("clause_eval", **out["clause_eval"])
            t0 = time.perf_counter()

    # flip_update: random rows with repeated clause ids
    K, B, V1, C, O = 4, 24, 385, 11264, 136
    fa = torch.rand((K, B, V1), generator=gen, device=dev) < 0.5
    ftc = torch.randint(0, 5, (K, B, C), generator=gen, device=dev,
                        dtype=torch.int32)
    fv = torch.randint(0, V1, (K, B), generator=gen, device=dev,
                       dtype=torch.int32)
    foc = torch.randint(-1, 6, (K, B, O), generator=gen, device=dev,
                        dtype=torch.int32)
    fos = torch.rand((K, B, O), generator=gen, device=dev) < 0.5
    fnv = torch.rand((K, B), generator=gen, device=dev) < 0.5
    wa, wt = flip_update_ref(fa, ftc, fv, foc, fos, fnv)
    ga, gt = flip_update(fa.clone(), ftc.clone(), fv, foc, fos, fnv)
    if not (torch.equal(ga, wa) and torch.equal(gt, wt)):
        raise AssertionError("flip_update != plain on repeated ids")

    # 1000 chained walk steps on the 4x4 window: kernel == plain at every
    # step, and the carried counts equal a fresh recount at the end
    packed = windows["4x4"]
    occ = W.occ_tables(packed.ovars, packed.osign)
    K = packed.cvars.shape[0]
    kk = torch.arange(K, device=dev)[:, None]
    assign = torch.rand((K, 24, packed.n_vars + 1), generator=gen,
                        device=dev) < 0.5
    tc = true_counts_window(packed.cvars, packed.csign, assign)
    err = 0
    steps_args = None
    for _ in range(1000):
        g1 = torch.rand((K, 24, packed.cvars.shape[1]), generator=gen,
                        device=dev)
        g2 = W._gumbel(gen, (K, 24, packed.cvars.shape[2]), dev)
        v, nv = W._pick_flip(packed.cvars, occ, assign, tc, g1, g2, 2.3)
        vl = v.long()
        steps_args = (v, packed.ovars[kk, vl], packed.osign[kk, vl], nv)
        pa, pt = flip_update_ref(assign, tc, *steps_args)
        assign, tc = flip_update(assign, tc, *steps_args)
        err = max(err, int((tc - pt).abs().max()),
                  int((assign != pa).sum()))
    fresh = true_counts_window_ref(packed.cvars, packed.csign, assign)
    if err or not torch.equal(tc, fresh):
        raise AssertionError(f"flip_update chain drifted (max err {err})")
    emit("parity_flip_update", repeated_ids=True, chained_steps=1000,
         recount_equal=True)
    v, occ_c, occ_s, nv = steps_args
    idx = torch.where(occ_c >= 0, occ_c, 0).long()
    delta = torch.where(occ_s == nv[..., None], 1, -1).to(torch.int32) * \
        (occ_c >= 0)
    ta, tt = assign.clone(), tc.clone()
    out["flip_update"] = {
        "ms": cuda_ms(torch, lambda: flip_update(ta, tt, v, occ_c, occ_s,
                                                 nv)),
        "plain_ms": cuda_ms(torch, lambda: flip_update_ref(
            assign, tc, v, occ_c, occ_s, nv)),
        "library_ms": cuda_ms(torch, lambda: tt.scatter_add_(2, idx,
                                                             delta)),
        "bound": flip_update_bound_ms(occ_c),
        "max_abs_err": err,
        "shape": f"sha 4x4 K={K} B=24 O={occ_c.shape[2]} "
                 f"C={packed.cvars.shape[1]}"}
    emit("flip_update", **out["flip_update"])
    return out, windows


def engine_phase(torch, packed_4x4):
    """Device engine == host engine on the 4x4 window; one device segment
    runs with CUDA's sync debug mode set to error, so any host sync in it
    raises."""
    from repro_torch.core.sat import walksat_torch as W
    cnfs = sha_window("4x4")
    t0 = time.perf_counter()
    nm_h, nm_d = {}, {}
    rh = W.solve_walksat_window(cnfs, seed=5, steps=2048, batch=24,
                                engine="host", near_miss=nm_h)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    rd = W.solve_walksat_window(cnfs, seed=5, steps=2048, batch=24,
                                engine="device", near_miss=nm_d)
    t_dev = time.perf_counter() - t0
    if rh != rd or nm_h != nm_d:
        raise AssertionError("device engine != host engine on sha 4x4")
    dev = packed_4x4.cvars.device
    gen = torch.Generator(device=dev).manual_seed(1)
    assign0 = torch.rand((4, 24, packed_4x4.n_vars + 1), generator=gen,
                         device=dev) < 0.5
    occ = W.occ_tables(packed_4x4.ovars, packed_4x4.osign)
    st = W._initial_state(packed_4x4, assign0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    st = W._device_segment(packed_4x4, occ, st, [256, 512], 2.3, gen)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    emit("engines", equal=True, statuses=[s for s, _ in rd],
         host_s=t_host, device_s=t_dev, steps=2048,
         segment_without_sync=True)


def walk_step_phase(torch, packed_4x4, n=16, reps=5):
    """Where a walk step's time goes on the 4x4 window: the host's wall
    time for ``n`` steps (ending in a synchronize) against the device's
    time for the same steps queued behind a sleep kernel, so that the
    device runs them back to back. Their ratio is the device's busy share
    of a step; the rest is the host issuing launches."""
    from repro_torch.core.sat import walksat_torch as W
    dev = packed_4x4.cvars.device
    gen = torch.Generator(device=dev).manual_seed(2)
    occ = W.occ_tables(packed_4x4.ovars, packed_4x4.osign)
    assign = torch.rand((4, 24, packed_4x4.n_vars + 1), generator=gen,
                        device=dev) < 0.5
    tc = W.true_counts_window(packed_4x4.cvars, packed_4x4.csign, assign)
    assign, tc = W._window_chunk(packed_4x4, occ, assign, tc, n, 2.3, gen)
    walls, devs = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        assign, tc = W._window_chunk(packed_4x4, occ, assign, tc, n, 2.3,
                                     gen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        torch.cuda._sleep(400_000_000)
        s.record()
        assign, tc = W._window_chunk(packed_4x4, occ, assign, tc, n, 2.3,
                                     gen)
        e.record()
        torch.cuda.synchronize()
        devs.append(s.elapsed_time(e))
    wall, busy = statistics.median(walls), statistics.median(devs)
    emit("walk_step", steps=n, step_wall_ms=wall / n,
         step_device_ms=busy / n, device_busy_share=busy / wall)


def main_path(torch):
    import repro_torch
    from repro_torch import MapRequest, compile
    from repro_torch.core import suite
    from repro_torch.core.sat import portfolio
    from repro_torch.kernels.clause_eval import true_counts, true_counts_window
    from repro_torch.kernels.flip_update import flip_update
    if repro_torch.get_default_device() != "cuda":
        raise AssertionError("the port must default to cuda")
    counters = (true_counts_window, true_counts, flip_update)
    for f in counters:
        f.launches = 0
    for name in suite.names():
        t0 = time.perf_counter()
        res = compile(MapRequest(dfg=suite.get(name), arch="4x4",
                                 sweep_width=4))
        got = res.ii if res.success else None
        if got != EXPECTED_II_4X4[name] or res.timed_out:
            raise AssertionError(f"{name}: II {got}, expected "
                                 f"{EXPECTED_II_4X4[name]}")
        emit("compile", kernel=name, solver="auto", ii=got, mii=res.mii,
             seconds=time.perf_counter() - t0)
    walk_s = 0.0
    walk_steps = 0
    for name in WALKSAT_KERNELS:
        before = flip_update.launches
        t0 = time.perf_counter()
        res = compile(MapRequest(dfg=suite.get(name), arch="4x4",
                                 sweep_width=4, solver="walksat"))
        secs = time.perf_counter() - t0
        steps = flip_update.launches - before
        win = [a for a in res.attempts if a.ii == res.ii]
        if not res.success or not win or win[0].via != "walksat":
            raise AssertionError(f"{name}: the walk did not map it")
        walk_s += secs
        walk_steps += steps
        emit("compile", kernel=name, solver="walksat", ii=res.ii,
             mii=res.mii, seconds=secs, walk_steps=steps,
             steps_per_s=steps / secs,
             flips_per_s=steps * 4 * 24 / secs)
    launches = {"clause_eval_window": true_counts_window.launches,
                "clause_eval": true_counts.launches,
                "flip_update": flip_update.launches}
    if not (launches["clause_eval_window"] and launches["flip_update"]):
        raise AssertionError(f"main path did not launch its kernels: "
                             f"{launches}")
    if portfolio.racer_failures():
        raise AssertionError(f"{portfolio.racer_failures()} walk racer(s) "
                             f"failed")
    emit("main_path", launches=launches, racer_failures=0,
         walk_seconds=walk_s, walk_steps=walk_steps,
         flips_per_s=walk_steps * 4 * 24 / walk_s)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    import repro_torch                      # fails without the port
    from repro_torch.kernels import _cuda
    torch.cuda.set_device(0)
    environment(torch)
    t0 = time.perf_counter()
    report = _cuda.build(["clause_eval", "flip_update"])
    emit("build", seconds=time.perf_counter() - t0,
         per_source={n: s for n, (s, _) in report.items()},
         ptxas={n: [ln for ln in log.splitlines() if "registers" in ln
                    or "smem" in ln] for n, (_, log) in report.items()})
    times, windows = kernel_phase(torch)
    engine_phase(torch, windows["4x4"])
    walk_step_phase(torch, windows["4x4"])
    del windows
    torch.cuda.empty_cache()
    launches = main_path(torch)

    src = "src/repro_torch/kernels/csrc/"
    kernels = []
    for name, source, replaces in (
            ("clause_eval_window", "clause_eval.cu",
             "src/repro/kernels/clause_eval/kernel.py:69"),
            ("clause_eval", "clause_eval.cu",
             "src/repro/kernels/clause_eval/kernel.py:33"),
            ("flip_update", "flip_update.cu",
             "src/repro/kernels/flip_update/kernel.py:47")):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src + source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t.get("library_ms"),
            "shape": t["shape"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    repro_torch.core.sat.portfolio._reset_pool()
    return 0


if __name__ == "__main__":
    sys.exit(main())
