"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It builds the port's four CUDA sources from ``src/repro_torch/kernels/csrc``
(one nvcc each, in parallel) and drives both of the port's paths.

The mapper: it holds ``clause_eval`` (two routes: each row read up to
its length ``clen``, as the walk calls it, or whole rows), ``flip_update``
and ``walk_chunk`` (the persistent kernel that runs whole probSAT steps of
a chunk; two routes, the counts in shared or in device memory) against
their plain torch versions on the card (bit-exact: the kernels count
integers and the walk's float noise is computed alike), times them (each
``clause_eval`` route beside both of its bounds, and its two launches'
device times), checks the walk's two engines against each other, times a
walk chunk against its host wall time, and then drives
``repro_torch.compile`` on the 11-kernel suite at 4x4 with a sweep width
of 4, with the default solver and with the GPU walk as the solver (one
``walk_chunk`` launch per chunk, every ``clause_eval`` launch on the clen
route).

The LM: it holds ``flash_attention`` (both of its kernels: bf16 on the
tensor cores, f32 on the SIMT kernel) and ``ssd_scan`` (three launches:
chunk states, the pass over them, chunk outputs; each one's device time is
printed) against their plain versions at hymba_1_5b's shapes, and the bf16
attention also at
minitron_8b's (D = 128), and times them beside the library call where
there is one; both attention kernels are also held on small cases at every
D that reach what those shapes do not (tails, q_offset, narrow windows,
non-causal). Then it serves hymba_1_5b at its published widths in bf16
with ``attn_impl="flash"`` (4 prompts of 2048 seeded tokens, prefill into
the ring buffer, 32 greedy decode steps; 32 tensor-core flash launches per
prefill), and holds flash against blockwise prefill on the same weights
and tokens, gated in f32 and reported in bf16.

Every phase prints one JSON line; the line before the last is the
``kernels`` JSON, the last ``{"ok": true, "device": {...}}``. Any failure
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
F32_FLOPS = 67e12                # H100 SXM non-tensor f32 rate
BF16_TENSOR_FLOPS = 989.4e12     # H100 SXM dense bf16 tensor-core rate
REPS = 50
# the LM slice: hymba_1_5b's attention and SSM shapes, and its serving run
ATTN_SHAPE = dict(B=4, Hq=25, Hkv=5, S=2048, D=64)
# minitron_8b's attention (the dense configs all have D = 128), causal
ATTN_SHAPE_D128 = dict(B=4, Hq=32, Hkv=8, S=2048, D=128)
SSD_SHAPE = dict(b=4, s=2048, h=32, p=100, n=16)
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS, AGREE_STEPS = 4, 2048, 32, 8
FLASH_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 3e-2}
# the kernel that flash_attention runs for each dtype
FLASH_ROUTE = {"torch.float32": "simt", "torch.bfloat16": "tensor_core"}
FLASH_NOTE = ("route by dtype: bf16 -> tensor_core (flash_fwd_kernel_wgmma: "
              "TMA ring + wgmma, warp-specialised), the row's shape and "
              "every served prefill launch; f32 -> simt (flash_fwd_kernel, "
              "f32 FMAs)")
SSD_TOL = 2e-3
CLAUSE_NOTE = ("clen route (the walk's): each row's slots [0, clen) are "
               "read; no_clen_ms and bound_no_clen are the full-rows route, "
               "which reads every slot of the padded [K,C,L] table")
# chunks of 177 steps that walk_chunk_phase walks to reach a solved chain
SOLVE_CHUNKS = 200
# keys of a kernel's row that the kernels line carries beside the contract's
KERNEL_EXTRAS = ("note", "steps_per_launch", "ms_per_step",
                 "bound_ms_per_step", "main_path_steps",
                 "main_path_route_launches", "step_wall_ms",
                 "step_device_busy_share", "earlier", "no_clen_ms",
                 "bound_no_clen", "phase_ms")
BF16_UNIT_ROUNDOFF = 2.0 ** -8   # a bf16 output is rounded once


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


def clause_eval_bound_ms(cvars, v1, B, clen=None):
    """Least time for the window's counts: the clause slots read (int32 var
    + sign byte each) and the assignments read once, the counts written
    once, against one compare per (chain, literal) that is not padding.
    With ``clen`` (the clen route) the slots are each row's [0, clen) and
    clen itself is read; without it (the full-rows route) every slot of
    the padded [K,C,L] table."""
    K, C, L = cvars.shape
    table = K * C * L * 5 if clen is None else \
        int(clen.clamp(0, L).sum()) * 5 + K * C * 4
    nbytes = table + K * B * v1 + K * B * C * 4
    ops = int((cvars > 0).sum()) * B
    return max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S) * 1e3, \
        "bytes" if nbytes / HBM_BYTES_PER_S >= ops / INT_OPS_PER_S \
        else "operations"


def device_phases(torch, fn, reps=5):
    """Device time of each kernel that ``fn`` launches once per call, ms
    per launch, from torch.profiler over ``reps`` calls after a warm-up
    (averaged over the launches the trace holds, as a trace may drop
    some); names without their namespace and arguments."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):          # a trace now and then comes back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type != cuda:
                continue
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].replace("void ", "")
            out[name] = us / 1e3 / e.count
        if out:
            return out
    raise AssertionError("torch.profiler recorded no device kernels")


def flip_update_bound_ms(occ_c):
    K, B, O = occ_c.shape
    valid = int((occ_c >= 0).sum())
    # read v_flip, new_val, occ_c, occ_s; write the assignment byte;
    # read + write each touched true count
    nbytes = K * B * (4 + 1 + 1 + 5 * O) + valid * 8
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def walk_chunk_bound_ms(packed, B, steps):
    """Least time for a chunk of ``steps`` walk steps: the pack (int32
    clause table, int32 + bool occurrence lists) read once and the state
    (counts, assignments) read and written once, against K*B*(C + L*O + O)
    integer operations a step (the clause scan, the break counts over
    every literal slot's occurrences, the flip's update)."""
    K, C, L = packed.cvars.shape
    V1, O = packed.ovars.shape[1:]
    nbytes = K * C * L * 4 + K * V1 * O * 5 + 2 * (K * B * C * 4 + K * B * V1)
    ops = steps * K * B * (C + L * O + O)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def kernel_phase(torch):
    """Parity (bit-exact) and times of every kernel at the main path's
    shapes (the 4x4 window, 24 chains) and at the 8x8 window."""
    from repro_torch.convert import window_from_numpy
    from repro_torch.core.sat import walksat_torch as W
    from repro_torch.kernels.clause_eval import (
        true_counts, true_counts_ref, true_counts_window,
        true_counts_window_ref)
    from repro_torch.kernels.flip_update import flip_update, flip_update_ref
    from repro_torch.kernels.flip_update.ref import walk_noise
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    out = {}
    # random tables: zeros anywhere in a row (the full-rows route), and
    # zeros only at or past a random clen (the clen route; some clen past
    # L, which the kernel clamps); L = 7 (a thread a row) and L = 40 (a warp
    # a row), 24 chains and 300 (two chain tiles)
    for K, C, L, V, B in ((3, 5000, 7, 300, 24), (2, 3000, 40, 300, 300)):
        cv = torch.randint(0, V + 1, (K, C, L), generator=gen, device=dev,
                           dtype=torch.int32)
        cs = torch.rand((K, C, L), generator=gen, device=dev) < 0.5
        a = torch.rand((K, B, V + 1), generator=gen, device=dev) < 0.5
        clen = torch.randint(0, L + 3, (K, C), generator=gen, device=dev,
                             dtype=torch.int32)
        cvc = torch.where(torch.arange(L, device=dev) < clen[..., None],
                          cv, 0)
        for what, table, cl in (("full rows", cv, None), ("clen", cvc, clen)):
            if not torch.equal(true_counts_window(table, cs, a, cl),
                               true_counts_window_ref(table, cs, a)):
                raise AssertionError(f"clause_eval window != plain on random "
                                     f"tables ({what}, L={L}, B={B})")
            if not torch.equal(
                    true_counts(table[0], cs[0], a[0],
                                None if cl is None else cl[0]),
                    true_counts_ref(table[0], cs[0], a[0])):
                raise AssertionError(f"clause_eval K=1 != plain on random "
                                     f"tables ({what}, L={L}, B={B})")
    emit("parity_random", clause_eval_window=True, clause_eval=True,
         routes=["full_rows", "clen"], L=[7, 40], B=[24, 300])

    windows = {}
    for size, batches in (("4x4", (24,)), ("8x8", (24, 256))):
        t0 = time.perf_counter()
        packed = window_from_numpy(W.pack_cnf_window_np(sha_window(size)),
                                   dev)
        windows[size] = packed
        cvars, csign, clen = packed.cvars, packed.csign, packed.clen
        K, C, L = cvars.shape
        v1 = packed.n_vars + 1
        for B in batches:
            assign = torch.rand((K, B, v1), generator=gen, device=dev) < 0.5
            want = true_counts_window_ref(cvars, csign, assign)
            err = 0
            for cl in (clen, None):
                got = true_counts_window(cvars, csign, assign, cl)
                err = max(err, int((got - want).abs().max()))
                if err:
                    raise AssertionError(
                        f"clause_eval window != plain at {size} B={B} "
                        f"({'clen' if cl is not None else 'full rows'}): "
                        f"max err {err}")
            del got, want
            row = {
                "ms": cuda_ms(torch, lambda: true_counts_window(
                    cvars, csign, assign, clen), flush=flush),
                "no_clen_ms": cuda_ms(torch, lambda: true_counts_window(
                    cvars, csign, assign), reps=REPS if size == "4x4"
                    else 10, flush=flush),
                "plain_ms": cuda_ms(torch, lambda: true_counts_window_ref(
                    cvars, csign, assign), reps=REPS, flush=flush),
                "library_ms": None,
                "bound": clause_eval_bound_ms(cvars, v1, B, clen),
                "bound_no_clen": clause_eval_bound_ms(cvars, v1, B),
                "phase_ms": {
                    "clen": device_phases(torch, lambda: true_counts_window(
                        cvars, csign, assign, clen)),
                    "full_rows": device_phases(
                        torch, lambda: true_counts_window(
                            cvars, csign, assign), reps=2)},
                "max_abs_err": err,
                "shape": f"sha {size} K={K} C={C} L={L} V+1={v1} "
                         f"O={packed.ovars.shape[2]} B={B}, clen route"}
            emit("clause_eval_window", size=size, B=B,
                 seconds_incl_pack=time.perf_counter() - t0,
                 literals=int((cvars > 0).sum()), slots=cvars.numel(),
                 clen_slots=int(clen.sum()), **row)
            if size == "4x4":
                out["clause_eval_window"] = row
                # the K=1 launch on the window's first formula
                c1, s1, a1, l1 = cvars[0], csign[0], assign[0], clen[0]
                want1 = true_counts_ref(c1, s1, a1)
                k1_err = max(int((true_counts(c1, s1, a1, cl)
                                  - want1).abs().max())
                             for cl in (l1, None))
                if k1_err:
                    raise AssertionError("clause_eval K=1 != plain at 4x4")
                out["clause_eval"] = {
                    "ms": cuda_ms(torch, lambda: true_counts(c1, s1, a1, l1),
                                  flush=flush),
                    "no_clen_ms": cuda_ms(torch, lambda: true_counts(
                        c1, s1, a1), flush=flush),
                    "plain_ms": cuda_ms(torch, lambda: true_counts_ref(
                        c1, s1, a1), flush=flush),
                    "library_ms": None,
                    "bound": clause_eval_bound_ms(c1[None], v1, B, l1[None]),
                    "bound_no_clen": clause_eval_bound_ms(c1[None], v1, B),
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
    for step in range(1000):
        g1, g2 = walk_noise(W.walk_key(0), step, tc, packed.cvars.shape[2])
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


def _walk_parity(torch, packed, assign, tc, key, step0, n, what):
    """walk_chunk (kernel, in place on copies) == walk_chunk_ref on the
    same state, bit for bit; the carried counts equal a fresh recount.
    Returns the kernel's (assign, tc)."""
    from repro_torch.kernels.clause_eval import true_counts_window_ref
    from repro_torch.kernels.flip_update import walk_chunk, walk_chunk_ref
    args = (packed.cvars, packed.ovars, packed.osign)
    want = walk_chunk_ref(*args, assign, tc, key, step0, n, 2.3)
    got = walk_chunk(*args, assign.clone(), tc.clone(), key, step0, n, 2.3)
    torch.cuda.synchronize()
    bad_a = int((got[0] != want[0]).sum())
    bad_t = int((got[1] != want[1]).sum())
    fresh = true_counts_window_ref(packed.cvars, packed.csign, got[0])
    if bad_a or bad_t or not torch.equal(got[1], fresh):
        raise AssertionError(f"walk_chunk != walk_chunk_ref ({what}, {n} "
                             f"steps): {bad_a} assignment bytes, {bad_t} "
                             f"counts differ; recount equal "
                             f"{torch.equal(got[1], fresh)}")
    return got


def walk_chunk_phase(torch, windows):
    """walk_chunk against walk_chunk_ref on the card, bit for bit: chunks
    of 1, 7 and 177 steps at the 4x4 window (shared route; 177 is the
    main path's chunk there), 8 steps at the 8x8 window with 24 chains
    (global route), and 9 steps on a 4x4 state where a chain is solved.
    Then the kernel's time per chunk and per step beside the bound, the
    plain version's time, and the 8x8 times at 24 and 256 chains."""
    from repro_torch.core.sat import walksat_torch as W
    from repro_torch.kernels.clause_eval import true_counts_window
    from repro_torch.kernels.flip_update import (walk_chunk, walk_chunk_ref,
                                                 walk_route)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    key = W.walk_key(6)
    packed = windows["4x4"]
    K, C, L = packed.cvars.shape
    V1 = packed.n_vars + 1
    B = 24
    before = dict(walk_chunk.route_launches)
    assign = torch.rand((K, B, V1), generator=gen, device=dev) < 0.5
    tc = true_counts_window(packed.cvars, packed.csign, assign)
    step = 0
    for n in (1, 7, 177):
        assign, tc = _walk_parity(torch, packed, assign, tc, key, step, n,
                                  "4x4")
        step += n
    # walk on until a chain is solved, then hold the kernel there
    for _ in range(SOLVE_CHUNKS):
        if bool((~(tc == 0).any(-1)).any()):
            break
        assign, tc = walk_chunk(packed.cvars, packed.ovars, packed.osign,
                                assign, tc, key, step, 177, 2.3)
        step += 177
    solved = (~(tc == 0).any(-1))
    n_solved = int(solved.sum())
    if not n_solved:
        raise AssertionError(f"no chain of the 4x4 window solved in "
                             f"{SOLVE_CHUNKS} chunks")
    got = _walk_parity(torch, packed, assign, tc, key, step, 9,
                       "4x4, solved chains")
    want0 = assign.clone()
    want0[..., 0] ^= True                      # 9 steps: an odd count
    if not (torch.equal(got[1][solved], tc[solved])
            and torch.equal(got[0][solved], want0[solved])):
        raise AssertionError("a solved chain changed more than its dummy "
                             "variable")
    p8 = windows["8x8"]
    K8, C8, L8 = p8.cvars.shape
    a8 = torch.rand((K8, B, p8.n_vars + 1), generator=gen, device=dev) < 0.5
    t8 = true_counts_window(p8.cvars, p8.csign, a8)
    _walk_parity(torch, p8, a8, t8, key, 0, 8, "8x8")
    routes = {r: n - before[r] for r, n in walk_chunk.route_launches.items()}
    if walk_route(C, L, V1) != "shared" or \
            walk_route(C8, L8, p8.n_vars + 1) != "global" or \
            routes["global"] != 1 or not routes["shared"]:
        raise AssertionError(f"walk_chunk routes {routes}; expected the 4x4 "
                             f"window shared, the 8x8 global")
    emit("parity_walk_chunk", chunks_4x4=[1, 7, 177, 9], chunk_8x8=8,
         solved_chains=n_solved, route_launches=routes, bit_identical=True)

    # times: a 177-step chunk from a walked 4x4 state, restored before
    # each launch (outside the events)
    a0 = torch.rand((K, B, V1), generator=gen, device=dev) < 0.5
    t0 = true_counts_window(packed.cvars, packed.csign, a0)
    a0, t0 = walk_chunk(packed.cvars, packed.ovars, packed.osign, a0, t0,
                        key, 0, 354, 2.3)
    n = 177
    ta, tt = a0.clone(), t0.clone()

    def restore():
        ta.copy_(a0)
        tt.copy_(t0)
    ms = cuda_ms(torch, lambda: walk_chunk(
        packed.cvars, packed.ovars, packed.osign, ta, tt, key, 354, n, 2.3),
        flush=restore)
    plain_ms = cuda_ms(torch, lambda: walk_chunk_ref(
        packed.cvars, packed.ovars, packed.osign, a0, t0, key, 354, n, 2.3),
        reps=3)
    bound = walk_chunk_bound_ms(packed, B, n)
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "bound": bound, "max_abs_err": 0, "steps_per_launch": n,
           "ms_per_step": ms / n, "bound_ms_per_step": bound[0] / n,
           "plain_ms_per_step": plain_ms / n,
           "shape": f"sha 4x4 K={K} C={C} L={L} V+1={V1} "
                    f"O={packed.ovars.shape[2]} B={B}, {n} steps, route "
                    f"shared"}
    emit("walk_chunk", **row)
    for b8 in (24, 256):
        a8 = torch.rand((K8, b8, p8.n_vars + 1), generator=gen,
                        device=dev) < 0.5
        t8 = true_counts_window(p8.cvars, p8.csign, a8)
        a80, t80 = a8.clone(), t8.clone()

        def restore8():
            a8.copy_(a80)
            t8.copy_(t80)
        ms8 = cuda_ms(torch, lambda: walk_chunk(
            p8.cvars, p8.ovars, p8.osign, a8, t8, key, 0, 8, 2.3), reps=10,
            flush=restore8)
        b = walk_chunk_bound_ms(p8, b8, 8)
        emit("walk_chunk", ms=ms8, ms_per_step=ms8 / 8, bound=b,
             bound_ms_per_step=b[0] / 8, route="global",
             shape=f"sha 8x8 K={K8} C={C8} L={L8} V+1={p8.n_vars + 1} "
                   f"O={p8.ovars.shape[2]} B={b8}, 8 steps from random "
                   f"assignments")
        del a8, t8, a80, t80
    return row


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
    st = W._initial_state(packed_4x4, assign0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    st = W._device_segment(packed_4x4, st, [177, 177, 177, 177], 0, 2.3,
                           W.walk_key(1))
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    emit("engines", equal=True, statuses=[s for s, _ in rd],
         host_s=t_host, device_s=t_dev, steps=2048,
         segment_without_sync=True)


def walk_step_phase(torch, packed_4x4, reps=5):
    """Where a walk step's time goes on the 4x4 window: the host's wall
    time for a chunk of ``n`` steps (one walk_chunk launch, ending in a
    synchronize) against the device's time for the same chunk queued
    behind a sleep kernel. Their ratio is the device's busy share of a
    step; the rest is the host issuing the launch and waiting on it. At
    n = 16 and at the main path's 177."""
    from repro_torch.core.sat import walksat_torch as W
    dev = packed_4x4.cvars.device
    gen = torch.Generator(device=dev).manual_seed(2)
    key = W.walk_key(2)
    assign = torch.rand((4, 24, packed_4x4.n_vars + 1), generator=gen,
                        device=dev) < 0.5
    tc = W.true_counts_window(packed_4x4.cvars, packed_4x4.csign, assign)
    step = 0
    assign, tc = W._window_chunk(packed_4x4, assign, tc, 177, 2.3, key, step)
    step += 177
    out = {}
    for n in (16, 177):
        walls, devs = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            assign, tc = W._window_chunk(packed_4x4, assign, tc, n, 2.3, key,
                                         step)
            step += n
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            torch.cuda._sleep(400_000_000)
            s.record()
            assign, tc = W._window_chunk(packed_4x4, assign, tc, n, 2.3, key,
                                         step)
            step += n
            e.record()
            torch.cuda.synchronize()
            devs.append(s.elapsed_time(e))
        wall, busy = statistics.median(walls), statistics.median(devs)
        out[n] = {"step_wall_ms": wall / n, "step_device_ms": busy / n,
                  "device_busy_share": busy / wall}
        emit("walk_step", steps=n, **out[n])
    return out


def main_path(torch):
    import repro_torch
    from repro_torch import MapRequest, compile
    from repro_torch.core import suite
    from repro_torch.core.sat import portfolio
    from repro_torch.kernels import clause_eval
    from repro_torch.kernels.clause_eval import true_counts, true_counts_window
    from repro_torch.kernels.flip_update import (flip_update, reset_counts,
                                                 walk_chunk)
    if repro_torch.get_default_device() != "cuda":
        raise AssertionError("the port must default to cuda")
    clause_eval.reset_counts()
    reset_counts()
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
        before = walk_chunk.steps
        t0 = time.perf_counter()
        res = compile(MapRequest(dfg=suite.get(name), arch="4x4",
                                 sweep_width=4, solver="walksat"))
        secs = time.perf_counter() - t0
        steps = walk_chunk.steps - before
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
                "flip_update": flip_update.launches,
                "walk_chunk": walk_chunk.launches}
    if not (launches["clause_eval_window"] and launches["walk_chunk"]):
        raise AssertionError(f"main path did not launch its kernels: "
                             f"{launches}")
    ce_routes = dict(true_counts_window.route_launches)
    if ce_routes["full_rows"]:
        raise AssertionError(f"the walk evaluated its windows without their "
                             f"row lengths: {ce_routes}")
    if portfolio.racer_failures():
        raise AssertionError(f"{portfolio.racer_failures()} walk racer(s) "
                             f"failed")
    emit("main_path", launches=launches, racer_failures=0,
         clause_eval_window_route_launches=ce_routes,
         walk_chunk_route_launches=walk_chunk.route_launches,
         walk_chunk_steps=walk_chunk.steps,
         walk_seconds=walk_s, walk_steps=walk_steps,
         steps_per_s=walk_steps / walk_s,
         flips_per_s=walk_steps * 4 * 24 / walk_s)
    return launches, {"steps": walk_chunk.steps,
                      "route_launches": dict(walk_chunk.route_launches),
                      "clause_eval_route_launches": ce_routes}


def _close(got, want, atol, rtol):
    """(max abs error, whether every element is within atol + rtol|want|)
    of ``got`` against ``want``, in f32."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return float(err.max()), bool((err <= atol + rtol * want.abs()).all())


def flash_bound_ms(B, Hq, Hkv, S, D, window, itemsize, flops_per_s):
    """Least time for one prefill attention call: q, k, v read once and o
    written once, against 4*D flops for every visible (q, k) pair (QK^T
    and PV; causal, and inside the window when there is one)."""
    q = list(range(S))
    pairs = sum(min(i + 1, window) if window else i + 1 for i in q)
    flops = pairs * 4 * D * B * Hq
    nbytes = (2 * B * Hq * S * D + 2 * B * Hkv * S * D) * itemsize
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def ssd_bound_ms(b, s, h, p, n, chunk, x_itemsize, bc_itemsize, flops_per_s):
    """Least time for one scan: x, dt, B, C (and A_log, D) read once, y
    written once, against the chunked form's products: C.B^T and the
    decay-weighted product with x over the causal half of each chunk, and
    the two [l,p,n] state products per chunk."""
    nc = -(-s // chunk)
    tri = chunk * (chunk + 1) // 2
    flops = b * h * nc * (2 * tri * (n + p) + 4 * chunk * n * p)
    nbytes = (2 * b * s * h * p * x_itemsize + b * s * h * 4
              + 2 * b * s * n * bc_itemsize + 2 * h * 4)
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def _check_route(flash_attention, before, route):
    """Every flash launch since ``before`` (a copy of the per-route counts)
    went to ``route``, and there was at least one."""
    delta = {r: n - before[r]
             for r, n in flash_attention.route_launches.items()}
    if not delta[route] or sum(delta.values()) != delta[route]:
        raise AssertionError(f"flash_attention launches by route {delta}; "
                             f"expected all on {route}")


# small bf16 and f32 cases that reach the branches the served shapes do
# not: D 16/32 (32- and 64-byte swizzles), Sq and Sk off the 128-row tile
# (zero-filled TMA rows and the kpos < Sk mask), q_offset > 0, non-causal,
# and windows narrow enough that an off-by-one in the mask moves an output
# by more than the tolerance. (B, Hq, Hkv, Sq, Sk, causal, window,
# q_offset), each at every D.
FLASH_EDGE_CASES = [
    (2, 4, 2, 77, 141, True, 0, 64),
    (2, 4, 2, 77, 141, False, 0, 0),
    (1, 4, 1, 300, 300, True, 8, 0),
    (1, 4, 1, 300, 300, True, 70, 0),
    (1, 4, 1, 300, 300, True, 100, 0),
    (1, 4, 2, 33, 500, True, 0, 467),
    (1, 4, 2, 33, 500, True, 100, 467),
    (1, 2, 1, 200, 200, False, 70, 0),
]


def flash_edge_phase(torch):
    """flash_attention against attention_ref on ``FLASH_EDGE_CASES`` at
    D 16/32/64/128, in bf16 (tensor-core route) and f32 (SIMT route), as
    swapped [B,S,H,D] views and as contiguous tensors; every launch is
    checked to have taken its dtype's route."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol = FLASH_TOL[str(dtype)]
        before = dict(flash_attention.route_launches)
        n = 0
        for D in (16, 32, 64, 128):
            for i, (B, Hq, Hkv, Sq, Sk, causal, window, q_offset) in \
                    enumerate(FLASH_EDGE_CASES):
                swapped = i % 2 == 0
                q, k, v = (
                    torch.randn((B, s, h, D), generator=gen, device=dev)
                    .to(dtype).transpose(1, 2) if swapped else
                    torch.randn((B, h, s, D), generator=gen, device=dev)
                    .to(dtype) for h, s in ((Hq, Sq), (Hkv, Sk), (Hkv, Sk)))
                got = flash_attention(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset)
                want = attention_ref(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
                err, ok = _close(got, want, tol, tol)
                if not ok or not torch.isfinite(got).all():
                    raise AssertionError(
                        f"flash_attention {dtype} D={D} q [{B},{Hq},{Sq}] "
                        f"k/v [{B},{Hkv},{Sk}] causal={causal} window="
                        f"{window} q_offset={q_offset} swapped={swapped}: "
                        f"max abs err {err} beyond atol=rtol={tol}")
                worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
                n += 1
        torch.cuda.synchronize()
        _check_route(flash_attention, before, FLASH_ROUTE[str(dtype)])
    emit("flash_attention_edges", cases_per_dtype=n,
         max_abs_err=worst, tolerance=FLASH_TOL,
         route_launches=flash_attention.route_launches)


def lm_kernel_phase(torch):
    """flash_attention and ssd_scan against their plain versions at
    hymba_1_5b's shapes (and bf16 attention at minitron_8b's D = 128),
    with their times, bounds and (for attention) the library call's time.
    Returns the kernels-line entries, which hold the shapes the served
    model gives them: bf16 with the 1024 window for attention, bf16 x/B/C
    at the config's chunk of 256 for the scan."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention,
                                                     reset_counts)
    from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
    from repro_torch.models.layers import ssd_chunked
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    B, Hq, Hkv, S, D = (ATTN_SHAPE[k] for k in ("B", "Hq", "Hkv", "S", "D"))
    reset_counts()
    for dtype in (torch.bfloat16, torch.float32):
        tol = FLASH_TOL[str(dtype)]
        before = dict(flash_attention.route_launches)
        # the model's layout: [B,S,H,D] activations seen as [B,H,S,D] views
        q, k, v = (torch.randn((B, S, h, D), generator=gen, device=dev)
                   .to(dtype).transpose(1, 2) for h in (Hq, Hkv, Hkv))
        for window in (1024, 0):
            got = flash_attention(q, k, v, causal=True, window=window)
            want = attention_ref(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            err, ok = _close(got, want, tol, tol)
            if not ok or not torch.isfinite(got).all():
                raise AssertionError(f"flash_attention {dtype} window "
                                     f"{window}: max abs err {err} beyond "
                                     f"atol=rtol={tol}")
            pos = torch.arange(S, device=dev)
            mask = pos[None, :] <= pos[:, None]
            if window:
                mask &= pos[None, :] > pos[:, None] - window

            def lib():
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True)
            lib_err, _ = _close(lib(), want, tol, tol)
            row = {
                "ms": cuda_ms(torch, lambda: flash_attention(
                    q, k, v, causal=True, window=window)),
                "plain_ms": cuda_ms(torch, lambda: attention_ref(
                    q, k, v, causal=True, window=window), reps=10),
                "library_ms": cuda_ms(torch, lib),
                "bound": flash_bound_ms(
                    B, Hq, Hkv, S, D, window, q.element_size(),
                    BF16_TENSOR_FLOPS if dtype == torch.bfloat16
                    else F32_FLOPS),
                "max_abs_err": err, "library_max_abs_err": lib_err,
                "shape": f"q [{B},{Hq},{S},{D}] k/v [{B},{Hkv},{S},{D}] "
                         f"{str(dtype)[6:]} window {window} causal, "
                         f"swapped [B,S,H,D] views"}
            if not window:
                # SDPA's own causal path, which needs no mask tensor
                row["library_causal_ms"] = cuda_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True))
            emit("flash_attention", tolerance=tol, **row)
            if dtype == torch.bfloat16 and window == 1024:
                out["flash_attention"] = row
            del got, want
        _check_route(flash_attention, before, FLASH_ROUTE[str(dtype)])
    # minitron_8b's attention in bf16: D = 128, causal, no window; the
    # library call is SDPA's own causal path
    B, Hq, Hkv, S, D = (ATTN_SHAPE_D128[k]
                        for k in ("B", "Hq", "Hkv", "S", "D"))
    tol = FLASH_TOL["torch.bfloat16"]
    q, k, v = (torch.randn((B, S, h, D), generator=gen, device=dev)
               .to(torch.bfloat16).transpose(1, 2) for h in (Hq, Hkv, Hkv))
    got = flash_attention(q, k, v, causal=True)
    want = attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err, ok = _close(got, want, tol, tol)
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"flash_attention bf16 D=128: max abs err {err} "
                             f"beyond atol=rtol={tol}")
    del got

    def lib_causal():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    lib_err, _ = _close(lib_causal(), want, tol, tol)
    del want
    before = dict(flash_attention.route_launches)
    emit("flash_attention", tolerance=tol, arch="minitron_8b",
         ms=cuda_ms(torch, lambda: flash_attention(q, k, v, causal=True)),
         plain_ms=cuda_ms(torch, lambda: attention_ref(q, k, v, causal=True),
                          reps=10),
         library_ms=cuda_ms(torch, lib_causal),
         bound=flash_bound_ms(B, Hq, Hkv, S, D, 0, q.element_size(),
                              BF16_TENSOR_FLOPS),
         max_abs_err=err, library_max_abs_err=lib_err,
         shape=f"q [{B},{Hq},{S},{D}] k/v [{B},{Hkv},{S},{D}] bfloat16 "
               f"window 0 causal, swapped [B,S,H,D] views",
         library="scaled_dot_product_attention(is_causal=True)")
    del q, k, v
    _check_route(flash_attention, before, "tensor_core")
    emit("flash_routes", route_launches=flash_attention.route_launches,
         layout_copies=flash_attention.layout_copies)
    b, s, h, p, n = (SSD_SHAPE[k] for k in ("b", "s", "h", "p", "n"))
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
        dt = torch.rand((b, s, h), generator=gen, device=dev) * 0.5
        A_log = torch.rand((h,), generator=gen, device=dev)
        Bm, Cm = (torch.randn((b, s, n), generator=gen, device=dev).to(dtype)
                  for _ in range(2))
        Dv = torch.rand((h,), generator=gen, device=dev)
        want = ssd_ref(x, dt, A_log, Bm, Cm, Dv)
        # the f32 algorithms agree to 2e-3; a bf16 y is also rounded once
        # (twice between two bf16 results)
        rtol = SSD_TOL + (BF16_UNIT_ROUNDOFF if dtype == torch.bfloat16
                          else 0.0)
        for chunk in (128, 256):
            got = ssd_scan(x, dt, A_log, Bm, Cm, Dv, chunk=chunk)
            torch.cuda.synchronize()
            err, ok = _close(got, want, SSD_TOL, rtol)
            if not ok or not torch.isfinite(got).all():
                raise AssertionError(f"ssd_scan {dtype} chunk {chunk}: max "
                                     f"abs err {err} beyond atol={SSD_TOL} "
                                     f"rtol={rtol} against ssd_ref")
            chunked = ssd_chunked(x, dt, A_log, Bm, Cm, Dv, chunk)
            c_err, c_ok = _close(got, chunked, SSD_TOL,
                                 rtol + (BF16_UNIT_ROUNDOFF
                                         if dtype == torch.bfloat16 else 0))
            if not c_ok:
                raise AssertionError(f"ssd_scan {dtype} chunk {chunk}: max "
                                     f"abs err {c_err} against ssd_chunked")
            row = {
                "ms": cuda_ms(torch, lambda: ssd_scan(
                    x, dt, A_log, Bm, Cm, Dv, chunk=chunk)),
                "plain_ms": cuda_ms(torch, lambda: ssd_ref(
                    x, dt, A_log, Bm, Cm, Dv), reps=3),
                "chunked_ms": cuda_ms(torch, lambda: ssd_chunked(
                    x, dt, A_log, Bm, Cm, Dv, chunk), reps=10),
                "library_ms": None,
                "bound": ssd_bound_ms(
                    b, s, h, p, n, chunk, x.element_size(),
                    Bm.element_size(),
                    BF16_TENSOR_FLOPS if dtype == torch.bfloat16
                    else F32_FLOPS),
                "phase_ms": device_phases(torch, lambda: ssd_scan(
                    x, dt, A_log, Bm, Cm, Dv, chunk=chunk)),
                "max_abs_err": err, "chunked_max_abs_err": c_err,
                "max_abs_y": float(want.abs().max()),
                "shape": f"x [{b},{s},{h},{p}] B/C [{b},{s},{n}] "
                         f"{str(dtype)[6:]} x/B/C, dt f32, chunk {chunk}",
                "note": "no model call site (ssm_layer uses ssd_chunked, "
                        "as in the reference); driven through its entry "
                        "point at hymba_1_5b's SSM shapes"}
            emit("ssd_scan", atol=SSD_TOL, rtol=rtol, **row)
            if dtype == torch.bfloat16 and chunk == 256:
                out["ssd_scan"] = row
            del got, chunked
        del want
    return out


def _counters():
    from repro_torch.kernels.clause_eval import true_counts, true_counts_window
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flip_update import flip_update, walk_chunk
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"clause_eval_window": true_counts_window,
            "clause_eval": true_counts, "flip_update": flip_update,
            "walk_chunk": walk_chunk, "flash_attention": flash_attention,
            "ssd_scan": ssd_scan}


def serve_phase(torch):
    """The LM main path: hymba_1_5b at its published widths in bf16 with
    attn_impl="flash", weights from LM.init (seeded), 4 prompts of 2048
    seeded tokens prefilled into the ring buffer (min(2048, 1024) slots),
    then 32 greedy decode steps. Returns the launch counts of this run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import reset_counts
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models.model import LM
    dev = torch.device("cuda", 0)
    cfg = get_config("hymba_1_5b").replace(attn_impl="flash")
    t0 = time.perf_counter()
    lm = LM(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in lm.parameters())
    gen = torch.Generator(device=dev).manual_seed(1)
    serve_lm(lm, torch.randint(0, cfg.vocab, (1, 256), generator=gen,
                               device=dev), 2)             # warm-up
    prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    for f in counters.values():
        f.launches = 0
    reset_counts()
    res = serve_lm(lm, prompts, SERVE_STEPS)
    launches = {name: f.launches for name, f in counters.items()}
    flash = counters["flash_attention"]
    routes = dict(flash.route_launches)
    if launches["flash_attention"] != cfg.n_layers or \
            routes["tensor_core"] != cfg.n_layers:
        raise AssertionError(f"prefill launched flash_attention "
                             f"{launches['flash_attention']} times ({routes}),"
                             f" expected one per layer ({cfg.n_layers}), all "
                             f"on the tensor cores")
    if flash.layout_copies:
        raise AssertionError(f"the served prefill copied "
                             f"{flash.layout_copies} operands before flash")
    finite = all(bool(torch.isfinite(lg).all()) for lg in res.logits)
    if not finite or res.tokens.shape != (SERVE_BATCH, SERVE_STEPS):
        raise AssertionError("serve: non-finite logits or wrong token shape")
    emit("serve", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab, dtype=cfg.dtype, attn_impl=cfg.attn_impl,
         requests=SERVE_BATCH, prompt_len=SERVE_PROMPT,
         ring_window=min(SERVE_PROMPT, cfg.attn_window),
         decode_steps=SERVE_STEPS, param_bytes=param_bytes,
         init_s=init_s,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         prefill_s=res.prefill_s,
         prefill_tokens_per_s=SERVE_BATCH * SERVE_PROMPT / res.prefill_s,
         decode_s=res.decode_s,
         decode_tokens_per_s=SERVE_BATCH * SERVE_STEPS / res.decode_s,
         launches=launches, flash_route_launches=routes,
         flash_layout_copies=flash.layout_copies, logits_finite=finite,
         first_tokens=res.tokens[:, :8].tolist())
    serve_profile(torch, lm, prompts)
    return {"flash_attention": launches["flash_attention"],
            "ssd_scan": launches["ssd_scan"]}


def _profile(torch, fn, match):
    """Device time of ``fn`` from torch.profiler: the kernels' total time
    and launch count, the time of the kernels whose name holds ``match``,
    and the operators that launched the most device time (self time of
    the kernels each launched directly)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if v is None else v
    rows = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in rows if e.device_type == cuda]
    ops = sorted((e for e in rows if e.device_type != cuda and dev_us(e)),
                 key=dev_us, reverse=True)
    if not kernels:
        raise AssertionError("torch.profiler recorded no device kernels")
    return {"device_ms": sum(dev_us(e) for e in kernels) / 1e3,
            f"{match}_ms": sum(dev_us(e) for e in kernels
                               if match in e.key) / 1e3,
            "kernel_launches": sum(e.count for e in kernels),
            "top_ops": [[e.key, dev_us(e) / 1e3, e.count] for e in ops[:10]],
            "top_kernels": [[e.key[:90], dev_us(e) / 1e3, e.count]
                            for e in sorted(kernels, key=dev_us,
                                            reverse=True)[:6]]}


def serve_profile(torch, lm, prompts, reps=3):
    """Where the served model's time goes: one prefill and one decode step
    of the serve run's shapes under torch.profiler (device time, launches,
    top operators), beside their wall times without the profiler; a
    busy share is device time over wall time. (Holding the stream with a
    sleep kernel, as the walk_step phase does, cannot time a decode step:
    its thousands of launches fill the launch queue, and the host then
    waits behind the sleep.)"""
    _, cache = lm.prefill_with_cache(prompts)
    tok = prompts[:, -1:]
    t = prompts.shape[1]
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.decode_step(cache, tok, t)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        t += 1
    decode = _profile(torch, lambda: lm.decode_step(cache, tok, t),
                      "flash_fwd_kernel")
    walls_p = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.prefill_with_cache(prompts)
        torch.cuda.synchronize()
        walls_p.append((time.perf_counter() - t0) * 1e3)
    prefill = _profile(torch, lambda: lm.prefill_with_cache(prompts),
                       "flash_fwd_kernel")
    flash_ms = prefill["flash_fwd_kernel_ms"]
    wall_d, wall_p = statistics.median(walls), min(walls_p)
    emit("serve_profile", batch=prompts.shape[0],
         prompt_len=prompts.shape[1],
         decode_step_wall_ms=wall_d,
         decode_device_busy_share=decode["device_ms"] / wall_d,
         decode=decode, prefill_wall_ms=wall_p,
         prefill_device_busy_share=prefill["device_ms"] / wall_p,
         prefill_flash_ms=flash_ms,
         prefill_flash_share=flash_ms / prefill["device_ms"],
         prefill=prefill)


def serve_agreement_phase(torch, dtype):
    """hymba_1_5b at its published widths in ``dtype``, prefill through the
    flash kernel and through the blockwise path (the reference's default),
    on the same weights, prompts and fed tokens, compared over the
    prefill's last logits and 8 decode steps' logits. In f32 (the SIMT
    kernel) they must agree to 1e-3 of the largest logit; in bf16 (the
    tensor-core kernel; both paths round their activations to bf16 at
    other places, layer after layer) the difference and whether the greedy
    tokens agree are reported, and the logits must be finite."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     reset_counts)
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models.model import LM
    dev = torch.device("cuda", 0)
    base = get_config("hymba_1_5b").replace(dtype=dtype)
    route = FLASH_ROUTE[f"torch.{dtype}"]
    lm = LM(base.replace(attn_impl="flash"), dev).init(
        torch.Generator(device=dev).manual_seed(0))
    prompts = torch.randint(0, base.vocab, (SERVE_BATCH, SERVE_PROMPT),
                            generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev)
    reset_counts()
    res_f = serve_lm(lm, prompts, AGREE_STEPS)
    flash_launches = flash_attention.launches
    routes = dict(flash_attention.route_launches)
    lm_b = LM(base.replace(attn_impl="blockwise"), dev)
    lm_b.load_state_dict(lm.state_dict())
    del lm
    res_b = serve_lm(lm_b, prompts, AGREE_STEPS, feed=res_f.fed)
    if flash_launches != base.n_layers or routes[route] != base.n_layers or \
            flash_attention.launches != flash_launches:
        raise AssertionError(f"agreement runs launched flash_attention "
                             f"{flash_launches} ({routes}) then "
                             f"{flash_attention.launches - flash_launches} "
                             f"times; expected {base.n_layers} on {route} "
                             f"then 0")
    if not all(bool(torch.isfinite(lg).all())
               for lg in res_f.logits + res_b.logits):
        raise AssertionError(f"agreement run ({dtype}): non-finite logits")
    largest = max(float(lg.abs().max()) for lg in res_f.logits)
    diffs = [float((a - b).abs().max())
             for a, b in zip(res_f.logits, res_b.logits)]
    if dtype == "float32" and max(diffs) > 1e-3 * largest:
        raise AssertionError(f"flash vs blockwise logits differ by "
                             f"{max(diffs)} > 1e-3 x {largest}")
    emit("serve_agreement", dtype=dtype, flash_route=route,
         gated=dtype == "float32", steps=AGREE_STEPS,
         largest_logit=largest, max_abs_diff_per_step=diffs,
         max_rel_diff=max(diffs) / largest,
         same_greedy_tokens=bool(torch.equal(res_f.tokens, res_b.tokens)),
         greedy_tokens_equal_share=float(
             (res_f.tokens == res_b.tokens).float().mean()),
         flash_prefill_s=res_f.prefill_s, blockwise_prefill_s=res_b.prefill_s)


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
    # f32 products in full f32 (no TF32), for the kernels' plain versions
    # and the f32 agreement run alike
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    environment(torch)
    t0 = time.perf_counter()
    report = _cuda.build(["clause_eval", "flip_update", "flash_attention",
                          "ssd_scan"])
    emit("build", seconds=time.perf_counter() - t0,
         per_source={n: s for n, (s, _) in report.items()},
         ptxas={n: [ln for ln in log.splitlines() if "registers" in ln
                    or "smem" in ln] for n, (_, log) in report.items()})
    times, windows = kernel_phase(torch)
    times["walk_chunk"] = walk_chunk_phase(torch, windows)
    engine_phase(torch, windows["4x4"])
    step = walk_step_phase(torch, windows["4x4"])
    del windows
    torch.cuda.empty_cache()
    launches, walk = main_path(torch)
    times["clause_eval_window"]["main_path_route_launches"] = \
        walk["clause_eval_route_launches"]
    times["walk_chunk"].update(
        main_path_steps=walk["steps"],
        main_path_route_launches=walk["route_launches"],
        step_wall_ms=step[177]["step_wall_ms"],
        step_device_busy_share=step[177]["device_busy_share"],
        earlier={"design": "flip_update: one launch per walk step, beside "
                           "~30 torch launches for the pick",
                 "ms_per_step": times["flip_update"]["ms"]})
    torch.cuda.empty_cache()
    lm_times = lm_kernel_phase(torch)
    flash_edge_phase(torch)
    torch.cuda.empty_cache()
    launches.update(serve_phase(torch))
    torch.cuda.empty_cache()
    serve_agreement_phase(torch, "float32")
    torch.cuda.empty_cache()
    serve_agreement_phase(torch, "bfloat16")
    times.update(lm_times)

    src = "src/repro_torch/kernels/csrc/"
    kernels = []
    for name, source, replaces in (
            ("clause_eval_window", "clause_eval.cu",
             "src/repro/kernels/clause_eval/kernel.py:69"),
            ("clause_eval", "clause_eval.cu",
             "src/repro/kernels/clause_eval/kernel.py:33"),
            ("flip_update", "flip_update.cu",
             "src/repro/kernels/flip_update/kernel.py:47"),
            ("walk_chunk", "flip_update.cu",
             "src/repro/kernels/flip_update/kernel.py:47"),
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:77"),
            ("ssd_scan", "ssd_scan.cu",
             "src/repro/kernels/ssd_scan/kernel.py:61")):
        t = times[name]
        if name == "flash_attention":
            t["note"] = FLASH_NOTE
        if name.startswith("clause_eval"):
            t["note"] = CLAUSE_NOTE
        kernels.append({
            "name": name, "route": "cuda", "source": src + source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t.get("library_ms"),
            "shape": t["shape"],
            **{k: v for k, v in t.items() if k in KERNEL_EXTRAS}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    repro_torch.core.sat.portfolio._reset_pool()
    return 0


if __name__ == "__main__":
    sys.exit(main())
