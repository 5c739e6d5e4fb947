"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --host-mesh    # the host world alone

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

Then the mapping campaign (``campaign_phase``, after the service tier):
``repro_torch.launch.campaign`` at its ``--quick`` corpus with its gates
(``CAMPAIGN_QUICK``: shards spawned on cuda whose cells the default
solver maps on the host, z3 where it imports, else CDCL;
the guide trained on cuda:0; the 33-cell guided == unguided suite gate),
the guide's training timed on the card, both walk kernels held against
their plain versions on every window the guided walks receive, and sha,
gsm and nw at 4x4 walked with the trained guide choosing windows of 1..8
IIs (``clause_eval`` and ``walk_chunk`` launches counted per K) and with
an unresolvable guide name (unguided).

The LM: it holds ``flash_attention`` (both of its kernels: bf16 on the
tensor cores, f32 on the SIMT kernel) and ``ssd_scan`` (three launches:
chunk states, the pass over them, chunk outputs; each one's device time is
printed; y and the final state held to ``ssd_chunked`` too, also at the
benchmark's 96-row served prefill) against their plain versions at
hymba_1_5b's shapes, and the bf16 attention also at
minitron_8b's (D = 128), and times them beside the library call where
there is one; both attention kernels are also held on small cases at every
D that reach what those shapes do not (tails, q_offset, narrow windows,
non-causal). Then it serves hymba_1_5b at its published widths in bf16
with ``attn_impl="flash"`` (4 prompts of 2048 seeded tokens, prefill into
the ring buffer, 32 greedy decode steps; 32 tensor-core flash launches and
32 ``ssd_scan`` launches per prefill), and holds flash against blockwise
prefill on the same weights and tokens, gated in f32 and reported in
bf16.

The MoE family and the int8 KV cache: it serves deepseek_moe_16b at its
published widths (28 layers, 64 routed experts top-6 plus 2 shared, vocab
102400; 33.76 GB of seeded bf16 weights) with flash prefill, the same
4 x 2048 prompts and 32 decode steps (gates: 28 tensor-core flash
launches, no layout copies, finite logits), profiles a prefill and a
decode step, and reuses those weights, never a second copy: flash
against blockwise in bf16 (reported), the int8 cache fed the bf16-cache
run's tokens (gates: ``quantize_kv`` on the card bit-identical to the
CPU, int8 leaves with f32 scales, every step's softmax within total
variation 0.05 of the bf16 cache's), and one layer in f32 on 4 x 2048
tokens (gates: ``moe_einsum`` and ``moe_sort`` within 2e-4 of each other,
the routing identical to the CPU's, the output within 2e-4 of it). Then
flash against blockwise on 4 full-width layers in f32, gated at 1e-3 of
the largest logit. ``flash_attention`` is also timed at deepseek's
attention shape (MHA, D = 128), and ``sharded_chain_batch`` is drawn on
cuda:0 and held to the CPU's draw.

Training (``train_phase``, last): ``repro_torch.launch.train.train_loop``
trains hymba_1_5b at its published widths (1,639,845,632 parameters, bf16,
remat, blockwise attention, seeded weights) for 6 steps of the synthetic
stream at 4 x 4096 tokens (train_4k's sequence; the global batch cut from
256 to 4). Gates: every loss finite, the AdamW step 6, every leaf updated,
no kernel of the port launched (the path runs none; each kernel row of the
``kernels`` line carries ``train_path_launches``), the whole state on the
card. It prints the steps' wall times, tokens/s, peak memory, model FLOPs
against the bf16 peak and one more step under torch.profiler. Then one
step's loss and gradients on the card against the CPU (2 layers, f32:
loss within 1e-5 relative, each leaf within 1e-3 of its largest
magnitude), crash and resume on the card (2 layers, a checkpoint every 2
steps, a crash at step 4: params and AdamW state bit-identical to an
uninterrupted run), and ``attn_impl="flash"`` refusing autograd.

The host world (``host_mesh_phase``, after training): the reference's
host-mesh path, ``train_loop(mesh=)`` and ``serve_lm`` on the partitioned
LM over every card of the machine, one rank a card over NCCL (a (1, 1)
world on one card), the ranks spawned through
``repro_torch.launch.mesh.launch`` as the CLIs start them, so no process
group is ever up in this process. hymba_1_5b at its published widths
trains 3 steps at 4 x 4096 (gates: each loss within 1e-3 relative of the
train phase's first three; the run's checkpoint, restored on the plain
path, bit-identical to the mesh run's state; the manifest's mesh the
world's), then serves the serve phase's prompts for 32 greedy steps
(gates: the run fed the serve phase's tokens within total variation
3e-3 of its softmax at each step, on one card too, where the plain
path's prefill SSD runs on ``ssd_scan`` and the partitioned LM's on
``ssd_chunked``; on one card its tokens equal the plain path's run on
``ssd_chunked``; a planted fault, one rank's cache shard zeroed, read
above that bound; the same on every rank; 32 tensor-core flash
launches, each kernel row's ``host_mesh_path_launches``). It prints
step seconds, peak memory and prefill and decode seconds beside the
plain path's. On a card count that does not divide the 4 rows (three
cards) they are replicated over the ranks, as the reference's spec lays
them out. Then, on the same world (``host_mesh_batches``), the batches
the reference's spec replicates: 2 steps at one row (one card) or two
rows (several) of 4096 tokens against the plain ``train_loop`` on the
same batches (gates: each step's logged loss and grad norm within one
unit of the printed digit; the last step's loss within 1e-5 relative,
its grad norm and the AdamW moments' sum of m^2 and of v within 1e-3, so
that gradients summed over replicas fail); and row 0 of the prompts
alone, 8 greedy steps (gates: 32 tensor-core flash launches, each kernel
row's ``host_mesh_one_row_path_launches``; the run fed the plain path's
tokens for that row within total variation 3e-3). flash_attention is
held to its plain version at that row's shape (q [1,25,2048,64]) before
the serve phase (``flash_one_row``).

The dry run (``dryrun_phase``, after the host world): ``run_cell`` of
``repro_torch.launch.dryrun`` for every arch x shape on the 16x16 pod mesh
and two cells of the 2x16x16 multi-pod mesh, on the meta device in 8
spawned host processes (gates: every applicable cell ``ok``, the skips
exactly ``shape_applicable``'s, the argument bytes equal to the specs').
Then hymba_1_5b at its published widths on a 1x1 mesh: prefill of 4 x 2048
tokens with flash, a decode step at batch 4 over a 2048-slot ring and a
train step at 4 x 4096, each dry-run on meta and then run on the card
(gates: the FLOPs counted on meta equal ``FlopCounterMode``'s over the
real step on cuda, the prefill's SSDs through ``ssd_scan``'s operator
on both, the argument bytes equal the real tensors'; printed:
the predicted peak against ``max_memory_allocated``, the step's time
against the roofline, model FLOPs against the bf16 peak), and the cost of
flash's ``torch.library`` operator against a direct launch.

The partitioned dry run (``dryrun_partitioned_phase``): the sweep's pod
cells (and mamba2_370m decode_32k on 2x16x16) carry the partitioned
L=1/L=2 probes, rank 0's local program on a DTensor mesh over torch's
fake process group, the MoE cells' expert-parallel dispatch included
(gates: every ``ok`` record has a numeric collective term and wire bytes
and per-device counts marked ``partitioned``; printed per cell: GiB per
device, the three roofline terms, wire bytes by kind). Then one rank's
shard for real, for each of ``PART_SHARDS``: hymba_1_5b's and
deepseek_moe_16b's prefill of 4 x 2048 tokens at their published widths
with flash on a (data=1, model=2) mesh over a fake world of 2 ranks, rank
0's local program run on cuda:0 beside its meta trace (gates: FLOPs meta
= cuda, flash's at the local heads, 15 q / 3 KV of 64 and 8 of 128;
argument bytes = the local shards'; collective count meta = cuda;
predicted peak within 5% of ``max_memory_allocated``; flash launched
once a layer on the tensor cores, 32 and 28 times; flash held to its
plain version at the local shape). Last,
``examples_phase`` runs the four torch examples on cuda (gates: exit 0,
the JAX examples' IIs, finite losses).

Every phase prints one JSON line; the line before the last is the
``kernels`` JSON, the last ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero without that line, as does a machine without
CUDA or a directory without the port's sources.
"""
import asyncio
import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# the card's published rates, one source for the port and this script;
# the import fails in a directory without the port
from repro_torch.launch import roofline  # noqa: E402

# the reference mapper's IIs at 4x4, sweep width 4, default solver; patricia
# is unmappable there (every II up to MII+16 is refuted). A CPU test
# (tests/test_torch_mapper.py) holds this table to the JAX package.
EXPECTED_II_4X4 = {"sha": 7, "sha2": 8, "gsm": 6, "patricia": None,
                   "bitcount": 6, "backprop": 6, "nw": 5, "srand": 3,
                   "hotspot": 7, "basicmath": 8, "stringsearch": 5}
# the lowest II at which each kernel's formula is SAT at 4x4 (every II
# below it UNSAT), whichever complete solver decides it; the final II
# can lie above it where the solver's model fails register allocation
# (patricia's CDCL models do at every II from 9 to its last)
EXPECTED_SAT_II_4X4 = dict(EXPECTED_II_4X4, patricia=9)
WALKSAT_KERNELS = ("sha", "gsm", "nw")
# the service phase: benchmarks/serve_load.py's --quick corpus (3x3, two
# near variants each), its storm size, and each request's deadline
SERVE_LOAD_KERNELS = ("sha", "gsm", "srand", "bitcount", "nw")
STORM_CLIENTS = 1000
SERVICE_DEADLINE_S = 120.0
# the campaign phase: repro_torch.launch.campaign --quick's corpus and
# fabrics (the reference's CI-sized run, at least 200 cells), its cells on
# "auto" (z3 where it imports). Two cuts: six shards, not two, and 20
# held-out cells, not 40. On z3 at --quick's own sizes the campaign took
# 368.8 s (H100 80GB HBM3, 700.00 W): 204.6 s to map the 306 cells on
# two shards, 106.8 s to map the 40 held-out cells twice in-process
CAMPAIGN_QUICK = dict(seed=0, workers=6, n_random=64, n_mutants=40,
                      fabrics="2x2,3x3,4x4", eval_cells=20, sweep_width=4)
HBM_BYTES_PER_S = roofline.HBM_BW        # H100 SXM device memory
INT_OPS_PER_S = 67e12            # H100 SXM non-tensor 32-bit rate
F32_FLOPS = 67e12                # H100 SXM non-tensor f32 rate
BF16_TENSOR_FLOPS = roofline.PEAK_FLOPS  # H100 SXM dense bf16 tensor cores
REPS = 50
# the LM slice: hymba_1_5b's attention and SSM shapes, and its serving run
ATTN_SHAPE = dict(B=4, Hq=25, Hkv=5, S=2048, D=64)
# minitron_8b's attention (the dense configs all have D = 128), causal
ATTN_SHAPE_D128 = dict(B=4, Hq=32, Hkv=8, S=2048, D=128)
# deepseek_moe_16b's prefill attention: MHA, 16 heads of 128, no window
ATTN_SHAPE_MOE = dict(B=4, Hq=16, Hkv=16, S=2048, D=128)
SSD_SHAPE = dict(b=4, s=2048, h=32, p=100, n=16)
# the benchmark's served prefill: 96 rows of hymba_1_5b's SSM (bf16 x/B/C,
# f32 dt, chunk 256), the scan with the state it hands to decode
SSD_SHAPE_SERVE = dict(SSD_SHAPE, b=96)
# granite-4.0-h-small at its benchmark cell's 4 x 8192: the attention
# layers (GQA, NoPE, scores times 1/128) and the Mamba layers (128 heads
# of 64, state 128; bf16 x/B/C, f32 dt, chunk 256)
GRANITE_ARCH = "granite-4.0-h-small"
ATTN_SHAPE_GRANITE = dict(B=4, Hq=32, Hkv=8, S=8192, D=128)
GRANITE_ATTN_SCALE = 1.0 / 128
SSD_SHAPE_GRANITE = dict(b=4, s=8192, h=128, p=64, n=128)
# attention_ref materialises f32 scores; above this many bytes of them it
# runs one batch row at a time
REF_SCORE_BYTES = 8 << 30
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS, AGREE_STEPS = 4, 2048, 32, 8
# the training phase: hymba_1_5b at its published widths, train_4k's
# sequence (src/repro/models/config.py) at a global batch cut from 256 to 4
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "hymba_1_5b", 6, 4, 4096
TRAIN_PARAMS = 1_639_845_632
# card vs CPU gradients (f32, 2 layers, 2 x 256 tokens) and crash/resume
# (the config's bf16, 2 layers, 4 x 512 tokens, 6 steps, a checkpoint
# every 2, a crash at step 4)
GRAD_LAYERS, GRAD_BATCH, GRAD_TOKENS = 2, 2, 256
GRAD_LOSS_RTOL, GRAD_LEAF_TOL = 1e-5, 1e-3
RESUME = dict(steps=6, global_batch=4, seq_len=512, ckpt_every=2)
RESUME_LAYERS, RESUME_FAIL_AT = 2, 4
# the host world: hymba_1_5b at the train phase's shape (its cut) for
# HOST_STEPS steps over every card, one rank a card (NCCL), each loss
# within HOST_LOSS_RTOL of the train phase's from the same seed; then the
# serve phase's prompts through the partitioned LM. Its checkpoint lives
# under build/chip_smoke_host_mesh, removed after
HOST_STEPS, HOST_LOSS_RTOL = 3, 1e-3
# on more than one card each rank's GEMMs see its rows alone and bf16
# rounds otherwise than on one card, so greedy tokens may part: the run
# fed the serve phase's tokens must keep each step's softmax within
# HOST_TV (total variation) of the serve phase's. Four H100s read at most
# 3.0e-4 a step; the bound is ten times that. Planted faults: after the
# prefill the last rank zeroes its shard of the named cache leaves, every
# layer's, and the run is fed the same tokens for HOST_FAULT_STEPS steps.
# Where the ranks do not divide the prompts, each holds the whole cache
# and rank 0's copy is the one reported: rank 0 zeroes its copy then.
# A lost cache shard ("cache": every leaf but the ring positions) must
# read above HOST_TV on any number of cards; the one-leaf faults are
# printed beside it, ungated (random weights leave attention near
# uniform, so zeroed keys move the softmax little)
HOST_TV = 3e-3
HOST_FAULTS = {"cache": ("k", "v", "state", "conv_x", "conv_B", "conv_C"),
               "k": ("k",), "v": ("v",), "state": ("state",)}
HOST_FAULT_GATED, HOST_FAULT_STEPS = "cache", 4
# then, on the same world, the batches a data axis of one rank or the
# ranks' data axes do not divide, which the reference's host mesh takes
# (its spec replicates them): HOST_SMALL_STEPS steps of train_loop(mesh=)
# at HOST_SMALL_BATCH rows of TRAIN_SEQ tokens (one row on one card, two
# rows replicated over the ranks on several), each loss within
# HOST_LOSS_RTOL of the plain train_loop's on the same batches; and row 0
# of the serve phase's prompts alone, ONE_ROW_STEPS greedy steps, held to
# the plain path's run of that row (fed its tokens within HOST_TV; on one
# card its tokens equal the plain path's on the partitioned LM's SSD route)
HOST_SMALL_STEPS, HOST_SMALL_BATCH, ONE_ROW_STEPS = 2, (1, 2), 8
# the small run's gates, tighter than HOST_LOSS_RTOL: each step's loss and
# grad norm as the log prints them (4 and 3 decimals, LOG_UNITS) within
# one unit of the last digit of the plain run's; the last step's loss at
# full precision within HOST_SMALL_LOSS_RTOL (a sixth of the loss's
# step-to-step movement, 6e-4 of 10.37 on the card); its grad norm and
# the AdamW moments' fingerprints (sum of m^2 and of v over every leaf)
# within HOST_SMALL_STATE_RTOL. Gradients summed over dp replicas read dp
# times the norm, dp^2 times both fingerprints; a skipped step leaves the
# moments where they were
HOST_SMALL_LOSS_RTOL, HOST_SMALL_STATE_RTOL = 1e-5, 1e-3
LOG_UNITS = {"losses": 1e-4, "grad_norms": 1e-3}
FLASH_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 3e-2}
# the host world's one-row serve: hymba's prefill attention at batch 1
ATTN_SHAPE_ONE_ROW = dict(ATTN_SHAPE, B=1)
# the kernel that flash_attention runs for each dtype
FLASH_ROUTE = {"torch.float32": "simt", "torch.bfloat16": "tensor_core"}
FLASH_NOTE = ("route by dtype: bf16 -> tensor_core (flash_fwd_kernel_wgmma: "
              "TMA ring + wgmma, warp-specialised), the row's shape and "
              "every served prefill launch; f32 -> simt (flash_fwd_kernel, "
              "f32 FMAs)")
SSD_TOL = 2e-3
SSD_NOTE = ("route by device, layout and grad mode (layers.ssd_route): a "
            "plain CUDA tensor on a call recording no autograd graph runs "
            "the kernel with its final state, one launch a served prefill "
            "layer; training, DTensors and the CPU run ssd_chunked")
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
                 "bound_no_clen", "phase_ms", "service_path_launches",
                 "campaign_path_launches", "moe_path_launches",
                 "moe_shape", "train_path_launches",
                 "dryrun_path_launches", "partitioned_path_launches",
                 "partitioned_shape", "partitioned_moe_path_launches",
                 "one_row_shape",
                 "partitioned_moe_shape", "host_mesh_path_launches",
                 "host_mesh_one_row_path_launches", "serve_shape",
                 "granite_path_launches", "granite_shape")
BF16_UNIT_ROUNDOFF = 2.0 ** -8   # a bf16 output is rounded once
# the dry run: the sweep's meshes (multi_pod, and None for every arch x
# shape or the (arch, shape) cells to run). Every cell on both meshes took
# 136.4 s in 8 workers on the host of one H100 80GB HBM3 (700 W), over the
# phase's ~120 s, so the multi-pod mesh is cut to two cells: the
# reference's own slow cell and the largest state per device. Then the
# worker processes, and the real cells of hymba_1_5b on one card: (kind,
# seq_len, global batch, timed steps); prefill as serve runs it (flash),
# decode at batch 4 over a 2048-slot ring, train at train_phase's 4 x 4096
# with remat and blockwise attention
DRY_SWEEP = ((False, None),
             (True, (("mamba2_370m", "decode_32k"),
                     ("llama4_maverick_400b_a17b", "train_4k"))))
DRY_WORKERS = 8
DRY_ARCH = "hymba_1_5b"
DRY_CELLS = (("prefill", 2048, 4, 3), ("decode", 2048, 4, 5),
             ("train", 4096, 4, 1))
# one rank's shard for real, per (arch, (kind, seq_len, global batch,
# timed steps)): the prefill of 4 x 2048 tokens with flash at the arch's
# published widths (deepseek_moe_16b's 32 of 64 experts a rank), on a
# (data=1, model=tp) mesh over a fake world of tp ranks, tp the first of
# PART_TP the attention plan takes; the predicted peak within
# PART_PEAK_TOL of max_memory_allocated
PART_SHARDS = (("hymba_1_5b", ("prefill", 2048, 4, 3)),
               ("deepseek_moe_16b", ("prefill", 2048, 4, 2)))
PART_TP = (2, 4)
PART_PEAK_TOL = 0.05
# the JAX examples' IIs on the CPU (examples/quickstart.py and
# examples/map_jax_loop.py at 4x4); tests/test_torch_examples.py holds the
# torch examples to them
EXAMPLE_IIS = {
    "quickstart_torch": ["mapped at II=3 (MII=3)"],
    "map_torch_loop": [
        "rope_rotation nodes=12 MII=3 II(paper-faithful)=3 II(+routing)=3",
        "router_argmax nodes= 5 MII=2 II(paper-faithful)=3 II(+routing)=3",
        "ssd_recurrence nodes= 8 MII=3 II(paper-faithful)=3 II(+routing)=3"]}
EXAMPLES_TIMEOUT_S = 600


START = time.perf_counter()


def emit(phase, **kw):
    """One phase's JSON line, with the seconds since the script started
    (``t_s``)."""
    print(json.dumps({"phase": phase, **kw,
                      "t_s": time.perf_counter() - START}), flush=True)


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
    try:
        import z3
        z3_version = z3.get_version_string()
    except ImportError:
        z3_version = None
    import networkx
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("environment", python=sys.version.split()[0],
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc[-1], triton=triton_version,
         networkx=networkx.__version__, z3=z3_version, nvidia_smi=smi,
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
    some); names without their namespace and arguments. None ("not
    measured") when every one of the tries came back with an empty trace:
    the split is reported, not checked, and the events time the call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(6):          # a trace now and then comes back empty
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
    emit("device_phases", not_measured="torch.profiler recorded no device "
                                       "kernels in 6 traces")
    return None


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
                # the plain version takes ~1 s a launch at 8x8, B=256
                "plain_ms": cuda_ms(torch, lambda: true_counts_window_ref(
                    cvars, csign, assign), reps=REPS if size == "4x4"
                    else 5, flush=flush),
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
    from repro_torch.core.sat import _has_z3, resolve_method
    from repro_torch.kernels.flip_update import (flip_update, reset_counts,
                                                 walk_chunk)
    if repro_torch.get_default_device() != "cuda":
        raise AssertionError("the port must default to cuda")
    # the complete backend "auto" resolves to here: z3 where it imports
    # (the paper's solver), else the in-repo CDCL
    complete = resolve_method("auto")
    if complete != ("z3" if _has_z3() else "cdcl"):
        raise AssertionError(f"'auto' resolved to {complete!r}")
    clause_eval.reset_counts()
    reset_counts()
    auto_vias = set()
    for name in suite.names():
        t0 = time.perf_counter()
        res = compile(MapRequest(dfg=suite.get(name), arch="4x4",
                                 sweep_width=4))
        got = _check_suite_ii(name, res, complete)
        vias = sorted({a.via for a in res.attempts})
        auto_vias.update(vias)
        emit("compile", kernel=name, solver="auto", complete=complete,
             ii=got, mii=res.mii, vias=vias,
             seconds=time.perf_counter() - t0)
    if complete not in auto_vias:
        raise AssertionError(f"no attempt of the 'auto' compiles ran on "
                             f"{complete}: {sorted(auto_vias)}")
    emit("z3_parity", complete=complete, verdicts=z3_parity())
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
         auto_complete_backend=complete, z3_importable=_has_z3(),
         auto_vias=sorted(auto_vias),
         clause_eval_window_route_launches=ce_routes,
         walk_chunk_route_launches=walk_chunk.route_launches,
         walk_chunk_steps=walk_chunk.steps,
         walk_seconds=walk_s, walk_steps=walk_steps,
         steps_per_s=walk_steps / walk_s,
         flips_per_s=walk_steps * 4 * 24 / walk_s)
    walk = {"steps": walk_chunk.steps,
            "route_launches": dict(walk_chunk.route_launches),
            "clause_eval_route_launches": ce_routes}
    if complete != "cdcl":
        # the reference's IIs are its CDCL's: the suite again on CDCL,
        # after the main path's counts were read
        t0 = time.perf_counter()
        iis = {name: _check_suite_ii(name, compile(MapRequest(
            dfg=suite.get(name), arch="4x4", sweep_width=4,
            solver="cdcl")), "cdcl") for name in suite.names()}
        emit("compile_cdcl", iis=iis, seconds=time.perf_counter() - t0)
    return launches, walk


def z3_parity(seeds=range(12)):
    """Where z3 imports: the port's ``Z3IncrementalSolver`` against its
    CDCL on seeded random 3-SAT formulas around the threshold, in two
    layers and under assumptions: the same verdicts, every model a model
    of the formula and the assumptions, every core a subset of the
    assumptions that CDCL refutes too. Returns the verdict counts, or
    None without z3."""
    import numpy as np
    from repro_torch.core.sat import _has_z3
    from repro_torch.core.sat.cdcl import CDCLSolver
    if not _has_z3():
        return None
    from repro_torch.core.sat.z3_backend import Z3IncrementalSolver
    seen = {}
    for seed in seeds:
        rng = np.random.default_rng(seed)
        n = int(rng.integers(20, 60))
        rows = [tuple(int(v) * int(sg) for v, sg in zip(
            rng.choice(n, 3, replace=False) + 1, rng.integers(0, 2, 3) * 2 - 1))
            for _ in range(int(rng.integers(4 * n, 8 * n)))]
        z3s, cdcl = Z3IncrementalSolver(), CDCLSolver()
        half = len(rows) // 2
        for live, new in ((rows[:half], rows[:half]), (rows, rows[half:])):
            z3s.add_clauses(new, n_vars=n)
            cdcl.add_clauses(new, n_vars=n)
            for k in (0, 4, 4):
                vs = rng.choice(n, k, replace=False) + 1
                lits = [int(v) * int(sg) for v, sg in
                        zip(vs, rng.integers(0, 2, k) * 2 - 1)]
                zs, zm = z3s.solve(assumptions=lits)
                cs, _ = cdcl.solve(assumptions=lits)
                if zs != cs:
                    raise AssertionError(f"z3 {zs} against CDCL {cs}, "
                                         f"seed {seed}")
                if zs == "SAT" and not all(
                        any(zm[abs(l) - 1] == (l > 0) for l in cl)
                        for cl in live + [(l,) for l in lits]):
                    raise AssertionError(f"z3's model fails, seed {seed}")
                if zs == "UNSAT":
                    core = z3s.last_core
                    check = CDCLSolver()
                    check.add_clauses(live, n_vars=n)
                    if not set(core) <= set(lits) or \
                            check.solve(assumptions=core)[0] != "UNSAT":
                        raise AssertionError(f"z3's core {core} of {lits} "
                                             f"does not refute, seed {seed}")
                key = zs if zs == "SAT" else \
                    "UNSAT/" + ("global" if z3s.last_core == [] else "core")
                seen[key] = seen.get(key, 0) + 1
    return seen


def _check_suite_ii(name, res, complete):
    """A suite compile at 4x4 against the reference: on CDCL exactly its
    II (``EXPECTED_II_4X4``); on any complete backend its verdicts (every
    II below ``EXPECTED_SAT_II_4X4`` tried is UNSAT, that II SAT) and a
    final II, if any, not below it. Returns the final II or None."""
    got = res.ii if res.success else None
    floor = EXPECTED_SAT_II_4X4[name]
    sat = [a.ii for a in res.attempts if a.status == "SAT"]
    below = [a for a in res.attempts if a.ii < floor]
    if res.timed_out or not sat or min(sat) != floor or \
            any(a.status != "UNSAT" for a in below) or \
            (got is not None and got < floor) or \
            (complete == "cdcl" and got != EXPECTED_II_4X4[name]):
        raise AssertionError(
            f"{name} on {complete}: II {got} (expected "
            f"{EXPECTED_II_4X4[name]} on CDCL, SAT from {floor}), "
            f"attempts {[(a.ii, a.status) for a in res.attempts]}")
    return got


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
    written once, against the chunked form's products (``ssd_flops``, the
    operator's FLOP formula): C.B^T and the decay-weighted product with x
    over the causal half of each chunk, and the two [l,p,n] state products
    per chunk."""
    from repro_torch.kernels.ssd_scan import ssd_flops
    flops = ssd_flops((b, s, h, p), None, None, (b, s, n), None, None, None,
                      chunk, False)
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


def flash_causal_row(torch, gen, shape, arch, scale=None):
    """flash_attention at ``arch``'s prefill shape in bf16 (causal, no
    window, swapped [B,S,H,D] views, scores times ``scale``, None for
    1/sqrt(D)) against attention_ref at the same scale, timed beside its
    plain version, its bound and SDPA's causal path; every launch on the
    tensor-core route. With a ``scale`` the same launch at the default
    scale must miss the reference by more than FLASH_TOL, so a scale
    dropped on the way to the kernel fails. Returns the row."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    dev = torch.device("cuda", 0)
    B, Hq, Hkv, S, D = (shape[k] for k in ("B", "Hq", "Hkv", "S", "D"))
    tol = FLASH_TOL["torch.bfloat16"]
    q, k, v = (torch.randn((B, S, h, D), generator=gen, device=dev)
               .to(torch.bfloat16).transpose(1, 2) for h in (Hq, Hkv, Hkv))

    def plain():
        if B * Hq * S * S * 4 <= REF_SCORE_BYTES:
            return attention_ref(q, k, v, causal=True, scale=scale)
        return torch.cat([attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                        causal=True, scale=scale)
                          for i in range(B)])
    before = dict(flash_attention.route_launches)
    got = flash_attention(q, k, v, causal=True, scale=scale)
    want = plain()
    torch.cuda.synchronize()
    err, ok = _close(got, want, tol, tol)
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"flash_attention bf16 {arch} scale {scale}: "
                             f"max abs err {err} beyond atol=rtol={tol}")
    del got
    row = {"arch": arch}
    if scale is not None:
        row["scale"] = scale
        row["default_scale_max_abs_err"], near = _close(
            flash_attention(q, k, v, causal=True), want, tol, tol)
        if near:
            raise AssertionError(f"flash_attention {arch}: the default "
                                 f"scale also meets the reference at scale "
                                 f"{scale}; the check cannot see a scale "
                                 f"left out")

    def lib_causal():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              scale=scale, enable_gqa=True)
    lib_err, _ = _close(lib_causal(), want, tol, tol)
    del want
    row.update({
        "ms": cuda_ms(torch, lambda: flash_attention(q, k, v, causal=True,
                                                     scale=scale)),
        "plain_ms": cuda_ms(torch, plain, reps=10 if S <= 2048 else 3),
        "library_ms": cuda_ms(torch, lib_causal),
        "bound": flash_bound_ms(B, Hq, Hkv, S, D, 0, q.element_size(),
                                BF16_TENSOR_FLOPS),
        "max_abs_err": err, "library_max_abs_err": lib_err,
        "shape": f"q [{B},{Hq},{S},{D}] k/v [{B},{Hkv},{S},{D}] bfloat16 "
                 f"window 0 causal, swapped [B,S,H,D] views",
        "library": "scaled_dot_product_attention(is_causal=True"
                   + (f", scale={scale})" if scale else ")")})
    emit("flash_attention", tolerance=tol, **row)
    _check_route(flash_attention, before, "tensor_core")
    del q, k, v
    torch.cuda.empty_cache()
    return row


def flash_one_row(torch, gen):
    """flash_attention at the host world's one-row serve shape
    (``ATTN_SHAPE_ONE_ROW``: hymba's prefill at batch 1, bf16, causal,
    window 1024, swapped [B,S,H,D] views) against attention_ref at
    FLASH_TOL, timed beside its plain version and its bound; every launch
    on the tensor-core route. Returns the row."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    dev = torch.device("cuda", 0)
    B, Hq, Hkv, S, D = (ATTN_SHAPE_ONE_ROW[k]
                        for k in ("B", "Hq", "Hkv", "S", "D"))
    window, tol = 1024, FLASH_TOL["torch.bfloat16"]
    q, k, v = (torch.randn((B, S, h, D), generator=gen, device=dev)
               .to(torch.bfloat16).transpose(1, 2) for h in (Hq, Hkv, Hkv))
    before = dict(flash_attention.route_launches)
    got = flash_attention(q, k, v, causal=True, window=window)
    want = attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    err, ok = _close(got, want, tol, tol)
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"flash_attention bf16 one row: max abs err "
                             f"{err} beyond atol=rtol={tol}")
    del got, want
    _check_route(flash_attention, before, "tensor_core")
    bound = flash_bound_ms(B, Hq, Hkv, S, D, window, q.element_size(),
                           BF16_TENSOR_FLOPS)
    row = {"shape": f"q [{B},{Hq},{S},{D}] k/v [{B},{Hkv},{S},{D}] "
                    f"bfloat16 window {window} causal, swapped [B,S,H,D] "
                    f"views",
           "max_abs_err": err,
           "ms": cuda_ms(torch, lambda: flash_attention(
               q, k, v, causal=True, window=window)),
           "plain_ms": cuda_ms(torch, lambda: attention_ref(
               q, k, v, causal=True, window=window), reps=10),
           "bound_ms": bound[0], "bound_by": bound[1]}
    emit("flash_attention_one_row", tolerance=tol, **row)
    return row


def lm_kernel_phase(torch):
    """flash_attention and ssd_scan against their plain versions at
    hymba_1_5b's shapes (and bf16 attention at minitron_8b's and
    deepseek_moe_16b's D = 128),
    with their times, bounds and (for attention) the library call's time.
    Returns the kernels-line entries, which hold the shapes the served
    model gives them: bf16 with the 1024 window for attention, bf16 x/B/C
    at the config's chunk of 256 for the scan; and deepseek_moe_16b's
    attention row (MHA, D = 128, causal); the attention row carries its
    check at the host world's one-row serve shape (``one_row_shape``)."""
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
    # minitron_8b's attention (GQA) and deepseek_moe_16b's (MHA) in bf16:
    # D = 128, causal, no window; the library call is SDPA's own causal path
    flash_causal_row(torch, gen, ATTN_SHAPE_D128, "minitron_8b")
    out["flash_attention_moe"] = flash_causal_row(torch, gen, ATTN_SHAPE_MOE,
                                                  "deepseek_moe_16b")
    # granite-4.0-h-small's NoPE layers: GQA at 8192 tokens, scores x 1/128
    out["flash_attention_granite"] = flash_causal_row(
        torch, gen, ATTN_SHAPE_GRANITE, GRANITE_ARCH,
        scale=GRANITE_ATTN_SCALE)
    out["flash_attention"]["one_row_shape"] = flash_one_row(torch, gen)
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
            got, state = ssd_scan(x, dt, A_log, Bm, Cm, Dv, chunk=chunk,
                                  return_state=True)
            torch.cuda.synchronize()
            err, ok = _close(got, want, SSD_TOL, rtol)
            if not ok or not torch.isfinite(got).all():
                raise AssertionError(f"ssd_scan {dtype} chunk {chunk}: max "
                                     f"abs err {err} beyond atol={SSD_TOL} "
                                     f"rtol={rtol} against ssd_ref")
            chunked, c_state = ssd_chunked(x, dt, A_log, Bm, Cm, Dv, chunk,
                                           return_state=True)
            c_err, c_ok = _close(got, chunked, SSD_TOL,
                                 rtol + (BF16_UNIT_ROUNDOFF
                                         if dtype == torch.bfloat16 else 0))
            s_err, s_ok = _close(state, c_state, SSD_TOL, SSD_TOL)
            if not c_ok or not s_ok:
                raise AssertionError(f"ssd_scan {dtype} chunk {chunk}: max "
                                     f"abs err {c_err} in y, {s_err} in the "
                                     f"final state against ssd_chunked")
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
                "state_max_abs_err": s_err,
                "max_abs_y": float(want.abs().max()),
                "shape": f"x [{b},{s},{h},{p}] B/C [{b},{s},{n}] "
                         f"{str(dtype)[6:]} x/B/C, dt f32, chunk {chunk}",
                "note": SSD_NOTE}
            emit("ssd_scan", atol=SSD_TOL, rtol=rtol, **row)
            if dtype == torch.bfloat16 and chunk == 256:
                out["ssd_scan"] = row
            del got, chunked, state, c_state
        del want
    out["ssd_scan"]["serve_shape"] = ssd_shape_row(
        torch, gen, SSD_SHAPE_SERVE, "ssd_scan_serve_shape")
    out["ssd_scan"]["granite_shape"] = ssd_shape_row(
        torch, gen, SSD_SHAPE_GRANITE, "ssd_scan_granite_shape")
    return out


def ssd_shape_row(torch, gen, shape, phase):
    """ssd_scan with its final state at a served prefill's ``shape`` (bf16
    x/B/C, f32 dt, chunk 256: ``SSD_SHAPE_SERVE``, the benchmark's 96 rows
    of hymba; ``SSD_SHAPE_GRANITE``, a granite Mamba layer at state 128),
    held to ``ssd_chunked`` (y within SSD_TOL plus two bf16 roundings, the
    state within SSD_TOL) and timed beside it and the sequential
    ``ssd_ref``; emitted as ``phase``."""
    from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
    from repro_torch.models.layers import ssd_chunked
    dev = torch.device("cuda", 0)
    b, s, h, p, n = (shape[k] for k in ("b", "s", "h", "p", "n"))
    chunk = 256
    x, Bm, Cm = (torch.randn(shape, generator=gen, device=dev)
                 .to(torch.bfloat16)
                 for shape in ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = torch.rand((b, s, h), generator=gen, device=dev) * 0.5
    A_log = torch.rand((h,), generator=gen, device=dev)
    Dv = torch.rand((h,), generator=gen, device=dev)
    args = (x, dt, A_log, Bm, Cm, Dv)
    got, state = ssd_scan(*args, chunk=chunk, return_state=True)
    chunked, c_state = ssd_chunked(*args, chunk, return_state=True)
    torch.cuda.synchronize()
    y_err, y_ok = _close(got, chunked, SSD_TOL,
                         SSD_TOL + 2 * BF16_UNIT_ROUNDOFF)
    s_err, s_ok = _close(state, c_state, SSD_TOL, SSD_TOL)
    if not (y_ok and s_ok) or not torch.isfinite(got).all():
        raise AssertionError(f"{phase}: max abs err {y_err} in y, {s_err} "
                             f"in the final state against ssd_chunked")
    del got, state, chunked, c_state
    torch.cuda.empty_cache()
    row = {
        "ms": cuda_ms(torch, lambda: ssd_scan(*args, chunk=chunk,
                                              return_state=True)),
        "chunked_ms": cuda_ms(torch, lambda: ssd_chunked(
            *args, chunk, return_state=True), reps=3),
        "plain_ms": cuda_ms(torch, lambda: ssd_ref(*args,
                                                   return_state=True),
                            reps=1),
        "bound": ssd_bound_ms(b, s, h, p, n, chunk, 2, 2, BF16_TENSOR_FLOPS),
        "phase_ms": device_phases(torch, lambda: ssd_scan(
            *args, chunk=chunk, return_state=True)),
        "chunked_max_abs_err": y_err, "state_max_abs_err": s_err,
        "shape": f"x [{b},{s},{h},{p}] B/C [{b},{s},{n}] bfloat16 x/B/C, "
                 f"dt f32, chunk {chunk}, final state [{b},{h},{p},{n}] f32"}
    emit(phase, atol=SSD_TOL, **row)
    del args, x, Bm, Cm, dt
    torch.cuda.empty_cache()
    return row


def clause_eval_band_phase(torch):
    """The chain tile of clause_eval counts the eval kernel's static shared
    memory: at V+1 = 7264 and 256 chains a tile of 8 words (the choice
    that ignored those bytes) overflows the card's 227 KB, the chosen 7
    fit. Held bit-exact to the plain version on a random table (L = 7),
    on both routes, and timed beside both routes' bounds."""
    from repro_torch.kernels.clause_eval import (true_counts_window,
                                                 true_counts_window_ref)
    from repro_torch.kernels.clause_eval.kernel import eval_smem
    from repro_torch.kernels.clause_eval.ops import (EVAL_STATIC_SMEM,
                                                     eval_tile)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    K, C, L, V1, B = 1, 4096, 7, 7264, 256
    cv = torch.randint(0, V1, (K, C, L), generator=gen, device=dev,
                       dtype=torch.int32)
    cs = torch.rand((K, C, L), generator=gen, device=dev) < 0.5
    a = torch.rand((K, B, V1), generator=gen, device=dev) < 0.5
    clen = torch.randint(0, L + 1, (K, C), generator=gen, device=dev,
                         dtype=torch.int32)
    cvc = torch.where(torch.arange(L, device=dev) < clen[..., None], cv, 0)
    for what, table, cl in (("full rows", cv, None), ("clen", cvc, clen)):
        if not torch.equal(true_counts_window(table, cs, a, cl),
                           true_counts_window_ref(table, cs, a)):
            raise AssertionError(f"clause_eval != plain at V+1 = {V1}, "
                                 f"B = {B} ({what})")
    static, optin = eval_smem()
    tile = eval_tile(B, V1)
    row = {"ms": cuda_ms(torch, lambda: true_counts_window(cvc, cs, a, clen)),
           "no_clen_ms": cuda_ms(torch, lambda: true_counts_window(cv, cs,
                                                                   a)),
           "plain_ms": cuda_ms(torch, lambda: true_counts_window_ref(
               cvc, cs, a), reps=10),
           "bound": clause_eval_bound_ms(cvc, V1, B, clen),
           "bound_no_clen": clause_eval_bound_ms(cv, V1, B)}
    emit("clause_eval_smem_band", V1=V1, B=B, C=C, L=L, tile_words=tile,
         dynamic_bytes=4 * V1 * tile, static_bytes=static,
         static_bytes_counted=EVAL_STATIC_SMEM, optin_bytes=optin,
         old_tile_bytes=4 * V1 * 8, bit_exact=True, **row)


def near_variant(g, v):
    """A near-shape sibling of ``g`` (as ``benchmarks/serve_load.py``
    makes them): input ``v % sites`` of some two-input node is rewired onto
    the node's other producer, keeping node and edge counts, kinds and the
    distance set (one lattice bucket), not the exact edges."""
    import copy
    g2 = copy.deepcopy(g)
    sites = [nid for nid in sorted(g2.nodes)
             if len(g2.nodes[nid].ins) == 2
             and g2.nodes[nid].ins[0][1] == 0
             and g2.nodes[nid].ins[1][1] == 0
             and g2.nodes[nid].ins[0][0] != g2.nodes[nid].ins[1][0]]
    if not sites:
        return None
    nid = sites[v % len(sites)]
    node = g2.nodes[nid]
    keep = node.ins[v // len(sites) % 2][0]
    node.ins = ((keep, 0), (keep, 0))
    g2.touch()
    g2.name = f"{g.name}~v{v}"
    g2.validate()
    return g2


def _same_result(a, b):
    """What a client consumes: verdict, II and MII, the exact placement."""
    return (a.success == b.success and a.ii == b.ii and a.mii == b.mii
            and a.placement == b.placement)


async def _serve_corpus(door, corpus, cfg, use_cache=True):
    t0 = time.perf_counter()
    res = await asyncio.gather(*[
        door.compile(g, cgra, cfg, use_cache=use_cache,
                     deadline_s=SERVICE_DEADLINE_S) for _, g, cgra in corpus])
    return list(res), time.perf_counter() - t0


async def _storm(door, corpus, cfg, n_clients):
    from repro_torch.launch.serve import DeadlineExceeded
    lat, fails = [], {"deadline_violations": 0, "errors": 0}

    async def client(i):
        _, g, cgra = corpus[i % len(corpus)]
        t0 = time.perf_counter()
        try:
            await door.compile(g, cgra, cfg, deadline_s=SERVICE_DEADLINE_S)
            lat.append(time.perf_counter() - t0)
        except DeadlineExceeded:
            fails["deadline_violations"] += 1
        except Exception:
            fails["errors"] += 1

    t0 = time.perf_counter()
    await asyncio.gather(*[client(i) for i in range(n_clients)])
    wall = time.perf_counter() - t0
    lat_ms = sorted(x * 1e3 for x in lat)

    def pct(p):
        return lat_ms[min(len(lat_ms) - 1, int(p / 100 * len(lat_ms)))] \
            if lat_ms else None

    return {"clients": n_clients, "served": len(lat), **fails,
            "wall_s": wall, "req_per_s": len(lat) / wall,
            "p50_ms": pct(50), "p99_ms": pct(99)}


def service_phase(torch, smi):
    """The mapping service tier on the card, in a process that initialised
    CUDA long before: walksat requests through an in-process
    MappingService (cache, then disk after a restart), a spawned
    WorkerPool whose shard runs the walk on the card, the four phases of
    ``benchmarks/serve_load.py --quick --check`` through CompileFrontDoor
    with their gates, and ``serve --offload-cgra``'s mapping of
    hymba_1_5b's loops. The service timings are host-bound (the CDCL and
    the processes around it), not kernel times. Returns the walk kernels'
    launch counts of the in-process service run."""
    import shutil
    from repro_torch import MapRequest, compile
    from repro_torch.configs import get_config
    from repro_torch.core import suite
    from repro_torch.core.cgra import cgra_from_name
    from repro_torch.core.mapper import MapperConfig
    from repro_torch.core.service import MappingService
    from repro_torch.core.store import MappingStore
    from repro_torch.core.workers import WorkerPool, _probe_shards
    from repro_torch.kernels import clause_eval
    from repro_torch.kernels.clause_eval import true_counts_window
    from repro_torch.kernels.flip_update import reset_counts, walk_chunk
    from repro_torch.launch.serve import CompileFrontDoor, offload_report
    from repro_torch.kernels._cuda import BUILD_DIR
    base = BUILD_DIR.parent / "chip_smoke_service"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)

    # -- in-process service: walksat requests, then cache, then disk ------
    store_dir = str(base / "inproc")
    svc = MappingService(store=MappingStore(store_dir))
    clause_eval.reset_counts()
    reset_counts()
    first = {}
    for name in WALKSAT_KERNELS:
        t0 = time.perf_counter()
        res = compile(MapRequest(dfg=suite.get(name), arch="4x4",
                                 sweep_width=4, solver="walksat",
                                 service=svc))
        secs = time.perf_counter() - t0
        win = [a for a in res.attempts if a.ii == res.ii]
        if res.ii != EXPECTED_II_4X4[name] or not win or \
                win[0].via != "walksat" or res.service.via != "cold":
            raise AssertionError(f"service {name}: II {res.ii} (expected "
                                 f"{EXPECTED_II_4X4[name]}), via "
                                 f"{res.service.via}, winner "
                                 f"{win[0].via if win else None}")
        first[name] = res
        emit("service_compile", kernel=name, solver="walksat", ii=res.ii,
             via=res.service.via, seconds=secs)
    launches = {"clause_eval_window": true_counts_window.launches,
                "walk_chunk": walk_chunk.launches}
    if not all(launches.values()):
        raise AssertionError(f"the service's walks launched no kernel: "
                             f"{launches}")
    for name in WALKSAT_KERNELS:
        res = compile(MapRequest(dfg=suite.get(name), arch="4x4",
                                 sweep_width=4, solver="walksat",
                                 service=svc))
        if res.service.via != "cache" or not _same_result(res, first[name]):
            raise AssertionError(f"service repeat {name}: via "
                                 f"{res.service.via}")
    svc2 = MappingService(store=MappingStore(store_dir))
    for name in WALKSAT_KERNELS:
        res = compile(MapRequest(dfg=suite.get(name), arch="4x4",
                                 sweep_width=4, solver="walksat",
                                 service=svc2))
        if res.service.via != "disk" or not _same_result(res, first[name]) \
                or [(a.ii, a.status, a.via) for a in res.attempts] != \
                [(a.ii, a.status, a.via) for a in first[name].attempts]:
            raise AssertionError(f"service restart {name}: via "
                                 f"{res.service.via}, not the first result")
    emit("service_inproc", kernels=list(WALKSAT_KERNELS), launches=launches,
         repeat_via="cache", restart_via="disk", bit_identical=True,
         stats=svc.describe())

    # -- the four phases of serve_load.py --quick, over spawned shards -----
    cfg = MapperConfig(solver="auto", timeout_s=120.0, max_learnt=100_000)
    corpus, variants = [], []
    for size in ("3x3",):
        cgra = cgra_from_name(size)
        for name in SERVE_LOAD_KERNELS:
            g = suite.get(name)
            corpus.append((f"{name}/{size}", g, cgra))
            for v in range(2):
                gv = near_variant(g, v)
                if gv is not None:
                    variants.append((f"{gv.name}/{size}", gv, cgra))
    n_base = len(corpus)
    corpus += variants
    pool_dir = str(base / "pool")
    walk_cfg = MapperConfig(solver="walksat")
    t0 = time.perf_counter()
    with WorkerPool(workers=2, store_path=pool_dir, near_delta=1) as pool:
        start_s = time.perf_counter() - t0
        shard = pool.shard_of(suite.get("nw"), cgra_from_name("4x4"),
                              walk_cfg)
        res = pool.map(suite.get("nw"), cgra_from_name("4x4"), walk_cfg,
                       sweep_width=4)
        if res.ii != EXPECTED_II_4X4["nw"] or not any(
                a.via == "walksat" for a in res.attempts if a.ii == res.ii):
            raise AssertionError(f"shard walksat nw: II {res.ii}")
        probes = _probe_shards(pool)
        walked = probes[shard]
        if walked["device"] != "cuda" or not (
                walked["launches"]["clause_eval_window"]
                and walked["launches"]["walk_chunk"]) or \
                walked["pid"] == os.getpid():
            raise AssertionError(f"the shard's walk did not run on the "
                                 f"card: {probes}")
        emit("service_shard_walk", start_s=start_s, shard=shard,
             probes=probes, ii=res.ii)

        async def cold_phase():
            async with CompileFrontDoor(pool, window_ms=4.0,
                                        max_batch=64) as door:
                a, ta = await _serve_corpus(door, corpus[:n_base], cfg)
                b, tb = await _serve_corpus(door, corpus[n_base:], cfg)
            return a + b, ta + tb
        cold, t_cold = asyncio.run(cold_phase())
        cold_stats = pool.stats()
        cold_probes = _probe_shards(pool)

    with WorkerPool(workers=2, store_path=pool_dir, near_delta=1) as pool:
        async def warm_phases():
            async with CompileFrontDoor(pool, window_ms=4.0,
                                        max_batch=64) as door:
                warm, t_warm = await _serve_corpus(door, corpus, cfg)
                resolved, t_res = await _serve_corpus(
                    door, corpus[:n_base], cfg, use_cache=False)
                storm = await _storm(door, corpus, cfg, STORM_CLIENTS)
                return warm, t_warm, resolved, t_res, storm, \
                    door.stats.snapshot()
        warm, t_warm, resolved, t_res, storm, door_stats = \
            asyncio.run(warm_phases())
        warm_stats = pool.stats()
        warm_probes = _probe_shards(pool)

    direct = [compile(MapRequest(dfg=g, arch=cgra, config=cfg))
              for _, g, cgra in corpus]
    bad = []
    mism = [n for (n, _, _), a, b in zip(corpus, cold, direct)
            if not _same_result(a, b)]
    if mism:
        bad.append(f"served != direct compile() on {mism}")
    drift = [n for (n, _, _), a, b in zip(corpus, warm, cold)
             if not _same_result(a, b)]
    if drift:
        bad.append(f"warm restart drifted from cold on {drift}")
    not_disk = [n for (n, _, _), r in zip(corpus, warm)
                if r.service.via != "disk"]
    if not_disk:
        bad.append(f"warm restart not served from disk on {not_disk}")
    speedup = t_cold / max(t_warm, 1e-9)
    if speedup < 3.0:
        bad.append(f"warm restart {speedup:.2f}x < 3x faster than cold")
    # a re-solve starts from the preloaded cores, so its model (the
    # placement) may differ; its verdict and II may not
    resolve_bad = [n for (n, _, _), a, b in
                   zip(corpus, resolved, cold[:n_base])
                   if (a.success, a.ii) != (b.success, b.ii)]
    if resolve_bad:
        bad.append(f"re-solves found another II than cold on {resolve_bad}")
    if cold_stats.get("near_hits", 0) < 1:
        bad.append("no near-shape warm admissions")
    if warm_stats.get("cores_preloaded", 0) < 1:
        bad.append("restarted shards preloaded no UNSAT cores")
    if storm["clients"] < 1000 or storm["deadline_violations"] or \
            storm["errors"] or storm["served"] != storm["clients"]:
        bad.append(f"storm: {storm}")
    hit_rates = {
        "near_shape": cold_stats.get("near_hits", 0) / max(len(variants), 1),
        "disk": warm_stats.get("disk_hits", 0)
        / max(warm_stats.get("requests", 0), 1),
        "cache": (cold_stats.get("cache_hits", 0)
                  + warm_stats.get("cache_hits", 0))
        / max(cold_stats.get("requests", 0)
              + warm_stats.get("requests", 0), 1),
        "core_prune_iis": warm_stats.get("iis_pruned", 0),
        "cores_preloaded": warm_stats.get("cores_preloaded", 0),
        "near_hits": cold_stats.get("near_hits", 0)}
    emit("service_load", device=smi, host_bound=True,
         corpus_cells=len(corpus), base_cells=n_base,
         variant_cells=len(variants), cold_s=t_cold, warm_s=t_warm,
         warm_speedup=speedup, resolve_s=t_res, storm=storm,
         hit_rates=hit_rates, front_door=door_stats,
         shard_launches={"cold_pool": [p["launches"] for p in cold_probes],
                         "warm_pool": [p["launches"] for p in warm_probes]},
         shard_devices=[p["device"] for p in cold_probes + warm_probes],
         gates_failed=bad)
    if bad:
        raise AssertionError("serve_load gates: " + "; ".join(bad))

    # -- serve --offload-cgra: hymba_1_5b's loops through get_service() ----
    t0 = time.perf_counter()
    loops = offload_report(get_config("hymba_1_5b"), "4x4")
    want = ["rmsnorm_acc", "rope_rotation", "ssd_recurrence"]
    if list(loops) != want or not all(r.success for r in loops.values()):
        got = [(n, r.ii) for n, r in loops.items()]
        raise AssertionError(f"offload: {got}, expected {want} mapped")
    emit("service_offload", arch="hymba_1_5b", cgra="4x4",
         ii={n: r.ii for n, r in loops.items()},
         via={n: r.service.via for n, r in loops.items()},
         seconds=time.perf_counter() - t0)
    shutil.rmtree(base, ignore_errors=True)
    return launches


def guided_windows(req):
    """The windows a guided sweep of ``req`` walks up to its expected II,
    as the sweep forms them (spans from the guide's suggestion, clamped to
    [1, max(width, 16)]), each stacked as the walk receives it: the
    session's per-II projections, encoded window by window, through
    ``pack_cnf_window_np``. Returns [(IIs, HostPack)]."""
    from repro_torch.core.campaign import cell_features
    from repro_torch.core.encode import EncoderSession
    from repro_torch.core.guide import resolve_guide
    from repro_torch.core.sat import walksat_torch as W
    from repro_torch.core.sat.portfolio import SolverSession
    from repro_torch.core.schedule import min_ii
    cgra, cfg = req.resolved_arch(), req.resolved_config()
    sug = resolve_guide(cfg.guide).suggest(cell_features(req.dfg, cgra))
    mii = min_ii(req.dfg, cgra)
    sess = SolverSession(EncoderSession(req.dfg, cgra, cfg.amo),
                         method=cfg.solver, seed=cfg.seed)
    out, base = [], mii
    while base <= EXPECTED_II_4X4[req.dfg.name]:
        width = max(1, min(int(sug.span_from(base - mii)),
                           max(req.sweep_width, 16)))
        iis = list(range(base, base + width))
        for ii in iis:
            sess.ensure_ii(ii)
        cnfs = [sess.project(ii) for ii in iis]
        out.append((iis, W.pack_cnf_window_np(
            cnfs, [sess.host_pack(ii)[0] for ii in iis])))
        base = iis[-1] + 1
    return out


def guided_window_parity(torch, reqs):
    """clause_eval (both routes) and walk_chunk (chunks of 1 and 177 steps)
    against their plain versions, bit for bit, on every window the guided
    walks of ``reqs`` receive (24 chains, as the sweep's walk runs them).
    Returns {kernel: [(IIs, K)]} and the set of window widths checked."""
    from repro_torch.convert import window_from_numpy
    from repro_torch.core.sat import walksat_torch as W
    from repro_torch.kernels.clause_eval import (true_counts_window,
                                                 true_counts_window_ref)
    from repro_torch.kernels.flip_update import walk_route
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(17)
    key = W.walk_key(17)
    checked, ks = {}, set()
    for name, req in reqs.items():
        checked[name] = []
        for iis, host in guided_windows(req):
            p = window_from_numpy(host, dev)
            K, C, L = p.cvars.shape
            V1 = p.n_vars + 1
            what = f"{name} 4x4 IIs {iis[0]}..{iis[-1]} (K={K})"
            a = torch.rand((K, 24, V1), generator=gen, device=dev) < 0.5
            want = true_counts_window_ref(p.cvars, p.csign, a)
            for cl in (p.clen, None):
                if not torch.equal(true_counts_window(p.cvars, p.csign, a,
                                                      cl), want):
                    raise AssertionError(
                        f"clause_eval window != plain on {what} "
                        f"({'clen' if cl is not None else 'full rows'})")
            a, tc = _walk_parity(torch, p, a, want, key, 0, 1, what)
            _walk_parity(torch, p, a, tc, key, 1, 177, what)
            checked[name].append({"iis": iis, "K": K, "C": C, "L": L,
                                  "V1": V1, "route": walk_route(C, L, V1)})
            ks.add(K)
            del p, a, tc, want
    emit("parity_guided_windows", windows=checked, B=24, chunks=[1, 177],
         clause_eval_routes=["clen", "full_rows"], bit_identical=True)
    return checked, ks


def campaign_phase(torch, smi):
    """The mapping campaign and learned II guidance on the card, in a
    process that initialised CUDA long before: ``repro_torch.launch.
    campaign.run`` at ``CAMPAIGN_QUICK`` (the reference's ``--quick``
    corpus, six shards spawned on cuda whose cells the default solver
    maps on the host (z3 where it imports, else CDCL), the dataset, the
    guide trained on cuda:0, the held-out attempts comparison and the
    33-cell suite gate) with ``check_gates == []``;
    ``train_guide`` again on the dataset, its host wall beside its device
    time (CUDA events around the call, the kernels' busy time from
    torch.profiler); clause_eval and walk_chunk against their plain
    versions on each window the guided walks below receive
    (``guided_window_parity``); sha, gsm and nw at 4x4 with the walk as
    the solver, guided by the trained ``guide.npz`` (windows of 1..8 IIs
    through clause_eval and walk_chunk, launches counted per K, every K
    held above), then with an unresolvable guide name (unguided); and
    the saved ``.npz`` read back by the numpy guide, suggesting what the
    live guide suggests on every suite cell. The campaign's timings are
    host-bound (the solver in the shards). Returns the walk kernels'
    launch counts of the guided walk."""
    import shutil
    from repro_torch import MapRequest, compile
    from repro_torch.core import suite
    from repro_torch.core.arch import arch
    from repro_torch.core.campaign import CampaignDataset, cell_features
    from repro_torch.core.guide import (IIGuide, clear_guides, resolve_guide,
                                        train_guide)
    from repro_torch.kernels import clause_eval
    from repro_torch.kernels._cuda import BUILD_DIR
    from repro_torch.kernels.clause_eval import true_counts_window
    from repro_torch.kernels.flip_update import reset_counts, walk_chunk
    from repro_torch.launch import campaign
    base = BUILD_DIR.parent / "chip_smoke_campaign"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)

    # -- the campaign at CAMPAIGN_QUICK -------------------------------------
    t0 = time.perf_counter()
    summary = campaign.run(out=str(base), **CAMPAIGN_QUICK)
    run_s = time.perf_counter() - t0
    bad = campaign.check_gates(summary)
    g = summary.get("guide", {})
    st = summary["campaign"]
    emit("campaign", device=smi, host_bound=True, sizes=CAMPAIGN_QUICK,
         corpus=summary["corpus"], dedup_rate=summary["dedup_rate"],
         corpus_digest=summary["corpus_digest"], cells=st["cells"],
         cells_per_s=st["cells_per_sec"], campaign_s=st["wall_s"],
         mapped=st["mapped"], refuted=st["failed"],
         infeasible=st["infeasible"], witnesses=st["witnesses"],
         dataset=summary["dataset"], guide=g,
         eval=summary.get("eval"),
         suite_gate={k: v for k, v in summary.get("suite_gate", {}).items()
                     if k != "mismatches"},
         run_s=run_s, gates_failed=bad)
    if bad:
        raise AssertionError("campaign gates: " + "; ".join(bad))
    if g.get("device") != "cuda:0":
        raise AssertionError(f"train_guide ran on {g.get('device')}, not "
                             f"cuda:0")

    # -- guide training on the card: wall vs device time ------------------
    records = list(CampaignDataset(str(base / "cells")))
    if len(records) != st["cells"]:
        raise AssertionError(f"the dataset read back {len(records)} of "
                             f"{st['cells']} cells")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    _, m = train_guide(records, seed=0)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    if m["device"] != "cuda:0":
        raise AssertionError(f"train_guide's parameters on {m['device']}")
    prof = _profile(torch, lambda: train_guide(records, seed=0), "gemm")
    steps = 300 * -(-m["n_train"] // 256)
    emit("guide_train", device=smi, n_train=m["n_train"],
         n_heldout=m["n_heldout"], epochs=300, adam_steps=steps,
         param_device=m["device"], wall_s=wall_s,
         event_s=start.elapsed_time(end) / 1e3,
         device_busy_ms=prof["device_ms"],
         device_busy_share=prof["device_ms"] / 1e3 / wall_s,
         kernel_launches=prof["kernel_launches"],
         launches_per_step=prof["kernel_launches"] / steps,
         wall_us_per_step=wall_s * 1e6 / steps,
         gemm_ms=prof["gemm_ms"], top_kernels=prof["top_kernels"],
         hit1=m["hit1"], baseline_hit1=m["baseline_hit1"],
         final_loss=m["final_loss"])

    # -- the saved checkpoint suggests what the live guide suggests -------
    live = resolve_guide("campaign")
    saved = IIGuide.load(summary["guide_path"])
    cells = [(n, f) for n in suite.names() for f in ("2x2", "3x3", "4x4")]
    differ = []
    for name, fabric in cells:
        x = cell_features(suite.get(name), arch(fabric))
        if live.suggest(x) != saved.suggest(x):
            differ.append((name, fabric))
    if differ:
        raise AssertionError(f"guide.npz suggests otherwise on {differ}")

    # -- the guided walk: windows of 1..8 IIs on the card -----------------
    # first both walk kernels against their plain versions on each window
    # the guided walks will receive (outside the counted run)
    reqs = {name: MapRequest(dfg=suite.get(name), arch="4x4", sweep_width=4,
                             solver="walksat", guide=summary["guide_path"])
            for name in WALKSAT_KERNELS}
    held, held_k = guided_window_parity(torch, reqs)
    clause_eval.reset_counts()
    reset_counts()
    guided = {}
    for name, req in reqs.items():
        t0 = time.perf_counter()
        res = compile(req)
        secs = time.perf_counter() - t0
        gd = res.guidance or {}
        win = [a for a in res.attempts if a.ii == res.ii]
        if res.ii != EXPECTED_II_4X4[name] or not gd.get("used") or \
                not win or win[0].via != "walksat":
            raise AssertionError(f"guided walk {name}: II {res.ii} "
                                 f"(expected {EXPECTED_II_4X4[name]}), "
                                 f"guidance {gd}")
        if gd["spans"] != [len(w["iis"]) for w in held[name]]:
            raise AssertionError(f"guided walk {name}: spans {gd['spans']}, "
                                 f"parity held windows {held[name]}")
        guided[name] = {"ii": res.ii, "mii": res.mii,
                        "spans": gd["spans"], "offset": gd["offset"],
                        "hopeless": gd["hopeless"],
                        "attempts": len(res.attempts), "seconds": secs}
    launches = {"clause_eval_window": true_counts_window.launches,
                "walk_chunk": walk_chunk.launches}
    per_k = {"clause_eval_window": dict(true_counts_window.k_launches),
             "walk_chunk": dict(walk_chunk.k_launches)}
    routes = {"clause_eval_window": dict(true_counts_window.route_launches),
              "walk_chunk": dict(walk_chunk.route_launches)}
    if not all(launches.values()):
        raise AssertionError(f"the guided walks launched no kernel: "
                             f"{launches}")
    unheld = {k for ks in per_k.values() for k in ks} - held_k
    if unheld:
        raise AssertionError(f"the guided walks launched at window widths "
                             f"{sorted(unheld)}, not held against the plain "
                             f"versions (held: {sorted(held_k)})")
    # the 4x4 windows fit a block's shared memory at every K, and the walk
    # evaluates every window on its row lengths
    if routes["walk_chunk"]["global"] or \
            routes["clause_eval_window"]["full_rows"]:
        raise AssertionError(f"guided walk off its expected routes: "
                             f"{routes}")

    # -- an unresolvable guide name runs unguided --------------------------
    unguided = {}
    for name in WALKSAT_KERNELS:
        res = compile(MapRequest(dfg=suite.get(name), arch="4x4",
                                 sweep_width=4, solver="walksat",
                                 guide="no-such-guide"))
        if res.ii != EXPECTED_II_4X4[name] or \
                res.guidance != {"guide": "no-such-guide", "used": False}:
            raise AssertionError(f"unresolvable guide {name}: II {res.ii}, "
                                 f"guidance {res.guidance}")
        unguided[name] = {"ii": res.ii, "attempts": len(res.attempts)}
    emit("campaign_guided_walk", device=smi, cgra="4x4", solver="walksat",
         guided=guided, launches=launches, launches_per_k=per_k,
         route_launches=routes, unresolvable_guide=unguided,
         npz_matches_live_guide_cells=len(cells))
    clear_guides()
    shutil.rmtree(base, ignore_errors=True)
    return launches


def _counters():
    from repro_torch.kernels.clause_eval import true_counts, true_counts_window
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flip_update import flip_update, walk_chunk
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"clause_eval_window": true_counts_window,
            "clause_eval": true_counts, "flip_update": flip_update,
            "walk_chunk": walk_chunk, "flash_attention": flash_attention,
            "ssd_scan": ssd_scan}


def serve_prompts(torch, vocab, seed=1):
    dev = torch.device("cuda", 0)
    return torch.randint(0, vocab, (SERVE_BATCH, SERVE_PROMPT),
                         generator=torch.Generator(device=dev).manual_seed(
                             seed), device=dev)


def _mixer_layers(cfg):
    """(attention layers, SSM layers) of ``cfg``: every layer of its
    family's kinds, or a patterned stack's layers of each kind."""
    from repro_torch.models.config import PatternConfig
    if isinstance(cfg, PatternConfig):
        return (len(cfg.layers_of("attention")), len(cfg.layers_of("mamba")))
    return (0 if cfg.is_attention_free else cfg.n_layers,
            cfg.n_layers if cfg.has_ssm else 0)


def serve_phase(torch, arch, smi):
    """A main path of the LM: ``arch`` at its published widths in bf16 with
    attn_impl="flash", weights from LM.init (seeded), 4 prompts of 2048
    seeded tokens prefilled into the ring buffer (2048 slots, or the
    config's window), then 32 greedy decode steps; then where its time
    goes (``serve_profile``). Gates, on the launch counts zeroed after the
    warm-up: one flash launch per attention layer, all on the tensor
    cores, no layout copies, one ssd_scan launch per SSM layer (a
    patterned stack's layers each of one kind: granite-4.0-h-small 4 and
    36), finite logits. Returns (the LM,
    the prompts, the serve result, the launch counts of the run, its peak
    memory)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import reset_counts
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models.model import LM
    dev = torch.device("cuda", 0)
    cfg = get_config(arch).replace(attn_impl="flash")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    param_bytes = sum(t.numel() * t.element_size() for t in lm.parameters())
    serve_lm(lm, serve_prompts(torch, cfg.vocab, seed=2)[:1, :256],
             2)                                            # warm-up
    prompts = serve_prompts(torch, cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    for f in counters.values():
        f.launches = 0
    reset_counts()
    res = serve_lm(lm, prompts, SERVE_STEPS)
    launches = {name: f.launches for name, f in counters.items()}
    flash = counters["flash_attention"]
    routes = dict(flash.route_launches)
    n_attn, n_ssm = _mixer_layers(cfg)
    if launches["flash_attention"] != n_attn or \
            routes["tensor_core"] != n_attn:
        raise AssertionError(f"{cfg.name} prefill launched flash_attention "
                             f"{launches['flash_attention']} times ({routes}),"
                             f" expected one per attention layer ({n_attn}), "
                             f"all on the tensor cores")
    if flash.layout_copies:
        raise AssertionError(f"the served prefill copied "
                             f"{flash.layout_copies} operands before flash")
    if launches["ssd_scan"] != n_ssm:
        raise AssertionError(f"{cfg.name} prefill launched ssd_scan "
                             f"{launches['ssd_scan']} times, expected one "
                             f"per SSM layer ({n_ssm})")
    finite = all(bool(torch.isfinite(lg).all()) for lg in res.logits)
    if not finite or res.tokens.shape != (SERVE_BATCH, SERVE_STEPS):
        raise AssertionError(f"{cfg.name} serve: non-finite logits or wrong "
                             f"token shape")
    moe = dict(n_experts=cfg.n_experts, n_shared_experts=cfg.n_shared_experts,
               top_k=cfg.top_k, moe_impl=cfg.moe_impl) if cfg.n_experts else {}
    emit("serve", arch=cfg.name, nvidia_smi=smi, n_layers=cfg.n_layers,
         attention_layers=n_attn, ssm_layers=n_ssm,
         d_model=cfg.d_model, vocab=cfg.vocab, dtype=cfg.dtype,
         attn_impl=cfg.attn_impl, **moe, requests=SERVE_BATCH,
         prompt_len=SERVE_PROMPT,
         ring_window=min(SERVE_PROMPT, cfg.attn_window or SERVE_PROMPT),
         decode_steps=SERVE_STEPS, param_bytes=param_bytes,
         init_s=init_s, init_max_memory_allocated=init_peak,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         prefill_s=res.prefill_s,
         prefill_tokens_per_s=SERVE_BATCH * SERVE_PROMPT / res.prefill_s,
         decode_s=res.decode_s,
         decode_tokens_per_s=SERVE_BATCH * SERVE_STEPS / res.decode_s,
         launches=launches, flash_route_launches=routes,
         flash_layout_copies=flash.layout_copies, logits_finite=finite,
         first_tokens=res.tokens[:, :8].tolist())
    peak = torch.cuda.max_memory_allocated()
    serve_profile(torch, lm, prompts)
    return lm, prompts, res, launches, peak


def _profile(torch, fn, match):
    """Device time of ``fn`` from torch.profiler: the kernels' total time
    and launch count, the time of the kernels whose name holds ``match``,
    and the operators that launched the most device time (self time of
    the kernels each launched directly). User-annotated ranges that the
    profiler also puts on the device timeline (``Optimizer.step#...``)
    are spans, not kernels, and are left out."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if v is None else v
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(6):          # a trace now and then comes back empty
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = prof.key_averages()
        kernels = [e for e in rows if e.device_type == cuda
                   and not getattr(e, "is_user_annotation", False)]
        if kernels:
            break
    else:
        raise AssertionError("torch.profiler recorded no device kernels")
    ops = sorted((e for e in rows if e.device_type != cuda and dev_us(e)),
                 key=dev_us, reverse=True)
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
    emit("serve_profile", arch=lm.cfg.name, batch=prompts.shape[0],
         prompt_len=prompts.shape[1],
         decode_step_wall_ms=wall_d,
         decode_device_busy_share=decode["device_ms"] / wall_d,
         decode=decode, prefill_wall_ms=wall_p,
         prefill_device_busy_share=prefill["device_ms"] / wall_p,
         prefill_flash_ms=flash_ms,
         prefill_flash_share=flash_ms / prefill["device_ms"],
         prefill=prefill)


@contextlib.contextmanager
def swapped_cfg(lm, **changes):
    """``lm`` with ``cfg.replace(**changes)`` for the duration: another
    attention path or cache layout over the same parameter tensors, so two
    runs never hold two copies of the weights."""
    cfg = lm.cfg
    lm.cfg = cfg.replace(**changes)
    try:
        yield lm
    finally:
        lm.cfg = cfg


def flash_agreement(torch, lm, prompts, steps=AGREE_STEPS):
    """Prefill ``prompts`` through the flash kernel and through the
    blockwise path (the reference's default) on the same weights (``lm``
    with its config swapped), fed the same tokens, compared over the
    prefill's last logits and ``steps`` decode steps' logits. In f32 (the
    SIMT kernel) they must agree to 1e-3 of the largest logit; in bf16 (the
    tensor-core kernel; both paths round their activations to bf16 at
    other places, layer after layer) the difference and whether the greedy
    tokens agree are reported, and the logits must be finite. Every flash
    launch must be on the dtype's route, one a layer, none in the blockwise
    run."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     reset_counts)
    from repro_torch.launch.serve import serve_lm
    cfg = lm.cfg
    dtype = str(lm.dtype)[6:]
    route = FLASH_ROUTE[str(lm.dtype)]
    reset_counts()
    with swapped_cfg(lm, attn_impl="flash"):
        res_f = serve_lm(lm, prompts, steps)
    flash_launches = flash_attention.launches
    routes = dict(flash_attention.route_launches)
    with swapped_cfg(lm, attn_impl="blockwise"):
        res_b = serve_lm(lm, prompts, steps, feed=res_f.fed)
    if flash_launches != cfg.n_layers or routes[route] != cfg.n_layers or \
            flash_attention.launches != flash_launches:
        raise AssertionError(f"agreement runs launched flash_attention "
                             f"{flash_launches} ({routes}) then "
                             f"{flash_attention.launches - flash_launches} "
                             f"times; expected {cfg.n_layers} on {route} "
                             f"then 0")
    if not all(bool(torch.isfinite(lg).all())
               for lg in res_f.logits + res_b.logits):
        raise AssertionError(f"agreement run ({cfg.name}, {dtype}): "
                             f"non-finite logits")
    largest = max(float(lg.abs().max()) for lg in res_f.logits)
    diffs = [float((a - b).abs().max())
             for a, b in zip(res_f.logits, res_b.logits)]
    if dtype == "float32" and max(diffs) > 1e-3 * largest:
        raise AssertionError(f"{cfg.name}: flash vs blockwise logits differ "
                             f"by {max(diffs)} > 1e-3 x {largest}")
    emit("serve_agreement", arch=cfg.name, n_layers=cfg.n_layers,
         dtype=dtype, flash_route=route, gated=dtype == "float32",
         steps=steps, largest_logit=largest, max_abs_diff_per_step=diffs,
         max_rel_diff=max(diffs) / largest,
         same_greedy_tokens=bool(torch.equal(res_f.tokens, res_b.tokens)),
         greedy_tokens_equal_share=float(
             (res_f.tokens == res_b.tokens).float().mean()),
         flash_prefill_s=res_f.prefill_s, blockwise_prefill_s=res_b.prefill_s)


def serve_agreement_phase(torch, dtype):
    """hymba_1_5b at its published widths in ``dtype``: flash against
    blockwise prefill (``flash_agreement``) on seeded weights and
    prompts."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    dev = torch.device("cuda", 0)
    cfg = get_config("hymba_1_5b").replace(dtype=dtype)
    lm = LM(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    flash_agreement(torch, lm, serve_prompts(torch, cfg.vocab))


def _cache_bytes(lm, batch, window):
    return sum(math.prod(shape) * dt.itemsize
               for shape, dt in lm.cache_shapes(batch, window).values())


def kv_quant_phase(torch, lm, prompts, res):
    """The int8 KV cache on the MoE main path's weights: ``quantize_kv`` on
    the card bit-identical to the CPU's on the same [4,2048,16,128] bf16
    input; a prefill's cache int8 with f32 scales; then the served run
    again with ``kv_quant=True``, fed the bf16-cache run's tokens, each
    step's softmax within total variation 0.05 of the bf16-cache run's
    (the reference's bound, tests/test_scale_features.py). Reports both
    caches' bytes, the greedy-token agreement and the flash launches."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models.layers import quantize_kv
    dev = torch.device("cuda", 0)
    cfg = lm.cfg
    kvh, hd = lm.plan.kv_virtual, cfg.head_dim
    x = (torch.randn((SERVE_BATCH, SERVE_PROMPT, kvh, hd), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(4))
         * 3).to(torch.bfloat16)
    q_dev, s_dev = quantize_kv(x)
    q_cpu, s_cpu = quantize_kv(x.cpu())
    if not (torch.equal(q_dev.cpu(), q_cpu) and torch.equal(s_dev.cpu(),
                                                            s_cpu)):
        raise AssertionError("quantize_kv on the card differs from the CPU")
    del x, q_dev, s_dev, q_cpu, s_cpu
    with swapped_cfg(lm, kv_quant=True):
        _, cache = lm.prefill_with_cache(prompts[:1, :64])
        kinds = {k: str(v.dtype)[6:] for k, v in cache.items()}
        if kinds != {"k": "int8", "v": "int8", "k_scale": "float32",
                     "v_scale": "float32", "pos": "int32"}:
            raise AssertionError(f"kv_quant cache leaves {kinds}")
        del cache
        launches0 = flash_attention.launches
        torch.cuda.reset_peak_memory_stats()
        res_q = serve_lm(lm, prompts, SERVE_STEPS, feed=res.fed)
        peak_q = torch.cuda.max_memory_allocated()
        bytes_q = _cache_bytes(lm, SERVE_BATCH, SERVE_PROMPT)
    bytes_f = _cache_bytes(lm, SERVE_BATCH, SERVE_PROMPT)
    flash_q = flash_attention.launches - launches0
    tvs = []
    for lf, lq in zip(res.logits, res_q.logits):
        pf = torch.softmax(lf[:, 0, :cfg.vocab], -1)
        pq = torch.softmax(lq[:, 0, :cfg.vocab], -1)
        tvs.append(float((pf - pq).abs().sum(-1).max()) / 2)
    if not all(bool(torch.isfinite(lg).all()) for lg in res_q.logits):
        raise AssertionError("kv_quant run: non-finite logits")
    if max(tvs) >= 0.05:
        raise AssertionError(f"int8 KV decode diverged: TV per step {tvs}")
    if flash_q != cfg.n_layers:
        raise AssertionError(f"kv_quant prefill launched flash {flash_q} "
                             f"times, expected {cfg.n_layers}")
    emit("kv_quant", arch=cfg.name, dtype=cfg.dtype, steps=SERVE_STEPS,
         quantize_kv_bit_identical_to_cpu=True, cache_leaves=kinds,
         tv_per_step=tvs, max_tv=max(tvs), tv_bound=0.05,
         greedy_tokens_equal_share=float(
             (res_q.tokens == res.tokens).float().mean()),
         cache_bytes_bf16=bytes_f, cache_bytes_int8=bytes_q,
         max_memory_allocated=peak_q, flash_launches=flash_q,
         prefill_s=res_q.prefill_s,
         decode_tokens_per_s=SERVE_BATCH * SERVE_STEPS / res_q.decode_s,
         bf16_cache_decode_tokens_per_s=SERVE_BATCH * SERVE_STEPS
         / res.decode_s)


def _ties(probs, k):
    """Tokens whose top k+1 router probabilities hold two equal values,
    and those where the tie straddles the k-th place."""
    top = probs.sort(dim=-1, descending=True).values[..., :k + 1]
    eq = top[..., :-1] == top[..., 1:]
    return int(eq.any(-1).sum()), int(eq[..., k - 1].sum())


def moe_layer_parity(torch, lm):
    """One full-width MoE layer in f32 on the card: the expert weights of
    the served model's layer 0 (cast to f32), a router and 4 x 2048 tokens
    on an exact grid (multiples of 2^-12 and of 1/4; every router logit is
    then exact in f32 in any order of summation, so the card and the CPU
    see the same logits and their routing must be identical; equal logits,
    hence top-k ties, occur and are counted). Gates: moe_einsum and
    moe_sort within 2e-4 of each other (the reference's own tolerance,
    tests/test_models.py), the card's top-k indices, gates and keep mask
    equal to the same call on the CPU, and the card's moe_einsum within
    2e-4 of the CPU's."""
    from repro_torch.models import layers
    dev = torch.device("cuda", 0)
    cfg = lm.cfg.replace(dtype="float32")
    e, d = cfg.n_experts, cfg.d_model
    w = lm._layers()[0]["moe"]
    p = {k: w[k].float() for k in ("w_gate", "w_up", "w_down")}
    p["shared"] = {k: v.float() for k, v in w["shared"].items()}
    gen = torch.Generator(device=dev).manual_seed(6)
    p["router"] = torch.randint(-128, 128, (d, e), generator=gen,
                                device=dev).float() / 4096
    x = torch.randint(-8, 9, (SERVE_BATCH, SERVE_PROMPT, d), generator=gen,
                      device=dev).float() / 4
    t0 = time.perf_counter()
    o_e, a_e = layers.moe_einsum(cfg, p, x)
    torch.cuda.synchronize()
    einsum_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    o_s, a_s = layers.moe_sort(cfg, p, x)
    torch.cuda.synchronize()
    sort_s = time.perf_counter() - t0
    err_es, ok_es = _close(o_s, o_e, 2e-4, 2e-4)
    aux_ok = abs(float(a_s) - float(a_e)) <= 1e-5 * abs(float(a_e))
    _, probs, gate, idx, cap = layers._route(cfg, p, x)
    keep = layers._slots(idx, e, cap)[2]
    pc = {k: (v.cpu() if not isinstance(v, dict)
              else {kk: vv.cpu() for kk, vv in v.items()})
          for k, v in p.items()}
    xc = x.cpu()
    _, probs_c, gate_c, idx_c, _ = layers._route(cfg, pc, xc)
    keep_c = layers._slots(idx_c, e, cap)[2]
    t0 = time.perf_counter()
    o_c, a_c = layers.moe_einsum(cfg, pc, xc)
    cpu_s = time.perf_counter() - t0
    err_c, ok_c = _close(o_e.cpu(), o_c, 2e-4, 2e-4)
    same_idx = bool(torch.equal(idx.cpu(), idx_c))
    same_keep = bool(torch.equal(keep.cpu(), keep_c))
    gate_err = float((gate.cpu() - gate_c).abs().max())
    ties, ties_at_k = _ties(probs, cfg.top_k)
    row = dict(arch=lm.cfg.name, tokens=SERVE_BATCH * SERVE_PROMPT,
               groups=idx.shape[0], capacity=cap,
               dropped_share=float(1 - keep.float().mean()),
               einsum_vs_sort_max_abs_err=err_es,
               aux_einsum=float(a_e), aux_sort=float(a_s),
               aux_cpu=float(a_c), card_vs_cpu_max_abs_err=err_c,
               same_topk_as_cpu=same_idx, same_keep_as_cpu=same_keep,
               gate_max_abs_diff_vs_cpu=gate_err, topk_tie_tokens=ties,
               topk_ties_at_kth=ties_at_k,
               topk_tie_tokens_cpu=_ties(probs_c, cfg.top_k)[0],
               max_abs_out=float(o_e.abs().max()), tolerance=2e-4,
               einsum_s=einsum_s, sort_s=sort_s, cpu_einsum_s=cpu_s)
    emit("moe_layer_parity", **row)
    if not (ok_es and aux_ok and ok_c and same_idx and same_keep
            and gate_err <= 1e-6 and torch.isfinite(o_e).all()):
        raise AssertionError(f"moe layer parity failed: {row}")


def moe_f32_agreement_phase(torch):
    """deepseek_moe_16b at its published widths cut to 4 layers, in f32
    (the SIMT flash kernel): flash against blockwise prefill on one set of
    seeded weights, gated at 1e-3 of the largest logit."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    dev = torch.device("cuda", 0)
    cfg = get_config("deepseek_moe_16b").replace(dtype="float32", n_layers=4)
    lm = LM(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    flash_agreement(torch, lm, serve_prompts(torch, cfg.vocab))


def sharded_chain_phase(torch):
    """portfolio.sharded_chain_batch on [cuda:0] (the machine has one
    card): one [B, V+1] bool block on cuda:0, equal to the CPU's draw."""
    from repro_torch.core.sat.portfolio import sharded_chain_batch
    dev = torch.device("cuda", 0)
    n_vars, b = 384, 24
    (blk,) = sharded_chain_batch(n_vars, b, seed=0, devices=[dev])
    (cpu,) = sharded_chain_batch(n_vars, b, seed=0, devices=["cpu"])
    ok = (tuple(blk.shape) == (b, n_vars + 1) and blk.dtype == torch.bool
          and blk.device == dev and torch.equal(blk.cpu(), cpu))
    emit("sharded_chain_batch", devices=[str(dev)], shape=list(blk.shape),
         dtype=str(blk.dtype), device=str(blk.device),
         equal_to_cpu_draw=bool(torch.equal(blk.cpu(), cpu)),
         true_share=float(blk.float().mean()))
    if not ok:
        raise AssertionError("sharded_chain_batch on cuda:0: wrong block")


class _LineClock(io.TextIOBase):
    """A stdout for ``train_loop`` that keeps each line it prints with the
    host time it was printed at. The loop prints a step's line after it
    reads the step's loss back, which waits for the whole step on the
    device, so the gaps between lines are the steps' wall times."""

    def __init__(self):
        super().__init__()
        self.lines = []
        self._buf = ""

    def writable(self):
        return True

    def write(self, text):
        now = time.perf_counter()
        self._buf += text
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((now, line))
        return len(text)


def train_model_flops(cfg, batch, tokens):
    """Model FLOPs of one training step, reckoned from the config: 6·N per
    token (forward and backward of every parameter), 2·N more for the
    remat forward, and attention at 4·D flops per visible (query, key)
    pair per head, four times (forward, remat forward, backward twice)."""
    from repro_torch.models.model import param_shapes
    n = sum(math.prod(shape) for shape, _ in param_shapes(cfg).values())
    w = cfg.attn_window or tokens
    pairs = sum(min(i + 1, w) for i in range(tokens))
    attn = 4 * 4 * cfg.head_dim * pairs * cfg.n_heads * batch * cfg.n_layers
    return n, {"params_6NT": 6 * n * batch * tokens,
               "remat_forward_2NT": 2 * n * batch * tokens,
               "attention": attn}


def _leaves(*trees):
    out = []
    for tree in trees:
        for v in tree.values():
            out += _leaves(v) if isinstance(v, dict) else [v]
    return out


def train_main_phase(torch, smi):
    """The main path of training: ``train_loop`` on hymba_1_5b at its
    published widths (bf16, remat, blockwise attention, seeded weights)
    for 6 steps of SyntheticLM(seed=0) at 4 x 4096 tokens. Gates: every
    step's loss finite, the AdamW step 6, every leaf updated, no kernel
    of the port launched, every tensor of the state on the card. Then one
    more step under torch.profiler. Returns the kernels' launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import reset_counts
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train_loop
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamWConfig, lr_at
    dev = torch.device("cuda", 0)
    cfg = get_config(TRAIN_ARCH)
    if not cfg.remat or cfg.attn_impl != "blockwise":
        raise AssertionError(f"{cfg.name} trains with remat and blockwise "
                             f"attention; got {cfg.remat}, {cfg.attn_impl}")
    tokens = TRAIN_SEQ - 1                  # inputs [:, :-1], labels [:, 1:]
    n_params, flops = train_model_flops(cfg, TRAIN_BATCH, tokens)
    if n_params != TRAIN_PARAMS:
        raise AssertionError(f"{cfg.name}: {n_params} parameters, expected "
                             f"{TRAIN_PARAMS}")
    counters = _counters()
    for f in counters.values():
        f.launches = 0
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clock = _LineClock()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(clock):
        out = train_loop(cfg, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                         seq_len=TRAIN_SEQ, seed=0, device=dev, log_every=1)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {name: f.launches for name, f in counters.items()}
    losses = [float(ln.split("loss=")[1].split()[0]) for _, ln in clock.lines]
    times = [t0] + [t for t, _ in clock.lines]
    step_s = [b - a for a, b in zip(times, times[1:])]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)) \
            or not math.isfinite(out["loss"]):
        raise AssertionError(f"{cfg.name} training: losses {losses}, final "
                             f"{out['loss']}")
    if any(launches.values()):
        raise AssertionError(f"the training path launched kernels of the "
                             f"port: {launches}")
    params, opt = out.pop("params"), out.pop("opt_state")
    if int(opt["step"]) != TRAIN_STEPS:
        raise AssertionError(f"AdamW step {int(opt['step'])}, expected "
                             f"{TRAIN_STEPS}")
    off = [str(t.device) for t in _leaves(params, opt)
           if t.device != dev]
    if off:
        raise AssertionError(f"training state off the card: {off[:4]}")
    # every leaf updated: its first moment is finite and not zero, and it
    # changed, or (a bf16 leaf that starts at 1.0, as norms do) its last
    # update lies below half a bf16 ulp of every element, as the reference
    # would round it too
    init = LM(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    ocfg = AdamWConfig()
    lr = float(lr_at(ocfg, opt["step"] - 1))
    b1c = 1.0 - ocfg.b1 ** TRAIN_STEPS
    b2c = 1.0 - ocfg.b2 ** TRAIN_STEPS
    unchanged, stuck = {}, []
    for name, p0 in init.state_dict().items():
        p, m, v = params[name], opt["m"][name], opt["v"][name]
        if not (bool(torch.isfinite(m).all()) and bool(m.any())
                and bool(torch.isfinite(p).all())):
            stuck.append(name)
        elif torch.equal(p, p0):
            pf = p.float()
            upd = lr * ((m / b1c) / (torch.sqrt(v / b2c) + ocfg.eps)
                        + ocfg.weight_decay * pf)
            if not torch.equal((pf - upd).to(p.dtype), p):
                stuck.append(name)
            unchanged[name] = float(upd.abs().max())
    if stuck:
        raise AssertionError(f"leaves not updated: {stuck}")
    # one more step of the same shapes, timed and under the profiler
    init.load_state_dict(params)
    del params
    step = make_train_step(init)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        DataConfig(seed=0, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ),
        cfg).batch_at(TRAIN_STEPS).items()}
    prof = _profile(torch, lambda: step(opt, batch), "gemm")
    wall = statistics.median(step_s[1:])
    model_flops = sum(flops.values())
    emit("train", arch=cfg.name, nvidia_smi=smi, n_layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab, dtype=cfg.dtype,
         remat=cfg.remat, attn_impl=cfg.attn_impl, params=n_params,
         steps=TRAIN_STEPS, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
         tokens_per_step=TRAIN_BATCH * tokens,
         reduced={"global_batch": "256 (train_4k) -> 4, to fit one card"},
         losses=losses, final=out, adamw_step=int(opt["step"]),
         loop_s=loop_s, step_s=step_s, step_s_median_2_6=wall,
         tokens_per_s=TRAIN_BATCH * tokens / wall,
         max_memory_allocated=peak, launches=launches,
         unchanged_bf16_leaves_last_update=unchanged,
         model_flops=model_flops, model_flops_parts=flops,
         model_flops_share_of_bf16_peak=model_flops / wall
         / BF16_TENSOR_FLOPS,
         profiled_step={"device_busy_share": prof["device_ms"] / 1e3 / wall,
                        **prof})
    del init, opt, batch, step
    return launches, {"losses": losses, "step_s": step_s,
                      "max_memory_allocated": peak}


def train_grad_parity_phase(torch, smi):
    """One training step's loss and gradients on the card against the CPU:
    hymba_1_5b's widths cut to 2 layers, f32 (TF32 off), 2 x 256 tokens,
    the same weights and batch on both. Gates: the loss within 1e-5
    relative, every gradient leaf within 1e-3 of its largest magnitude.
    Returns the f32 LM on the card."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.model import LM
    dev = torch.device("cuda", 0)
    cfg = get_config(TRAIN_ARCH).replace(n_layers=GRAD_LAYERS,
                                         dtype="float32")
    cpu = LM(cfg, "cpu").init(torch.Generator().manual_seed(0))
    gpu = LM(cfg, dev)
    gpu.load_state_dict(cpu.state_dict())
    batch = SyntheticLM(DataConfig(seed=0, global_batch=GRAD_BATCH,
                                   seq_len=GRAD_TOKENS + 1), cfg).batch_at(0)
    t0 = time.perf_counter()
    loss_c, _, g_c = value_and_grad(cpu, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    loss_g, _, g_g = value_and_grad(gpu, {k: torch.from_numpy(v).to(dev)
                                          for k, v in batch.items()})
    rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    errs = {}
    for name, gc in g_c.items():
        scale = float(gc.abs().max())
        errs[name] = (float((g_g[name].cpu() - gc).abs().max()), scale)
    worst = max(errs, key=lambda k: errs[k][0] / max(errs[k][1], 1e-30))
    bad = [k for k, (e, sc) in errs.items() if not e <= GRAD_LEAF_TOL * sc]
    emit("train_grad_parity", arch=cfg.name, nvidia_smi=smi,
         reduced={"n_layers": f"{get_config(TRAIN_ARCH).n_layers} -> "
                              f"{GRAD_LAYERS}", "dtype": "float32"},
         batch=GRAD_BATCH, tokens=GRAD_TOKENS, loss_cuda=float(loss_g),
         loss_cpu=float(loss_c), loss_rel_err=rel, cpu_s=cpu_s,
         worst_leaf=worst, worst_leaf_max_abs_err=errs[worst][0],
         worst_leaf_max_abs=errs[worst][1], leaves=len(errs),
         tol={"loss_rel": GRAD_LOSS_RTOL, "leaf": GRAD_LEAF_TOL})
    if not rel <= GRAD_LOSS_RTOL or bad:
        raise AssertionError(f"card vs CPU: loss rel err {rel}, leaves over "
                             f"{GRAD_LEAF_TOL} of their largest magnitude: "
                             f"{bad}")
    return gpu


def train_resume_phase(torch, smi):
    """Crash and resume on the card: hymba_1_5b's widths cut to 2 layers
    (bf16), 6 steps of 4 x 512 tokens, a checkpoint every 2 steps, a crash
    injected at step 4 and a --resume, against the same 6 steps run
    uninterrupted. Gate: params and AdamW state bit-identical and the final
    loss equal (the reference's contract). Also times a checkpoint's save
    and restore. Its files live under build/chip_smoke_train."""
    import shutil
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    dev = torch.device("cuda", 0)
    cfg = get_config(TRAIN_ARCH).replace(n_layers=RESUME_LAYERS)
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke_train")
    shutil.rmtree(base, ignore_errors=True)
    kw = dict(RESUME, device=dev, log_every=0)
    try:
        crashed = os.path.join(base, "crashed")
        try:
            train_loop(cfg, ckpt_dir=crashed, fail_at=RESUME_FAIL_AT, **kw)
            raise AssertionError("fail_at did not raise")
        except RuntimeError as e:
            if str(e) != f"injected failure at step {RESUME_FAIL_AT}":
                raise
        with contextlib.redirect_stdout(io.StringIO()) as said:
            resumed = train_loop(cfg, ckpt_dir=crashed, resume=True, **kw)
        shutil.rmtree(crashed)
        straight = train_loop(cfg, ckpt_dir=os.path.join(base, "straight"),
                              **kw)
        differ = [k for k, t in straight["params"].items()
                  if not torch.equal(resumed["params"][k], t)]
        o1, o2 = resumed["opt_state"], straight["opt_state"]
        differ += [f"{part}/{k}" for part in ("m", "v")
                   for k, t in o2[part].items()
                   if not torch.equal(o1[part][k], t)]
        if not torch.equal(o1["step"], o2["step"]):
            differ.append("step")
        final_equal = resumed["loss"] == straight["loss"]
        tree = {"params": straight["params"], "opt": o2}
        d = os.path.join(base, "timed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ckpt.save(d, RESUME["steps"], tree)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        t0 = time.perf_counter()
        back, _ = ckpt.restore(d, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        emit("train_resume", arch=cfg.name, nvidia_smi=smi,
             reduced={"n_layers": f"{get_config(TRAIN_ARCH).n_layers} -> "
                                  f"{RESUME_LAYERS}"},
             dtype=cfg.dtype, **RESUME, fail_at=RESUME_FAIL_AT,
             resumed_said=said.getvalue().strip(),
             adamw_step=int(o2["step"]), final_loss_resumed=resumed["loss"],
             final_loss_straight=straight["loss"], final_loss_equal=final_equal,
             leaves_differing=differ, checkpoint_bytes=nbytes,
             checkpoint_save_s=save_s, checkpoint_restore_s=restore_s)
        if differ or not final_equal or int(o2["step"]) != RESUME["steps"]:
            raise AssertionError(f"resume is not bit-identical: {differ[:8]}, "
                                 f"final loss equal {final_equal}")
        del back
    finally:
        shutil.rmtree(base, ignore_errors=True)


def train_flash_refusal_phase(torch, smi, lm):
    """The flash repair on the card: a training step of ``lm`` with
    attn_impl="flash" raises the named error, before any launch."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.steps import value_and_grad
    dev = torch.device("cuda", 0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        DataConfig(seed=0, global_batch=1, seq_len=65), lm.cfg
    ).batch_at(0).items()}
    before = flash_attention.launches
    with swapped_cfg(lm, attn_impl="flash"):
        try:
            value_and_grad(lm, batch)
        except NotImplementedError as e:
            message = str(e)
        else:
            raise AssertionError("flash_attention under autograd did not "
                                 "raise")
    if "blockwise" not in message or flash_attention.launches != before:
        raise AssertionError(f"flash under autograd: {message!r}, "
                             f"{flash_attention.launches - before} launches")
    emit("train_flash_refusal", nvidia_smi=smi, raised="NotImplementedError",
         message=message, launches=flash_attention.launches - before)


def train_phase(torch, smi):
    """Training on the card: the main path, card vs CPU gradients, crash
    and resume, and flash refusing autograd. Returns the kernels' launch
    counts on the main path (all zero) and the main path's losses, step
    seconds and peak memory."""
    launches, summary = train_main_phase(torch, smi)
    torch.cuda.empty_cache()
    lm = train_grad_parity_phase(torch, smi)
    train_flash_refusal_phase(torch, smi, lm)
    del lm
    torch.cuda.empty_cache()
    train_resume_phase(torch, smi)
    torch.cuda.empty_cache()
    return launches, summary


# ---------------------------------------------------------- host world
def _planted(lm, leaves, victim):
    """``lm.prefill_with_cache`` with a planted fault: after the prefill
    rank ``victim`` zeroes its shard of each cache leaf in ``leaves``."""
    import torch.distributed as dist
    real = type(lm).prefill_with_cache

    def prefill_with_cache(*args, **kwargs):
        lg, cache = real(lm, *args, **kwargs)
        if dist.get_rank() == victim:
            for leaf in leaves:
                cache[leaf]._local_tensor.zero_()
        return lg, cache

    return prefill_with_cache


def _fed_tv(got, want, vocab):
    """Per step, the largest total variation over the rows between the
    softmaxes of two runs' logits fed the same tokens, and the rows whose
    argmax agree."""
    import torch
    tvs, same = [], 0
    for g, w in zip(got, want):
        pg = torch.softmax(g[:, 0, :vocab], -1)
        pw = torch.softmax(w[:, 0, :vocab], -1)
        tvs.append(float((pg - pw).abs().sum(-1).max()) / 2)
        same += int((pg.argmax(-1) == pw.argmax(-1)).sum())
    return tvs, same


def host_mesh_rank(ckpt_dir, fed, one_row_fed, small_batch):
    """One rank of the host world (a spawned process; every rank runs
    this). Trains hymba_1_5b at its published widths for HOST_STEPS steps
    of ``train_loop(mesh=)`` at the train phase's 4 x 4096 (replicated
    over ranks that do not divide 4), its log lines timed; restores the
    run's checkpoint on the plain path (a one-device LM and AdamW state on
    this rank's card, rank 0) and holds every leaf to the mesh run's, bit
    for bit; trains HOST_SMALL_STEPS steps at ``small_batch`` rows, its
    log lines timed; then serves the serve phase's prompts through
    ``serve_lm`` on the partitioned LM (flash prefill, 32 greedy steps),
    the kernels' launches counted; then fed ``fed`` (the serve phase's
    tokens), its logits returned; then row 0 of the prompts alone for
    ONE_ROW_STEPS steps, the launches counted, and fed ``one_row_fed``;
    and, fed ``fed``, once for
    each planted fault (:func:`_planted`) for HOST_FAULT_STEPS steps.
    Rank 0 returns what it saw, the others None."""
    import shutil
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import reset_counts
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.serve import serve_lm
    from repro_torch.launch.train import _dotted, train_loop
    from repro_torch.models.model import LM
    # the parent's settings: f32 products in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with mesh_mod.host_world() as dm:
        rank = dist.get_rank()
        dev = mesh_mod.mesh_device(dm)
        cfg = get_config(TRAIN_ARCH)
        out = {"mesh": list(dm.shape), "world": dist.get_world_size(),
               "backend": dist.get_backend(), "device": str(dev),
               "card": torch.cuda.get_device_name(dev)}
        counters = _counters()
        for f in counters.values():
            f.launches = 0
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        clock = _LineClock()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(clock):
            res = train_loop(cfg, steps=HOST_STEPS, global_batch=TRAIN_BATCH,
                             seq_len=TRAIN_SEQ, seed=0, mesh=dm, log_every=1,
                             ckpt_dir=ckpt_dir, ckpt_every=HOST_STEPS + 1)
        torch.cuda.synchronize(dev)
        loop_s = time.perf_counter() - t0
        times = [t0] + [t for t, _ in clock.lines]
        out.update(
            train_launches={n: f.launches for n, f in counters.items()},
            losses=[float(ln.split("loss=")[1].split()[0])
                    for _, ln in clock.lines],
            step_s=[b - a for a, b in zip(times, times[1:])],
            loop_s=loop_s, checkpoint_save_s=(t0 + loop_s - times[-1]
                                              if rank == 0 else None),
            final_loss=res["loss"], final_grad_norm=res["grad_norm"],
            max_memory_allocated=torch.cuda.max_memory_allocated(dev))
        # the mesh run's checkpoint restored on the plain path, every leaf
        # gathered from the mesh (a collective) and held by rank 0
        t0 = time.perf_counter()
        if rank == 0:
            state, manifest = ckpt.restore(ckpt_dir, device=dev)
            plain = LM(cfg, dev)
            plain.load_state_dict(_dotted(state["params"]))
            want = {"params": plain.state_dict(),
                    "m": _dotted(state["opt"]["m"]),
                    "v": _dotted(state["opt"]["v"]),
                    "step": {"step": state["opt"]["step"]}}
            out["manifest_mesh"] = manifest["extra"]["mesh"]
        got = {"params": res["params"], "m": res["opt_state"]["m"],
               "v": res["opt_state"]["v"],
               "step": {"step": res["opt_state"]["step"]}}
        differ, n = [], 0
        for part, leaves in got.items():
            for k, t in leaves.items():
                t = t.full_tensor()
                if rank == 0:
                    n += 1
                    if not torch.equal(t, want[part][k]):
                        differ.append(f"{part}/{k}")
                del t
        out.update(restored_leaves=n, restored_differ=differ,
                   restore_check_s=time.perf_counter() - t0)
        del res, got
        if rank == 0:
            del state, plain, want
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        torch.cuda.empty_cache()
        # a batch of one row on one rank, or one the ranks do not divide
        torch.cuda.reset_peak_memory_stats(dev)
        clock = _LineClock()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(clock):
            res = train_loop(cfg, steps=HOST_SMALL_STEPS,
                             global_batch=small_batch, seq_len=TRAIN_SEQ,
                             seed=0, mesh=dm, log_every=1)
        torch.cuda.synchronize(dev)
        times = [t0] + [t for t, _ in clock.lines]
        out.update(small=_small_run(res, clock),
                   small_step_s=[b - a for a, b in zip(times, times[1:])],
                   small_max_memory_allocated=torch.cuda.max_memory_allocated(
                       dev))
        del res
        torch.cuda.empty_cache()
        # serving: the serve phase's LM (seed 0, flash) and prompts
        scfg = cfg.replace(attn_impl="flash")
        lm = LM(scfg, dev, mesh=dm).init(
            torch.Generator(device=dev).manual_seed(0))

        def prompts(seed):
            return torch.randint(0, scfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                                 generator=torch.Generator(
                                     device=dev).manual_seed(seed),
                                 device=dev)

        def layout(b):
            # the LM's layout of a batch of b rows, train_loop's too (its
            # batches go through LM.rows, the same rule)
            pl = lm.split_rows(torch.zeros((b, 1), device=dev)).placements
            return "split" if any(p.is_shard(0) for p in pl) \
                else "replicated"
        out.update(batch_layout=layout(TRAIN_BATCH),
                   small_batch_layout=layout(small_batch))
        # warm-up as the serve phase's
        serve_lm(lm, prompts(2)[:1, :256], 2)
        torch.cuda.reset_peak_memory_stats(dev)
        for f in counters.values():
            f.launches = 0
        reset_counts()
        sres = serve_lm(lm, prompts(1), SERVE_STEPS)
        flash = counters["flash_attention"]
        out.update(serve_launches={n: f.launches for n, f in counters.items()},
                   flash_route_launches=dict(flash.route_launches),
                   tokens=sres.tokens.cpu().tolist(),
                   logits_finite=all(bool(torch.isfinite(lg).all())
                                     for lg in sres.logits),
                   prefill_s=sres.prefill_s, decode_s=sres.decode_s,
                   serve_max_memory_allocated=torch.cuda.max_memory_allocated(
                       dev))
        # each rank's GEMMs see its rows alone, and the partitioned LM's
        # prefill SSD is ssd_chunked where the plain path's is ssd_scan,
        # so bf16 rounds otherwise than there: the logits fed the same
        # tokens
        forced = serve_lm(lm, prompts(1), SERVE_STEPS,
                          feed=torch.tensor(fed, device=dev))
        out["forced_logits"] = [lg.cpu() for lg in forced.logits]
        del forced
        # a batch of one: row 0 of the same prompts
        torch.cuda.reset_peak_memory_stats(dev)
        for f in counters.values():
            f.launches = 0
        reset_counts()
        one = serve_lm(lm, prompts(1)[:1], ONE_ROW_STEPS)
        out.update(one_row_launches={n: f.launches
                                     for n, f in counters.items()},
                   one_row_flash_route_launches=dict(flash.route_launches),
                   one_row_tokens=one.tokens.cpu().tolist(),
                   one_row_logits_finite=all(
                       bool(torch.isfinite(lg).all()) for lg in one.logits),
                   one_row_prefill_s=one.prefill_s,
                   one_row_decode_s=one.decode_s,
                   one_row_max_memory_allocated=torch.cuda
                   .max_memory_allocated(dev))
        forced = serve_lm(lm, prompts(1)[:1], ONE_ROW_STEPS,
                          feed=torch.tensor(one_row_fed, device=dev))
        out["one_row_forced_logits"] = [lg.cpu() for lg in forced.logits]
        del forced
        fault_feed = torch.tensor(fed, device=dev)[:, :HOST_FAULT_STEPS]
        out["fault_logits"] = {}
        # the last rank's rows where the prompts are split over the
        # ranks; rank 0's copy, the one gathered, where they are
        # replicated
        split = SERVE_BATCH % dist.get_world_size() == 0
        out["fault_rank"] = dist.get_world_size() - 1 if split else 0
        for fault, leaves in HOST_FAULTS.items():
            lm.prefill_with_cache = _planted(lm, leaves, out["fault_rank"])
            try:
                bad = serve_lm(lm, prompts(1), HOST_FAULT_STEPS,
                               feed=fault_feed)
            finally:
                del lm.prefill_with_cache
            out["fault_logits"][fault] = [lg.cpu() for lg in bad.logits]
            del bad
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, [out["final_loss"],
                                       out["final_grad_norm"], out["tokens"],
                                       out["serve_launches"],
                                       # rank 0 alone prints the log
                                       {k: v for k, v in out["small"].items()
                                        if k not in LOG_UNITS},
                                       out["one_row_tokens"],
                                       out["one_row_launches"]])
        out["every_rank"] = every
        del lm, sres, one
    return out if rank == 0 else None


def host_mesh_phase(torch, smi, train, served):
    """The reference's host-mesh path: ``train_loop(mesh=)`` and
    ``serve_lm`` over every card of the machine, one rank a card over
    NCCL (a (1, 1) world on one card), the ranks started as the CLI
    starts them (``launch.mesh.launch``, torch's elastic launch API) in
    spawned processes, so no process group is ever up here. Gates: the
    world is NCCL over every card; each step's loss within
    HOST_LOSS_RTOL of the train phase's (``train``, same seed and
    batches); the checkpoint restored on the plain path equal to the
    mesh run's state bit for bit, its manifest the mesh's shape; one
    flash launch a layer on the tensor cores; the run fed the serve
    phase's tokens (``served``) has each step's softmax within HOST_TV
    of it (each rank's GEMMs see its rows alone, and the partitioned
    LM's prefill SSD is ``ssd_chunked`` where the serve phase's is
    ``ssd_scan``, so the tokens themselves may differ); on one card the
    served tokens equal the plain path's run on the partitioned LM's SSD
    route (``served["chunked_tokens"]``, :func:`chunked_served`); the
    planted lost cache shard reads above HOST_TV; the ranks agree; no
    group
    up here after. Prints step seconds, peak memory, prefill and decode
    seconds beside the plain path's. A card count that does not divide
    the train phase's 4 rows trains them replicated, as the reference's
    spec lays them out. Then the batches of ``host_mesh_batches``: one or
    two rows trained (:func:`host_small_plain` is the plain run they are
    held to), and one row served, held to ``served["one_row"]`` as the
    four rows are to ``served``. Returns the kernels' launch counts of
    the served run of four rows and of one."""
    import shutil
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_mod
    n_cards = torch.cuda.device_count()
    small_batch = HOST_SMALL_BATCH[n_cards > 1]
    small = host_small_plain(torch, small_batch)
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_host_mesh")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = mesh_mod.launch(host_mesh_rank,
                                (ckpt_dir, served["fed"],
                                 served["one_row"]["fed"], small_batch),
                                n_ranks=n_cards)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    wall_s = time.perf_counter() - t0
    out = ranks[0]
    cfg = get_config(TRAIN_ARCH)
    want_losses = train["losses"][:HOST_STEPS]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(out["losses"],
                                                   want_losses)]
    flash = out["serve_launches"]["flash_attention"]
    routes = out["flash_route_launches"]
    tokens_equal = out["tokens"] == served["tokens"]
    chunked_equal = out["tokens"] == served["chunked_tokens"]
    same_tokens = sum(a == b for got, want in zip(out["tokens"],
                                                  served["tokens"])
                      for a, b in zip(got, want))
    tvs, forced_same = _fed_tv(out["forced_logits"], served["logits"],
                               cfg.vocab)
    fault_tv = {fault: _fed_tv(lgs, served["logits"], cfg.vocab)[0]
                for fault, lgs in out["fault_logits"].items()}
    same_on_every_rank = all(r == out["every_rank"][0]
                             for r in out["every_rank"])
    emit("host_mesh", nvidia_smi=smi, arch=cfg.name, cards=n_cards,
         world=out["world"], backend=out["backend"], mesh=out["mesh"],
         rank0_device=out["device"], launch_wall_s=wall_s,
         steps=HOST_STEPS, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
         batch_layout=out["batch_layout"],
         reduced={"global_batch": "256 (train_4k) -> 4, the train phase's "
                                  "cut"},
         losses=out["losses"], plain_losses=want_losses,
         loss_rel_err=loss_rel, loss_rtol=HOST_LOSS_RTOL,
         step_s=out["step_s"], plain_step_s=train["step_s"][:HOST_STEPS],
         loop_s=out["loop_s"], checkpoint_save_s=out["checkpoint_save_s"],
         max_memory_allocated=out["max_memory_allocated"],
         plain_max_memory_allocated=train["max_memory_allocated"],
         train_launches=out["train_launches"],
         manifest_mesh=out["manifest_mesh"],
         restored_leaves=out["restored_leaves"],
         restored_differ=out["restored_differ"],
         restore_check_s=out["restore_check_s"],
         prefill_s=out["prefill_s"], plain_prefill_s=served["prefill_s"],
         decode_s=out["decode_s"], plain_decode_s=served["decode_s"],
         decode_tokens_per_s=SERVE_BATCH * SERVE_STEPS / out["decode_s"],
         serve_max_memory_allocated=out["serve_max_memory_allocated"],
         plain_serve_max_memory_allocated=served["max_memory_allocated"],
         serve_launches=out["serve_launches"], flash_route_launches=routes,
         tokens_equal_serve_phase=tokens_equal,
         tokens_same_as_serve_phase=same_tokens,
         tokens_equal_plain_on_chunked=chunked_equal,
         tokens_served=SERVE_BATCH * SERVE_STEPS,
         fed_tv_per_step=tvs, fed_max_tv=max(tvs),
         fed_tv_bound=HOST_TV, fed_greedy_same=forced_same,
         fault_tv_per_step=fault_tv,
         fault_max_tv={k: max(v) for k, v in fault_tv.items()},
         fault_gated=HOST_FAULT_GATED, fault_rank=out["fault_rank"],
         same_on_every_rank=same_on_every_rank,
         group_up_here=dist.is_available() and dist.is_initialized())
    fails = []
    if out["backend"] != "nccl" or out["world"] != n_cards or \
            out["mesh"] != [n_cards, 1]:
        fails.append(f"world {out['backend']} x {out['world']} on "
                     f"{out['mesh']}, expected nccl over {n_cards} cards")
    if len(out["losses"]) != HOST_STEPS or max(loss_rel) > HOST_LOSS_RTOL:
        fails.append(f"losses {out['losses']} against {want_losses}")
    if out["restored_differ"] or out["manifest_mesh"] != out["mesh"]:
        fails.append(f"restore differs in {out['restored_differ'][:8]}, "
                     f"manifest mesh {out['manifest_mesh']}")
    if not out["logits_finite"]:
        fails.append("non-finite served logits")
    if n_cards == 1 and not chunked_equal:
        fails.append("served tokens differ from the plain path's on the "
                     "same SSD route (ssd_chunked)")
    if not max(tvs) < HOST_TV:
        fails.append(f"fed the serve phase's tokens, the softmax is {tvs} "
                     f"from it (total variation)")
    if not max(fault_tv[HOST_FAULT_GATED]) > HOST_TV:
        fails.append(f"the planted fault {HOST_FAULT_GATED!r} reads "
                     f"{max(fault_tv[HOST_FAULT_GATED])}, not above the "
                     f"bound {HOST_TV}")
    if flash != cfg.n_layers or routes.get("tensor_core") != cfg.n_layers:
        fails.append(f"flash launched {flash} times ({routes}), expected "
                     f"{cfg.n_layers} on the tensor cores")
    if not same_on_every_rank:
        fails.append("the ranks disagree")
    if dist.is_available() and dist.is_initialized():
        fails.append("a process group is up in the smoke's process")
    if fails:
        raise AssertionError("host_mesh: " + "; ".join(fails))
    return out["serve_launches"], host_mesh_batches(
        cfg, n_cards, out, small, served["one_row"])


def host_small_plain(torch, batch):
    """The plain run that the host world's small batch is held to:
    HOST_SMALL_STEPS steps of one-device ``train_loop`` at ``batch`` rows
    of TRAIN_SEQ tokens on cuda:0, the train phase's seed, its log lines
    timed (the first gap holds the LM's init). Returns what
    :func:`_small_run` reads of it, the step seconds and peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    dev = torch.device("cuda", 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clock = _LineClock()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(clock):
        res = train_loop(get_config(TRAIN_ARCH), steps=HOST_SMALL_STEPS,
                         global_batch=batch, seq_len=TRAIN_SEQ, seed=0,
                         device=dev, log_every=1)
    torch.cuda.synchronize()
    times = [t0] + [t for t, _ in clock.lines]
    out = {**_small_run(res, clock),
           "step_s": [b - a for a, b in zip(times, times[1:])],
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del res
    torch.cuda.empty_cache()
    return out


def _small_run(res, clock):
    """What the small run is gated on: each step's loss and grad norm as
    the log printed them (``clock``), the last step's at full precision
    (``res``, ``train_loop``'s return), and the fingerprints of its AdamW
    moments: sum of m^2 and sum of v over every leaf, in f64 (on a mesh
    each leaf is gathered, a collective: every rank calls this)."""
    fp = {"m_sq": 0.0, "v_sum": 0.0}
    for part, key in (("m", "m_sq"), ("v", "v_sum")):
        for _, t in sorted(res["opt_state"][part].items()):
            if hasattr(t, "full_tensor"):
                t = t.full_tensor()
            t = t.double()
            fp[key] += float(t.square().sum() if part == "m" else t.sum())
            del t
    return {"losses": [float(ln.split("loss=")[1].split()[0])
                       for _, ln in clock.lines],
            "grad_norms": [float(ln.split("gnorm=")[1].split()[0])
                           for _, ln in clock.lines],
            "final_loss": res["loss"], "final_grad_norm": res["grad_norm"],
            **fp}


def host_mesh_batches(cfg, n_cards, out, small, one_row):
    """Gates and prints the host world's batches that the reference's
    spec replicates (``host_mesh_rank``'s small batch and row): each
    step's logged loss and grad norm within LOG_UNITS of the plain run's
    (``small``), the last step's loss within HOST_SMALL_LOSS_RTOL and its
    grad norm and moments' fingerprints within HOST_SMALL_STATE_RTOL;
    one flash launch a layer on the tensor cores for the row; the run fed
    the tokens of the plain path's run of the row (``one_row``) within
    HOST_TV of it; on one card the row's tokens equal the plain path's
    run of it on the partitioned LM's SSD route
    (``one_row["chunked_tokens"]``) (the ranks' agreement on all of it
    is gated with ``host_mesh_phase``'s). Returns the kernels' launch
    counts of the served row."""
    got = out["small"]
    logged = {k: [abs(a - b) for a, b in zip(got[k], small[k])]
              for k in LOG_UNITS}
    rel = {k: abs(got[k] - small[k]) / abs(small[k])
           for k in ("final_loss", "final_grad_norm", "m_sq", "v_sum")}
    rtol = {"final_loss": HOST_SMALL_LOSS_RTOL,
            "final_grad_norm": HOST_SMALL_STATE_RTOL,
            "m_sq": HOST_SMALL_STATE_RTOL, "v_sum": HOST_SMALL_STATE_RTOL}
    flash = out["one_row_launches"]["flash_attention"]
    routes = out["one_row_flash_route_launches"]
    tokens_equal = out["one_row_tokens"] == one_row["tokens"]
    chunked_equal = out["one_row_tokens"] == one_row["chunked_tokens"]
    tvs, forced_same = _fed_tv(out["one_row_forced_logits"],
                               one_row["logits"], cfg.vocab)
    batch = HOST_SMALL_BATCH[n_cards > 1]
    emit("host_mesh_batches", arch=cfg.name, cards=n_cards,
         mesh=out["mesh"], train_global_batch=batch, seq_len=TRAIN_SEQ,
         train_layout=out["small_batch_layout"], steps=HOST_SMALL_STEPS,
         **{k: got[k] for k in got}, **{"plain_" + k: small[k] for k in got},
         logged_abs_err=logged, logged_tol=LOG_UNITS, rel_err=rel,
         rtol=rtol, step_s=out["small_step_s"],
         plain_step_s=small["step_s"],
         step_s_note="the first gap holds the LM's init and the data",
         max_memory_allocated=out["small_max_memory_allocated"],
         plain_max_memory_allocated=small["max_memory_allocated"],
         serve_batch=1, prompt_len=SERVE_PROMPT, decode_steps=ONE_ROW_STEPS,
         serve_launches=out["one_row_launches"],
         flash_route_launches=routes,
         prefill_s=out["one_row_prefill_s"],
         plain_prefill_s=one_row["prefill_s"],
         decode_s=out["one_row_decode_s"], plain_decode_s=one_row["decode_s"],
         serve_max_memory_allocated=out["one_row_max_memory_allocated"],
         plain_serve_max_memory_allocated=one_row["max_memory_allocated"],
         tokens=out["one_row_tokens"], plain_tokens=one_row["tokens"],
         tokens_equal_plain=tokens_equal,
         tokens_equal_plain_on_chunked=chunked_equal, fed_tv_per_step=tvs,
         fed_max_tv=max(tvs), fed_tv_bound=HOST_TV,
         fed_greedy_same=forced_same)
    fails = []
    for k, unit in LOG_UNITS.items():
        # one unit of the printed digit, and the float slack of its
        # difference
        if len(got[k]) != HOST_SMALL_STEPS or \
                max(logged[k]) > unit * (1 + 1e-6):
            fails.append(f"logged {k} at {batch} rows {got[k]} against "
                         f"{small[k]}")
    for k, tol in rtol.items():
        if not rel[k] <= tol:
            fails.append(f"{k} at {batch} rows {got[k]} against {small[k]} "
                         f"(relative {rel[k]}, tolerance {tol})")
    if not out["one_row_logits_finite"]:
        fails.append("non-finite served logits")
    if flash != cfg.n_layers or routes.get("tensor_core") != cfg.n_layers:
        fails.append(f"flash launched {flash} times ({routes}) for one row, "
                     f"expected {cfg.n_layers} on the tensor cores")
    if n_cards == 1 and not chunked_equal:
        fails.append("the row's tokens differ from the plain path's on the "
                     "same SSD route (ssd_chunked)")
    if not max(tvs) < HOST_TV:
        fails.append(f"fed the plain path's tokens, the row's softmax is "
                     f"{tvs} from it (total variation)")
    if fails:
        raise AssertionError("host_mesh_batches: " + "; ".join(fails))
    return out["one_row_launches"]


# ------------------------------------------------------------- dry run
def _dry_cell(arch, shape, multi_pod):
    """One sweep cell, in a worker process: as the dry run's CLI runs it,
    with the partitioned L=1/L=2 probes on the pod mesh and on the
    multi-pod cells of ``dryrun.PROBED_MULTIPOD``."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    probed = not multi_pod or (arch, shape) in dryrun.PROBED_MULTIPOD
    run = dryrun.run_cell_with_probes if probed else dryrun.run_cell
    rec = run(arch, shape, multi_pod)
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def dryrun_sweep(torch, smi):
    """``run_cell`` for every arch x shape of ``DRY_SWEEP``'s meshes on
    the meta device, in ``DRY_WORKERS`` spawned host processes (the trace
    is host work; the card is not touched). Gates: every applicable cell
    ``ok``, the skips exactly ``shape_applicable``'s, every cell's
    ``argument_bytes`` equal to the value from the specs. The records go
    to ``build/chip_smoke_dryrun/sweep.jsonl``. Returns (cells, records).
    """
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.config import SHAPES, shape_applicable
    cells = [(a, s, mp) for mp, only in DRY_SWEEP for a in ARCHS
             for s in SHAPES if only is None or (a, s) in only]
    t0 = time.perf_counter()

    def cost(cell):
        # the trace's ops grow with depth and width; an MoE cell traces
        # its dispatch besides: the costliest cells start first
        cfg = get_config(cell[0])
        return cfg.n_layers * cfg.d_model * (2 if cfg.n_experts else 1)
    with ProcessPoolExecutor(DRY_WORKERS, mp_context=multiprocessing
                             .get_context("spawn")) as ex:
        futures = {c: ex.submit(_dry_cell, *c)
                   for c in sorted(cells, key=cost, reverse=True)}
        recs = [futures[c].result() for c in cells]
    wall = time.perf_counter() - t0
    out = os.path.join(ROOT, "build", "chip_smoke_dryrun")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "sweep.jsonl"), "w") as f:
        for rec in recs:
            f.write(json.dumps(rec) + "\n")
    card = torch.cuda.get_device_properties(0).total_memory
    rows, bad, fits = [], [], 0
    for (arch, shape, mp), rec in zip(cells, recs):
        cfg = get_config(arch)
        mesh = make_production_mesh(multi_pod=mp)
        ok, why = shape_applicable(cfg, SHAPES[shape])
        key = f"{arch}/{shape}/{mesh.name}"
        if not ok:
            if rec != {"arch": arch, "shape": shape, "mesh": mesh.name,
                       "kind": SHAPES[shape].kind, "status": "skipped",
                       "reason": why, "wall_s": rec.get("wall_s")}:
                bad.append((key, "not skipped as shape_applicable", rec))
            continue
        want = dryrun.argument_bytes(cfg, SHAPES[shape], mesh)
        if rec.get("status") != "ok":
            bad.append((key, rec.get("status"), rec.get("error")))
            continue
        if rec["memory"]["argument_bytes"] != want:
            bad.append((key, "argument_bytes", rec["memory"]["argument_bytes"],
                        want))
        total = rec["memory"]["total_bytes"]
        fits += total <= card
        rows.append([key, total / 2 ** 30, total <= card,
                     rec["cost"]["flops"], rec["cost"]["bytes_accessed"],
                     rec["roofline"]["bottleneck"], rec["roofline"]["step_s"],
                     rec["trace_s"], rec["wall_s"]])
    if bad:
        raise AssertionError(f"dry-run sweep: {bad[:4]}")
    emit("dryrun_sweep", nvidia_smi=smi, cells=len(cells), ok=len(rows),
         skipped=len(cells) - len(rows), workers=DRY_WORKERS,
         wall_s=wall, meshes=[["2x16x16" if mp else "16x16",
                               "all" if only is None else only]
                              for mp, only in DRY_SWEEP],
         card_bytes=card, fit_per_device=fits,
         columns=["cell", "GiB_per_device", "fits_card", "flops_per_device",
                  "bytes_per_device", "bottleneck", "roofline_step_s",
                  "trace_s", "wall_s"], rows=rows,
         per_device="argument bytes exact; cost and temp partitioned "
                    "(rank 0's local program, probes) where the record says "
                    "so, else an even split of the global trace")
    return cells, recs


def _dry_real_args(torch, lm, shp, gen):
    """Real tensors on the card for one cell's step: (the arguments beside
    the parameters, the step, its call arguments)."""
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    dev, b, s = lm.device, shp.global_batch, shp.seq_len
    tokens = torch.randint(0, lm.cfg.vocab, (b, s), generator=gen,
                           device=dev, dtype=torch.int32)
    if shp.kind == "train":
        batch = {"tokens": tokens, "labels": torch.randint(
            0, lm.cfg.vocab, (b, s), generator=gen, device=dev,
            dtype=torch.int32)}
        opt = adamw.init(dict(lm.named_parameters()))
        return [opt, batch], steps.make_train_step(lm), (opt, batch)
    if shp.kind == "prefill":
        return [{"tokens": tokens}], steps.make_prefill_step(lm), (
            {"tokens": tokens},)
    window = min(s, lm.cfg.attn_window) if lm.cfg.attn_window else s
    cache = lm.init_cache(b, window)
    t = torch.tensor(s, dtype=torch.int32, device=dev)
    return [cache, tokens[:, :1], t], steps.make_decode_step(lm), (
        cache, tokens[:, :1], s)


def _tensor_bytes(tree):
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _flash_op_cost(torch, lm, tokens, smi):
    """The cost of calling flash through its torch.library operator, against
    the launch called straight from the wrapper (as before the operator):
    hymba's prefill (host wall, synchronised) in turns op, direct, direct,
    op, and the host time of one call on a tiny bf16 input. Not counted in
    any launch count (a comparison, not the path)."""
    from repro_torch.kernels.flash_attention import flash_attention, ops
    op = ops._OP

    def prefill_s():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.prefill(tokens)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def call_us(n=2000):
        q = torch.zeros(1, 1, 16, 16, dtype=torch.bfloat16, device=lm.device)
        for _ in range(50):
            flash_attention(q, q, q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            flash_attention(q, q, q)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        return host / n * 1e6

    res = {"op": [], "direct": []}
    calls = {"op": [], "direct": []}
    for mode in ("op", "direct", "direct", "op"):
        ops._OP = op if mode == "op" else ops._launch
        try:
            prefill_s()
            res[mode] += [prefill_s() for _ in range(3)]
            calls[mode].append(call_us())
        finally:
            ops._OP = op
    emit("flash_op_cost", nvidia_smi=smi, arch=lm.cfg.name,
         prefill_shape=list(tokens.shape),
         prefill_s_op=res["op"], prefill_s_direct=res["direct"],
         prefill_s_op_median=statistics.median(res["op"]),
         prefill_s_direct_median=statistics.median(res["direct"]),
         call_us_op=calls["op"], call_us_direct=calls["direct"],
         note="op: wrapper -> torch.ops.repro_torch.flash_attention -> "
              "launch; direct: wrapper -> launch (the path before the "
              "operator)")


def dryrun_real_cells(torch, smi):
    """hymba_1_5b at its published widths, bf16, seeded weights, on a 1x1
    mesh: the dry run of each of ``DRY_CELLS`` on the meta device, then
    the same step on the card. Gates: the meta FLOPs equal
    FlopCounterMode's over the real step on cuda (a prefill's SSDs through
    ``ssd_scan``'s operator on both, its fake kernel on meta), and
    argument_bytes the bytes of the real parameters, state, batch and
    cache. Printed:
    predicted peak (argument + temp bytes) against max_memory_allocated,
    the step's CUDA-event time against the roofline's step_s, and model
    FLOPs against the bf16 peak. Returns the kernels' launch counts over
    the real cells (counts set to 0 just before, read just after)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import reset_counts
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import LM
    dev = torch.device("cuda", 0)
    cfg = get_config(DRY_ARCH)
    mesh = make_mesh((1, 1), ("data", "model"))
    lm = LM(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(3)
    param_bytes = _tensor_bytes(dict(lm.named_parameters()))
    counters = _counters()
    for f in counters.values():
        f.launches = 0
    reset_counts()
    flash = counters["flash_attention"]
    prefill_runs = 0
    for kind, seq, batch, reps in DRY_CELLS:
        shp = ShapeConfig(f"{kind}_{batch}x{seq}", seq, batch, kind)
        over = {"attn_impl": "flash"} if kind == "prefill" else {}
        rec = dryrun.run_cell(DRY_ARCH, shp, False, over or None, mesh=mesh)
        if rec["status"] != "ok":
            raise AssertionError(f"dry run of {shp}: {rec}")
        with swapped_cfg(lm, **over):
            args, fn, fargs = _dry_real_args(torch, lm, shp, gen)
            real_bytes = param_bytes + _tensor_bytes(args)
            if real_bytes != rec["memory"]["argument_bytes"]:
                raise AssertionError(
                    f"{shp.name}: argument_bytes {rec['memory']['argument_bytes']}"
                    f" from the specs, {real_bytes} in the real tensors")
            torch.cuda.synchronize()
            with FlopCounterMode(display=False) as fc:
                fn(*fargs)
            torch.cuda.synchronize()
            cuda_flops = fc.get_total_flops()
            if cuda_flops != rec["cost_global"]["flops"]:
                raise AssertionError(
                    f"{shp.name}: {rec['cost_global']['flops']} FLOPs on "
                    f"meta, {cuda_flops} on cuda")
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for _ in range(reps):
                s, e = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                s.record()
                fn(*fargs)
                e.record()
                torch.cuda.synchronize()
                ms.append(s.elapsed_time(e))
            peak = torch.cuda.max_memory_allocated()
            prefill_runs += (1 + reps) * (kind == "prefill")
        step_s = statistics.median(ms) / 1e3
        predicted = rec["memory"]["argument_bytes"] + \
            rec["memory"]["temp_bytes"]
        extra = {}
        if kind == "train":
            _, parts = train_model_flops(cfg, batch, seq)
            extra = {"train_model_flops": sum(parts.values()),
                     "train_model_flops_share_of_bf16_peak":
                         sum(parts.values()) / step_s / BF16_TENSOR_FLOPS}
        emit("dryrun_real", nvidia_smi=smi, arch=cfg.name, cell=shp.name,
             kind=kind, seq_len=seq, global_batch=batch, mesh=mesh.name,
             attn_impl=over.get("attn_impl", cfg.attn_impl),
             meta_flops=rec["cost_global"]["flops"], cuda_flops=cuda_flops,
             argument_bytes=rec["memory"]["argument_bytes"],
             real_argument_bytes=real_bytes,
             temp_bytes=rec["memory"]["temp_bytes"],
             predicted_peak_bytes=predicted, max_memory_allocated=peak,
             peak_predicted_over_measured=predicted / peak,
             bytes_accessed=rec["cost_global"]["bytes_accessed"],
             roofline=rec["roofline"], step_ms=ms, step_s_median=step_s,
             share_of_roofline=rec["roofline"]["step_s"] / step_s,
             model_flops=rec["model_flops_global"],
             model_flops_share_of_bf16_peak=rec["model_flops_global"]
             / step_s / BF16_TENSOR_FLOPS,
             trace_s=rec["trace_s"], **extra)
        del args, fargs, fn
        torch.cuda.empty_cache()
    launches = {name: f.launches for name, f in counters.items()}
    want = {name: 0 for name in launches}
    want["flash_attention"] = want["ssd_scan"] = cfg.n_layers * prefill_runs
    if launches != want or flash.route_launches["tensor_core"] != \
            want["flash_attention"]:
        raise AssertionError(f"dry-run cells launched {launches} "
                             f"({flash.route_launches}), expected {want}, "
                             f"flash all on the tensor cores")
    for p in lm.parameters():
        p.requires_grad_(False)
    prompts = torch.randint(0, cfg.vocab, (4, 2048), generator=gen,
                            device=dev)
    with swapped_cfg(lm, attn_impl="flash"):
        _flash_op_cost(torch, lm, prompts, smi)
    del lm
    torch.cuda.empty_cache()
    return launches


def dryrun_phase(torch, smi):
    """The dry run: the meta-device sweep over every cell, then three real
    hymba cells held against their dry runs. Returns the kernels' launch
    counts of the real cells and the sweep's (cells, records)."""
    t0 = time.perf_counter()
    sweep = dryrun_sweep(torch, smi)
    sweep_s = time.perf_counter() - t0
    launches = dryrun_real_cells(torch, smi)
    emit("dryrun_phase", sweep_s=sweep_s,
         seconds=time.perf_counter() - t0, launches=launches)
    return launches, sweep


def partitioned_sweep_gates(smi, cells, recs):
    """The sweep's partitioned records: every ``ok`` cell probed on its
    mesh (the pod mesh, ``dryrun.PROBED_MULTIPOD``), the MoE cells included,
    has a numeric ``collective_s`` and ``wire_bytes`` and per-device cost
    and temp marked ``"partitioned"``, and its collectives (wire bytes,
    op count, wire bytes by kind) equal, exactly, those that the committed
    ``repro_torch/launch/collective_counts.json`` holds for the cell (the
    count of another torch version: the dry run's answer must not depend
    on the torch installed); each cell that differs is printed on a line
    of its own before the phase fails. Prints each probed cell's GiB per
    device, roofline terms, wire bytes and kinds."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, roofline
    with open(dryrun.COUNTS_FILE) as f:
        committed = json.load(f)
    rows, bad, moe, differ, seen = [], [], [], [], set()
    for (arch, shape, mp), rec in zip(cells, recs):
        if rec.get("status") != "ok":
            continue
        if mp and (arch, shape) not in dryrun.PROBED_MULTIPOD:
            continue
        key = f"{arch}/{shape}/{rec['mesh']}"
        col, rf = rec["collectives"], rec["roofline"]
        if get_config(arch).n_experts:
            moe.append(key)
        if not (isinstance(col.get("wire_bytes"), float)
                and isinstance(rf.get("collective_s"), float)
                and rec["cost"]["per_device"] == "partitioned"
                and rec["memory"]["per_device"]["temp_bytes"]
                == "partitioned"):
            bad.append((key, col.get("wire_bytes"), rf.get("collective_s"),
                        rec["cost"]["per_device"]))
            continue
        seen.add(key)
        mine = {k: col[k] for k in ("wire_bytes", "count", "by_kind")}
        want = committed["cells"].get(key)
        if mine != want:
            differ.append(key)
            emit("dryrun_partitioned_differs", cell=key, card=mine,
                 committed=want, committed_torch=committed["torch"])
        rows.append([key, rec["memory"]["total_bytes"] / 2 ** 30,
                     rf["compute_s"], rf["memory_s"], rf["collective_s"],
                     rf["bottleneck"], col["wire_bytes"], col["count"],
                     col["by_kind"], rec["useful_flop_ratio"]])
    if bad:
        raise AssertionError(f"partitioned sweep: {bad[:4]}")
    missing = sorted(set(committed["cells"]) - seen)
    if differ or missing:
        raise AssertionError(f"partitioned sweep: {len(differ)} cell(s) "
                             f"differ from the committed counts (torch "
                             f"{committed['torch']}): {differ}; committed "
                             f"but not probed here: {missing}")
    emit("dryrun_partitioned_sweep", nvidia_smi=smi, probed=len(rows),
         moe_cells=moe, equal_to_committed=len(seen),
         committed_torch=committed["torch"],
         columns=["cell", "GiB_per_device", "compute_s", "memory_s",
                  "collective_s", "bottleneck", "wire_bytes",
                  "collective_count", "by_kind", "useful_flop_ratio"],
         rows=rows, link_bw=roofline.LINK_BW,
         note="per device, rank 0's local program on a DeviceMesh over "
              "torch's fake process group (meta device), extrapolated from "
              "the L=1/L=2 probes; collective_s at NVLink 4's 450 GB/s, a "
              "lower bound across nodes")
    return len(rows)


def partitioned_shard_phase(torch, smi, arch, cell):
    """One rank's shard for real: ``arch`` at its published widths, bf16,
    flash, seeded weights (``LM.init`` on the local shards), ``cell``'s
    prefill on a (data=1, model=tp) mesh over a fake world of tp ranks,
    rank 0's local program on cuda:0 (for an MoE arch, E / tp experts and
    the router over every expert). The dry run traces the same
    partitioned step on meta.
    Gates: the FLOPs counted on meta equal those counted on cuda, and
    flash's among them are the local head count's; the argument bytes
    from the specs equal the local tensors'; the collective count on
    cuda equals the count on meta; the predicted peak (argument + temp
    bytes) within ``PART_PEAK_TOL`` of ``max_memory_allocated`` over one
    run; flash launched once a layer on the tensor cores, and held to its
    plain version at the local shape. Returns the kernels' launch counts
    of that one run (counts set to 0 just before it)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention,
                                                     reset_counts)
    from repro_torch.kernels.flash_attention.ops import flash_flops
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.sharding import plan_attention
    cfg = get_config(arch).replace(attn_impl="flash")

    def plan_ok(tp):
        try:
            plan_attention(cfg.n_heads, cfg.n_kv_heads, tp)
        except ValueError:
            return False
        return True
    tp = next(t for t in PART_TP if plan_ok(t))
    plan = plan_attention(cfg.n_heads, cfg.n_kv_heads, tp)
    mesh = make_mesh((1, tp), ("data", "model"))
    kind, seq, batch, reps = cell
    shp = ShapeConfig(f"{kind}_{batch}x{seq}", seq, batch, kind)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    meta = dryrun.trace_partitioned(cfg, shp, mesh)
    meta_s = time.perf_counter() - t0
    arg_bytes = dryrun.argument_bytes(cfg, shp, mesh)
    counters = _counters()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    with fake_world(tp):
        lm, fn, fargs, args = dryrun.partitioned_cell(
            cfg, shp, mesh, device=dev,
            init=torch.Generator(device=dev).manual_seed(0))
        params = dict(lm.named_parameters())
        local_bytes = _tensor_bytes(dryrun.local_shards(
            [list(params.values()), args]))
        if local_bytes != arg_bytes:
            raise AssertionError(f"partitioned {shp.name} tp={tp}: "
                                 f"argument_bytes {arg_bytes} from the "
                                 f"specs, {local_bytes} in the local shards")
        real = dryrun.trace_local(fn, *fargs, known=(params, args),
                                  device_type="cuda")
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with implicit_replication():
            out = fn(*fargs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        launches = {name: f.launches for name, f in counters.items()}
        routes = dict(flash_attention.route_launches)
        out_shape = [list(out.shape), list(out.to_local().shape)]
        ms = []
        with implicit_replication():
            for _ in range(reps):
                s_ev, e_ev = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                s_ev.record()
                fn(*fargs)
                e_ev.record()
                torch.cuda.synchronize()
                ms.append(s_ev.elapsed_time(e_ev))
        del lm, fn, fargs, args, params, out
    torch.cuda.empty_cache()
    q_shape = (batch, plan.h_pad // tp, seq, cfg.head_dim)
    kv_shape = (batch, plan.kv_virtual // tp, seq, cfg.head_dim)
    want_flash = cfg.n_layers * flash_flops(q_shape, kv_shape, kv_shape,
                                            True, cfg.attn_window, 0)
    got_flash = real["flops_by_op"].get("repro_torch.flash_attention")
    predicted = arg_bytes + meta["temp_bytes"]
    bad = []
    if real["flops"] != meta["flops"]:
        bad.append(("flops", meta["flops"], real["flops"]))
    if got_flash != want_flash or meta["flops_by_op"].get(
            "repro_torch.flash_attention") != want_flash:
        bad.append(("flash flops at the local heads", want_flash, got_flash))
    if real["collectives"].count != meta["collectives"].count:
        bad.append(("collectives", meta["collectives"].count,
                    real["collectives"].count))
    if abs(predicted / peak - 1) > PART_PEAK_TOL:
        bad.append(("peak", predicted, peak))
    want = {name: 0 for name in launches}
    want["flash_attention"] = cfg.n_layers
    if launches != want or routes["tensor_core"] != cfg.n_layers:
        bad.append(("launches", launches, routes))
    if bad:
        raise AssertionError(f"partitioned shard tp={tp}: {bad}")
    # flash at the local shape against its plain version (not counted)
    gen = torch.Generator(device=dev).manual_seed(5)
    tol = FLASH_TOL[str(torch.bfloat16)]
    q, k, v = (torch.randn((batch, seq, sh[1], cfg.head_dim), generator=gen,
                           device=dev).to(torch.bfloat16).transpose(1, 2)
               for sh in (q_shape, kv_shape, kv_shape))
    got = flash_attention(q, k, v, causal=True, window=cfg.attn_window)
    ref = attention_ref(q, k, v, causal=True, window=cfg.attn_window)
    torch.cuda.synchronize()
    err, ok = _close(got, ref, tol, tol)
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"flash at the local shape {q_shape}: max abs "
                             f"err {err} beyond atol=rtol={tol}")
    step_s = statistics.median(ms) / 1e3
    rf = roofline.terms(meta["flops"], meta["bytes_accessed"],
                        meta["collectives"].wire_bytes)
    emit("dryrun_partitioned_shard", nvidia_smi=smi, arch=cfg.name,
         cell=shp.name, mesh=mesh.name, tp=tp, plan=[plan.h_pad,
                                                     plan.kv_virtual],
         experts_local=cfg.n_experts // tp,
         attn_impl="flash", meta_trace_s=meta_s,
         meta_flops=meta["flops"], cuda_flops=real["flops"],
         flash_flops=got_flash, flash_local_q=list(q_shape),
         flash_local_kv=list(kv_shape),
         argument_bytes=arg_bytes, local_argument_bytes=local_bytes,
         temp_bytes=meta["temp_bytes"], predicted_peak_bytes=predicted,
         max_memory_allocated_over_base=peak, memory_base=base,
         peak_predicted_over_measured=predicted / peak,
         meta_bytes_accessed=meta["bytes_accessed"],
         cuda_bytes_accessed=real["bytes_accessed"],
         collectives_meta=meta["collectives"].count,
         collectives_cuda=real["collectives"].count,
         wire_bytes=meta["collectives"].wire_bytes,
         by_kind=meta["collectives"].by_kind, roofline=rf,
         step_ms=ms, step_s_median=step_s,
         share_of_roofline_without_collectives=max(
             rf["compute_s"], rf["memory_s"]) / step_s,
         launches=launches, routes=routes, output_shapes=out_shape,
         flash_local_max_abs_err=err,
         note="rank 0's local program; the fake backend's collectives "
              "return at once and compute nothing, so the step time "
              "leaves out the wire and no value is meaningful")
    return launches, {"shape": f"q {list(q_shape)} k/v {list(kv_shape)} "
                               f"bf16 causal window {cfg.attn_window}",
                      "max_abs_err": err}


def dryrun_partitioned_phase(torch, smi, sweep):
    """The partitioned dry run: (a) the sweep's partitioned records and
    their gates, (b) one rank's shard of each of ``PART_SHARDS``
    (hymba_1_5b, deepseek_moe_16b) run on the card beside its meta trace.
    Returns (b)'s launch counts and flash rows, one per shard."""
    t0 = time.perf_counter()
    probed = partitioned_sweep_gates(smi, *sweep)
    shards, seconds = [], {}
    for arch, cell in PART_SHARDS:
        t1 = time.perf_counter()
        shards.append(partitioned_shard_phase(torch, smi, arch, cell))
        torch.cuda.empty_cache()
        seconds[arch] = time.perf_counter() - t1
    emit("dryrun_partitioned", probed_cells=probed,
         seconds=time.perf_counter() - t0, shard_seconds=seconds,
         launches={arch: launches for (arch, _), (launches, _)
                   in zip(PART_SHARDS, shards)})
    return shards


def examples_phase(smi):
    """The four examples in subprocesses on cuda, started together: the
    quickstart and the torch-loop mapper gated on exit 0 and their IIs
    (the JAX examples' IIs; tests/test_torch_examples.py holds them to the
    reference), the LM trainer on exit 0 and finite loss lines, the
    portfolio mapper on exit 0, with its wall time printed."""
    runs = {"quickstart_torch": [], "map_torch_loop": [],
            "train_lm_torch": ["--steps", "20"],
            "portfolio_mapper_torch": []}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    procs = {name: (subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", name + ".py"),
         *args, "--device", "cuda"], cwd=ROOT, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE), time.perf_counter())
        for name, args in runs.items()}
    out = {}
    try:
        for name, (proc, start) in procs.items():
            stdout, stderr = proc.communicate(timeout=EXAMPLES_TIMEOUT_S)
            out[name] = (proc.returncode, stdout, stderr,
                         time.perf_counter() - start)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    failed = {n: (rc, err[-800:]) for n, (rc, _, err, _) in out.items() if rc}
    if failed:
        raise AssertionError(f"examples failed: {failed}")
    lines = {n: o[1].splitlines() for n, o in out.items()}
    iis = {"quickstart_torch": [ln.split(" in ")[0] for ln in
                                lines["quickstart_torch"]
                                if ln.startswith("mapped at")],
           "map_torch_loop": [" ".join(ln.split()) for ln in
                              lines["map_torch_loop"] if "II(" in ln]}
    from repro_torch.core.sat import resolve_method
    complete = resolve_method("auto")
    if iis != EXAMPLE_IIS:
        raise AssertionError(f"example IIs {iis} on {complete}, expected "
                             f"{EXAMPLE_IIS}")
    losses = [float(ln.split("loss=")[1].split()[0])
              for ln in lines["train_lm_torch"] if ln.startswith("step ")]
    if len(losses) < 2 or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train_lm_torch losses {losses}")
    emit("examples", nvidia_smi=smi, wall_s=wall,
         seconds={n: o[3] for n, o in out.items()}, iis=iis,
         complete_backend=complete,
         train_losses=losses,
         portfolio=lines["portfolio_mapper_torch"][-4:],
         portfolio_wall_s=out["portfolio_mapper_torch"][3])


def one_row_served(torch, lm, prompts):
    """The plain path's run that the host world's batch of one is held
    to: row 0 of the serve phase's ``prompts`` alone through ``serve_lm``
    on the serve phase's LM, ONE_ROW_STEPS greedy steps (``_served``)."""
    from repro_torch.launch.serve import serve_lm
    torch.cuda.reset_peak_memory_stats()
    res = serve_lm(lm, prompts[:1], ONE_ROW_STEPS)
    return _served(res, torch.cuda.max_memory_allocated())


def chunked_served(torch, lm, prompts):
    """The plain path's runs on the SSD route the partitioned LM takes
    (its DTensors run ``ssd_chunked``; ``layers.ssd_route`` is made to
    pick it here): the greedy tokens of the serve phase's ``prompts``
    (SERVE_STEPS) and of row 0 alone (ONE_ROW_STEPS), which the host
    world on one card is held to exactly."""
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import layers
    route = layers.ssd_route
    layers.ssd_route = lambda *operands: "chunked"
    try:
        full = serve_lm(lm, prompts, SERVE_STEPS)
        one = serve_lm(lm, prompts[:1], ONE_ROW_STEPS)
    finally:
        layers.ssd_route = route
    return full.tokens.cpu().tolist(), one.tokens.cpu().tolist()


def _served(res, peak):
    """What the host world is held to of a serve phase's run, on the
    host."""
    return {"tokens": res.tokens.cpu().tolist(),
            "fed": res.fed.cpu().tolist(),
            "logits": [lg.cpu() for lg in res.logits],
            "prefill_s": res.prefill_s, "decode_s": res.decode_s,
            "max_memory_allocated": peak}


def host_mesh_main(torch, smi) -> int:
    """``--host-mesh``: the host world alone, with the two phases it is
    held to (hymba_1_5b's ``serve`` and ``train`` main paths on cuda:0),
    for a machine of several cards; the last line as the full run's."""
    from repro_torch.kernels import _cuda
    _cuda.build(["flash_attention"])
    flash_one_row(torch, torch.Generator(device="cuda").manual_seed(3))
    lm, prompts, res, _, peak = serve_phase(torch, "hymba_1_5b", smi)
    served = _served(res, peak)
    served["one_row"] = one_row_served(torch, lm, prompts)
    served["chunked_tokens"], served["one_row"]["chunked_tokens"] = \
        chunked_served(torch, lm, prompts)
    del lm, prompts, res
    torch.cuda.empty_cache()
    _, trained = train_main_phase(torch, smi)
    torch.cuda.empty_cache()
    host_mesh_phase(torch, smi, trained, served)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    import faulthandler
    import torch
    # a crash in native code (a kernel's host side, z3) names every
    # thread's Python stack
    faulthandler.enable(all_threads=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels import _cuda
    torch.cuda.set_device(0)
    # f32 products in full f32 (no TF32), for the kernels' plain versions
    # and the f32 agreement run alike
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = environment(torch)
    if sys.argv[1:] == ["--host-mesh"]:
        return host_mesh_main(torch, smi)
    t0 = time.perf_counter()
    report = _cuda.build(["clause_eval", "flip_update", "flash_attention",
                          "ssd_scan"])
    emit("build", seconds=time.perf_counter() - t0,
         per_source={n: s for n, (s, _) in report.items()},
         ptxas={n: [ln for ln in log.splitlines() if "registers" in ln
                    or "smem" in ln] for n, (_, log) in report.items()})
    times, windows = kernel_phase(torch)
    clause_eval_band_phase(torch)
    times["walk_chunk"] = walk_chunk_phase(torch, windows)
    engine_phase(torch, windows["4x4"])
    step = walk_step_phase(torch, windows["4x4"])
    del windows
    torch.cuda.empty_cache()
    launches, walk = main_path(torch)
    sharded_chain_phase(torch)
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
    service = service_phase(torch, smi)
    times["clause_eval_window"]["service_path_launches"] = \
        service["clause_eval_window"]
    times["walk_chunk"]["service_path_launches"] = service["walk_chunk"]
    torch.cuda.empty_cache()
    guided = campaign_phase(torch, smi)
    for name in ("clause_eval_window", "walk_chunk"):
        times[name]["campaign_path_launches"] = guided[name]
    torch.cuda.empty_cache()
    lm_times = lm_kernel_phase(torch)
    flash_edge_phase(torch)
    torch.cuda.empty_cache()
    lm, prompts, res, served, peak = serve_phase(torch, "hymba_1_5b", smi)
    launches.update({k: served[k] for k in ("flash_attention", "ssd_scan")})
    hymba_served = _served(res, peak)
    hymba_served["one_row"] = one_row_served(torch, lm, prompts)
    hymba_served["chunked_tokens"], \
        hymba_served["one_row"]["chunked_tokens"] = chunked_served(
            torch, lm, prompts)
    del lm, prompts, res
    torch.cuda.empty_cache()
    serve_agreement_phase(torch, "float32")
    torch.cuda.empty_cache()
    serve_agreement_phase(torch, "bfloat16")
    torch.cuda.empty_cache()
    lm, prompts, res, moe_launches, _ = serve_phase(
        torch, "deepseek_moe_16b", smi)
    flash_agreement(torch, lm, prompts)
    torch.cuda.empty_cache()
    kv_quant_phase(torch, lm, prompts, res)
    torch.cuda.empty_cache()
    moe_layer_parity(torch, lm)
    del lm, prompts, res
    torch.cuda.empty_cache()
    moe_f32_agreement_phase(torch)
    torch.cuda.empty_cache()
    _, _, _, granite_launches, _ = serve_phase(torch, GRANITE_ARCH, smi)
    torch.cuda.empty_cache()
    train_launches, trained = train_phase(torch, smi)
    host_launches, one_row_launches = host_mesh_phase(torch, smi, trained,
                                                      hymba_served)
    t0 = time.perf_counter()
    dry_launches, sweep = dryrun_phase(torch, smi)
    (part_launches, part_flash), (moe_part_launches, moe_part_flash) = \
        dryrun_partitioned_phase(torch, smi, sweep)
    del sweep
    examples_phase(smi)
    emit("dryrun_and_examples", seconds=time.perf_counter() - t0)
    times.update(lm_times)
    moe_row = times.pop("flash_attention_moe")
    granite_row = times.pop("flash_attention_granite")
    times["flash_attention"]["granite_shape"] = {
        k: granite_row[k] for k in ("shape", "scale", "ms", "plain_ms",
                                    "library_ms", "max_abs_err",
                                    "default_scale_max_abs_err")} | {
        "bound_ms": granite_row["bound"][0],
        "bound_by": granite_row["bound"][1]}
    for name in ("flash_attention", "ssd_scan"):
        times[name]["granite_path_launches"] = granite_launches[name]
    times["flash_attention"].update(
        moe_path_launches=moe_launches["flash_attention"],
        moe_shape={k: moe_row[k] for k in ("shape", "ms", "plain_ms",
                                           "library_ms", "max_abs_err")}
        | {"bound_ms": moe_row["bound"][0], "bound_by": moe_row["bound"][1]})

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
        t["train_path_launches"] = train_launches[name]
        t["dryrun_path_launches"] = dry_launches[name]
        t["partitioned_path_launches"] = part_launches[name]
        t["partitioned_moe_path_launches"] = moe_part_launches[name]
        t["host_mesh_path_launches"] = host_launches[name]
        t["host_mesh_one_row_path_launches"] = one_row_launches[name]
        if name == "flash_attention":
            t["note"] = FLASH_NOTE
            t["partitioned_shape"] = part_flash
            t["partitioned_moe_shape"] = moe_part_flash
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
