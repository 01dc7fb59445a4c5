"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # full size; needs one CUDA card

Drives the port's main paths through the entry points a user calls, at
n=64, t=21:

  * the open path — deal -> pack -> open (detect-only) -> check — in
    segments of 22*768 = 16896 sharings, 64 segments resident (about 2.2 GB
    of packed shares);
  * the offline path — verified Beaver triples from the fused RanSha /
    RanDouSha pipeline with the packed finish,
    ``sim_offline_jit("generate_triples_packed", 64, 21, 4096)``: 90,112
    triples per call;
  * the robust open — one 16896-sharing segment with the shares of 21
    parties replaced: the two-phase ``sim_batch_reconstruct`` (detect-only
    open, then the Gao redo over 2 x 49,152 decodes), ``batch_reconstruct``
    with its Gao fallback, ``sim_open_direct_packed(robust=True)``,
    ``robust_open_single`` and the three-kernel open with its fallback;
  * the offline programs — ``sim_offline_jit(program, 64, 21, 4096,
    in_graph_fallback)`` for randousha, generate_triples and generate_bits
    in both modes (90,112 double sharings, triples or bits per call): the
    fused pipelines, the eager per-column programs with detect-only opens,
    and with the faithful three-kernel open and its in-program fallback;
  * the per-column check of the fused RanDouSha pipeline —
    ``_randousha_calls(64, 21, 4096, aggregate=False)`` in double and single
    mode (90,112 double sharings per call), every discarded column opened at
    both degrees, with a flipped word and the known-rho bypass caught;
  * the coding layer and the NTL-compatible API — the reference bench's
    grids of Vandermonde interpolation, NTT interpolation and evaluation
    and random refinement, the omega-domain encode and FNT decode of
    16,896 polynomials from 43 of 128 parties, and every ``ntl`` function,
    among them ``vandermonde_batch_evaluate`` of 1,024 polynomials with 512
    coefficients at 4 points (the fused 73-diagonal MXU kernel).
  * the MPC runtime core and its models — ``MpcContext`` with the port's
    dealer: Beaver and double-sharing multiplies of 65,536 shared values,
    inversion and division, a multiply whose input shares 21 parties
    falsify (the Gao redo), equality and less-than, ``refine_triples`` of
    1,024 batches of 64 dirty triples, MiMC at bench_mimc's batch of 1,000
    and the k = 1,024 butterfly network (100 rounds of 512 switches);
  * fixed point, power mixing and the AsynchroMix app — a
    ``FixedPointArray`` multiply of 4,096 values, ``lt``, ``trunc`` and
    ``div2m`` of 1,024, the bench's power-mix epochs at k = 64 and 256,
    its butterfly epoch at k = 1,024 with the triple refill, and one
    event-driven epoch through the coordinator;
  * the fused runner — the bench's Jubjub programs (add + double at
    B = 64 and 4,096, a 16-bit scalar ladder at B = 64) replayed as CUDA
    graphs and called eagerly, and the MiMC-Jubjub PKC round trip.

The first run builds the kernels from ``honeybadgermpc_tpu_torch/csrc``
into ``honeybadgermpc_tpu_torch/build``.

Phases, each printing one JSON line; any failure exits non-zero (13 runs
right after the offline kernels of phase 8, 18 and 19 right after 10):
  1 device    a CUDA card must be present; prints its name and power limit
  2 build     compile and load the nineteen kernels and the host root
              finder (native/hbmpc_native.cpp, g++); ptxas registers
              and spills of the kernels on the wgmma core, of the sampler
              and of rows 7 and 12
  3 kernels   each kernel against its plain PyTorch version on the card,
              bit for bit, at small, unaligned and main-path shapes, with
              times and the computed bound; the sampler (row 2) at numel
              = 1, 77, 255, 257, 5000, 131,071, one pass of its resident
              grid and either side of it, 16,896 and 354,816; row 3 (band_matmul, on the wgmma
              core) at B in {1, 63, 64, 65, 16896, 262144}, k in {1, 3, 22,
              43, 64}, m in {1, 5, 64, 128} with a Python-int sample each,
              timed at the open's shape and the eager programs' three; the
              direct open (row 1, on the wgmma core up to k = 81) at n=8,
              7 and 64, k = 3, 22 and 43, and its large-k route (the
              mma.sync kernel) at n=128, k=86, each honest, with a
              validating and an interpolating party faulty, two lanes of
              one warp faulty at the last compare column, one lane at the
              first, and t faulty parties: secrets and per-source counts
              equal, timed honest and with 21 faulty parties; the deal and
              the aggregated extraction (rows 4 and 5a, on the wgmma core)
              at n=8, t=2 and n=64, t=21 over 4096 slots, both degrees,
              also at every lane tile that fits, on outputs filled with
              nonzero bytes; the packed finish (rows 7 and 8) at
              [8, 3, 5, 77], [8, 7, 3, 43], [8, 1, 1, 127], [8, 1, 1, 1]
              and [8, 64, 24, 4096], row 7's flat form unpadded and padded,
              random operands and every operand at p - 1
  4 main      deal, pack and open every segment; nerr == 0; opened secrets
              against a Python-int Lagrange oracle; launch counters moved
  5 faults    a flipped word is detected and charged to the right party
  6 state     save the pool, load it into a fresh dealer, same secrets
  7 timing    opened and dealt sharings per second
  8 triples   one triple call; ok; launch counters moved; a, b, ab opened
              at degree t with nerr == 0 and ab == a*b mod p for every real
              triple on the card, and for a sample in Python ints
  9 triple faults   a flipped word in a receive tensor flips ok
 10 triple timing   triples per second and device time per stage
 11 robust kernels    rows 9, 12, 13 and 15 of PERF.md (mont_mul,
              fp_matmul_cios, mxu_fused2, mxu_redc) against their plain
              versions on the card, bit for bit, at the robust open's
              shapes, a Python-int sample each, times and bounds; row 13
              (on the wgmma core) also at B = 1, 63, 65, 1031 and 49,152,
              k = 1, 27, 28, 32, 33, 55, 56 and 438, n = 4, 5, 8, 16, 43
              and 64 (ROW13_EDGES); row 12 at its plan's split and at
              every split (1-32 lanes per output) at B=64, k=22, n=43, and
              at CIOS_EDGES (B = 1 to 1023, k = 1 to 3599), random and
              every operand at p - 1
 12 robust open       honest: nerr == 0 and no Gao launch; 21 faulty
              parties: phase one sees them, the redo returns the honest
              secrets with nerr == 768*21 at every party, the other three
              entry points agree, no plain multiply or matmul ran on the
              card; the redo's time and the device time of one Gao segment;
              the three-kernel open charges every destination and its
              fallback returns the honest secrets
 13 program kernels  rows 10 and 16-18 (mul_add_packed, open_fused K1-K3)
              against their plain versions on the card, bit for bit, at the
              programs' shapes (k = 22 and 43), an unaligned chunk count and
              a small shape, honest and faulted, a Python-int sample each;
              K3 (on the wgmma core, its column tiles split into groups)
              also on dealt polynomials at the programs' shapes, C = 1, 65
              and 7819, n = 8 and 7, honest (the secrets are the dealt
              coefficients) and with four fault cases (two lanes of a warp
              in the last compare column, the first at the last lane, an
              interpolating operand, a lying party): the one count equal;
              K1 also at C = 1, 7819 and 7820 (k = 22 and 43), the edges of
              its lane tiles; K2 (on the wgmma core) also at C = 1, 65 (a
              destination boundary inside a 64-lane tile) and 7819 (a
              ragged 256-lane tile), with faults in its first and last
              compare columns: per-destination counts equal
 14 programs  each program in both modes once with the launch counts set
              to 0 just before and read just after: ok; r_t and r_2t open
              to equal secrets; ab == a*b for every triple; every bit is 0
              or 1 and both occur; K1-K3 launched by the fallback runs,
              mul_add_packed by the fused triples, no plain version on the
              card; then ms per call, outputs per second, device-busy ms
 15 program fault     generate_triples with the fallback at k=16 and one
              party sending wrong shares of a*b + r: the outputs equal the
              honest run's, ok turns false
 16 coding kernels    rows 14 and 13 (mxu_fused, mxu_fused2, on the wgmma
              core) against their plain versions on the card, bit for
              bit, at every window fp_matmul routes to them (row 14: k
              439-858 at n=4, 313-422 at n=8, 196-204 at n=16; row 13 with
              streamed planes up to k=438), row 14 also at B = 1, 63, 65
              and 1031 (ROW14_EDGES), a Python-int sample each, times and
              bounds; fp_matmul on CUDA
              tensors at both sides of every window edge: no raise, the
              routed kernel launched, no plain version on the card
 17 ntl       with the launch counts set to 0 just before: the bench grids
              (vandermonde_batch_interpolate n=16/128/1024 x 8, NTT
              interpolate/evaluate n=2^4..2^14 x 2^16/n, refine_randoms
              n=4/16/64 x 512), Encoding(128, omega) encode and decode from
              43 parties, every ntl function once (row 14 through
              vandermonde_batch_evaluate), each against Python ints on a
              sample; rates in the bench's units beside device-busy ms
 18 per-column kernels  rows 5b, 6 and 11 (randousha_extract_pc,
              randousha_check, sub_bcast_packed) against their plain
              versions on the card, bit for bit: the extraction and check at
              n=8, t=2, sp=128 and n=64, t=21, sp=4096, both degrees (the
              extraction once more on outputs filled with nonzero bytes:
              every word written, the zero check rows too), the
              check (row 6, on the wgmma core) also on a flipped word (1 at
              that lane only) and on flips in two lanes of one 64-lane
              block at the last and the first compare column; the flat
              subtract at [8,3,77] and at the flat finish's [8,90112] -
              [8,64,90112], also against montgomery.sub_mod; times, bounds
 19 per-column path  _randousha_calls(64, 21, 4096, aggregate=False), double
              and single, launch counts set to 0 just before each call:
              nerr == 0, no plain version on the card, keep rows [:22] equal
              to the aggregated run's, equal opened check values at both
              degrees and Python ints on a sample; a flipped receive word at
              party 30 gives errs 1 in every real check column of its slot;
              the known-rho bypass passes the aggregated check and not the
              per-column one; ms per call, device-busy ms
 20 runtime    MpcContext at n=64, t=21 on the port's dealer (its draws and
              encodes inside the phase), launch counts set to 0 just
              before and read after the checked calls: Beaver and
              double-sharing multiplies of B = 65,536 (every product
              against Python ints, B preprocessed elements taken), invert
              and divide at B = 4,096, one multiply of B = 220 with the
              input shares of 21 parties replaced (the products right,
              nerr_total an int32 [64] tensor with 10 x 21 at every
              party), equality at B = 1,024 (half the pairs equal) and
              less_than at B = 256 against Python ints, refine_triples on
              1,024 batches of 64 dirty triples (c = a*b for all 44,032
              outputs); the direct open, the sampler, the band encode,
              mont_mul and an fp_matmul route launched, no plain version
              on the card; then a warm call of each op timed by the host
              clock (the multiplies also with device busy, launches and
              peak bytes, and where a Beaver multiply's device time goes:
              its open, mont_mul, the int64 glue)
 21 models    mimc_mpc_batch_jit (one body with mimc_mpc_batch) at
              B = 1,000 against mimc_plain, iterated_butterfly_network_jit
              at k = 1,024 (one take per kind, 51,200 switches) opening to
              a shuffle of its input, launch counts as in 20; warm calls
              timed: blocks/s,
              network ms and device busy; one ``runtime_timing`` line for
              both phases
 22 apps      with the launch counts as in 20: a FixedPointArray multiply
              at B = 4,096 (each result floor or floor + 1 of the reps'
              product, every party's floats within 1e-3), lt at B = 1,024
              (an eighth of the pairs equal) against the reps, trunc and
              div2m at B = 1,024, m = 32 on |x| < 2^62 against Python ints;
              ServerGroupSim(mix="powers").mix_epoch at k = 64 and 256 and
              the butterfly group's at k = 1,024, the clients' masks
              interpolated from t+1 servers' shares, each the sorted
              message set; run_one_epoch(n=64, t=21, k=64, mix="powers")
              through the coordinator, untimed. Then (``apps_timing``,
              pools dealt outside every window) each fixed-point op's ms,
              rate, device busy, launches and peak bytes; a warm power-mix
              epoch per k, messages/s, split into compute_power_shares
              (its launches, device busy and peak bytes), the two opens,
              power_sums and the host root finder; a warm butterfly
              epoch's messages/s online and with the refill of rounds * k
              = 102,400 triples at phase 10's triple rate, and the offline
              fraction; the phase's seconds
 23 fused     with the launch counts as in 20: the bench's jubjub_add_double
              program through run_fused (a CUDA graph captured once per
              shape, replayed per call) at B = 64 and 4,096 on the points
              i*GP, opened against 3*P_i and word for word against the
              program called eagerly on the same pool slices; a second
              call hits the cache (no capture, fresh pools); a replay
              after the public-constant cache was cleared and 4,096 junk
              tensors allocated (the graph pins what it reads); the
              argument shares of 21 parties falsified: one eager redo
              with robust opens, the honest points; jubjub_mul_jit(0xFFFF)
              at B = 64 (16 replays of one ladder step) against
              0xFFFF*P_i and word for word against its step looped
              eagerly, and the eager montgomery_mul against 0xFFFF*P_i;
              share_mul of a 64-bit shared key against key*GP;
              key_generation, mimc_encrypt of 64 messages and
              mimc_decrypt round trip; no plain version on the card. Then (``fused_timing``) both bench rows
              (point_ops_per_s = 2B/dt, muls_per_s = B/dt) eager (the
              program itself; the ladder step looped over the bits) and
              replayed, each with kernels per call, device busy and peak
              bytes, the first call's build (counting pass, warm-up,
              capture) apart, the phase's seconds

The last line of the output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Bounds. ``bound_ms`` is the least time the card could take: the larger of
bytes moved (each input read once, each output written once) over 3.35
TB/s and operations over the peak for their type — 1,979 TOP/s for the
int8 dots (H100 SXM, dense). The sampler does 32-bit integer work on the
CUDA cores, for which the data sheet names no rate; its bound uses the
card's instruction-rate limit, 33.5 T instructions/s (4 warp instructions
per SM and clock, the same 128 lanes that give 67 TFLOP/s of float32 at 2
flop each), over the least number of instructions the function needs on
32-bit words (not the number the kernel's 16-bit limbs spend). The deal
kernel does both kinds of work (the sampler on the CUDA cores, the encode
dot on the tensor cores); its operation time is the larger of the two. The
packed finish functions are counted like the sampler; both come out bound
by their bytes. So are the robust open's elementwise multiply (on 8 words
of 32 bits) and the MXU epilogues (on the reference's 16-bit carry-save
limbs). The CIOS matmul is counted as one unreduced wide product per term
and one reduction per output (CIOS_TERM_OPS, CIOS_OUTPUT_OPS) and comes
out bound by its operations; the folded MXU kernel's int8 dot is counted as
the scheme runs it (37 x 37 digit products per operand and output). The
three-kernel open's dots are counted like the direct open's (32 diagonals
x 32k digits per lane and column), K3 decoding once; the flat finish like
the 4D one. The per-column extraction counts its dot at all n columns, the
check K2's per lane of the check tensor.
"""

import argparse
import itertools
import json
import math
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from honeybadgermpc_tpu_torch import _build  # noqa: E402
from honeybadgermpc_tpu_torch.ops import band_matmul as bm  # noqa: E402
from honeybadgermpc_tpu_torch.ops import field_kernels as fk  # noqa: E402
from honeybadgermpc_tpu_torch.ops import fused_open as fo  # noqa: E402
from honeybadgermpc_tpu_torch.ops import fused_open_direct as fod  # noqa: E402
from honeybadgermpc_tpu_torch.ops import fused_randousha as fr  # noqa: E402
from honeybadgermpc_tpu_torch.ops import montgomery as mont  # noqa: E402
from honeybadgermpc_tpu_torch.ops import mxu_matmul as mxu  # noqa: E402
from honeybadgermpc_tpu_torch.ops.band_gemm import (  # noqa: E402
    SMEM_MAX, _gemm_band_index, _gemm_split, smem_bytes)
from honeybadgermpc_tpu_torch.ops.fparray import (  # noqa: E402
    FpArray, dev_const)
from honeybadgermpc_tpu_torch.ops.fpmatmul import (  # noqa: E402
    _decode_validate_np, _lagrange_matrix_np, _matmul_kernel,
    _vandermonde_int_rows)
from honeybadgermpc_tpu_torch.ops.fused_open import (  # noqa: E402
    PL, _lam_int, pack_limbs, unpack_limbs)
from honeybadgermpc_tpu_torch.ops.limbs import L, P, R_MOD_P  # noqa: E402
from honeybadgermpc_tpu_torch.parallel import \
    reconstruct as rec  # noqa: E402
from honeybadgermpc_tpu_torch.parallel.mesh import SimBackend  # noqa: E402
from honeybadgermpc_tpu_torch.parallel.reconstruct import \
    _sim_reconstruct_packed_jit  # noqa: E402
from honeybadgermpc_tpu_torch.runtime.offline import \
    sim_offline_jit  # noqa: E402
from honeybadgermpc_tpu_torch.runtime.preprocessing import \
    PreProcessedElements  # noqa: E402

N, T = 64, 21
K = T + 1
C = 768
SEG = K * C                       # 16896 sharings per segment
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
INT32_OPS_PER_S = 67e12 / 2     # 128 lanes x 1 instruction
# Least 32-bit integer instructions per sampled element, for the function
# (csrc/rand_limbs.cu works on the same 32-bit words): with
# multiply-add-with-carry, counting what the hardware can fuse (three-input
# adds and logic) as one. 6 Threefry calls x (20 rounds x (add, rotate,
# xor) + 2 + 5 x 2 key adds) give the 12 words; REDC by 2^-144 is four
# 32-bit rounds and one 16-bit round x (m + 8 x (low, high half
# multiply-add) + 2 for the carry out); 8 funnel shifts realign the odd 16
# bits; conditional subtract 8 + 8; 16 for the 16-bit limbs of the output.
RAND_OPS_PER_ELEMENT = 6 * (20 * 3 + 2 + 10) + 5 * (1 + 8 * 2 + 2) + 8 \
    + 16 + 16
KT = 4096                         # slots of one triple call
# the eager programs' encodes: band_matmul at B = n x KT with k = t+1, 2t+1
# and n (randousha with the fallback runs k = 22, 43, 64, 64)
EAGER_BAND_K = (K, 2 * T + 1, N)
# row 3's comparisons: every lane-tile size of the wgmma core (64, 128 and
# 256 lanes), ragged last tiles at each, m = 1 and 5 (a half-used two-column
# tile), k = 1 to 64, the open's shape and the eager programs'
BAND_SHAPES = ((1, 1, 1), (63, 3, 5), (64, 22, 64), (65, 43, 128),
               (63, 64, 1), (65, 1, 5), (64, 64, 128), (16961, 43, 64),
               (33850, 22, 5), (SEG, K, N),
               *((N * KT, k, N) for k in EAGER_BAND_K))
N_OUT = N - 2 * T                 # 22 extracted sharings per slot
N_OUTP = -(-N_OUT // 8) * 8       # 24 rows of the padded keep tensor
NCHECKP = -(-2 * T // 8) * 8      # 48 columns of the padded check tensor
# Least 32-bit integer instructions per element of the packed finish
# functions, same counting: the operands arrive as 8 words of 32 bits, so
# nothing is unpacked. mul_add: a 256-bit Montgomery product is 8 x 8 x
# (low, high half multiply-add) for the product and as many for the
# reduction, plus 8 for m and 8 x 2 carries out; its conditional subtract
# 8 + 8; the add 8 and its conditional subtract 8 + 8. sub_bcast: borrow
# chain 8, add-back chain 8, select 8. (csrc/packed_arith.cu works on
# 16-bit limbs and spends about eight times as many; that is the kernel's
# choice, not the function's need.)
MUL_ADD_OPS_PER_ELEMENT = 2 * (8 * 8 * 2) + 8 + 16 + 16 + 8 + 16
SUB_BCAST_OPS_PER_ELEMENT = 8 + 8 + 8
OPEN_PATH_KERNELS = ("open_direct", "band_matmul", "rand_limbs")
K3_KERNEL = "open_fused_k3_core_kernel"   # K3 on the wgmma core
# the direct open's large-k route (fused_open_direct._direct_route): k = 86
# at n = 128 is above the core's k <= 81
LARGE_K = (128, 85)
# kernel name -> (module, name of its launch counter there)
KERNEL_COUNTERS = {
    "open_direct": (fod, "launches"),
    "open_direct_mma": (fod, "launches_mma"),
    "band_matmul": (bm, "launches"),
    "rand_limbs": (fk, "launches"),
    "randousha_deal": (fr, "launches_deal"),
    "randousha_extract": (fr, "launches_extract"),
    "mul_add_packed4": (fk, "launches_mul_add4"),
    "sub_bcast_packed4": (fk, "launches_sub_bcast4"),
    "mont_mul": (fk, "launches_mont_mul"),
    "fp_matmul_cios": (fk, "launches_matmul"),
    "mxu_fused2": (mxu, "launches_fused2"),
    "mxu_fused": (mxu, "launches_fused"),
    "mxu_redc": (mxu, "launches_redc"),
    "open_fused_k1": (fo, "launches_k1"),
    "open_fused_k2": (fo, "launches_k2"),
    "open_fused_k3": (fo, "launches_k3"),
    "mul_add_packed": (fk, "launches_mul_add"),
    "randousha_extract_pc": (fr, "launches_extract_pc"),
    "randousha_check": (fr, "launches_check"),
    "sub_bcast_packed": (fk, "launches_sub_bcast"),
}
# plain versions run on CUDA tensors (module, counter): the card's paths
# must leave them at 0; only the comparisons with the kernels move them
PLAIN_COUNTERS = {
    "mont_mul_plain": (mont, "plain_calls_on_cuda"),
    "mxu_matmul_plain": (mxu, "plain_calls_on_cuda"),
    "open_fused_plain": (fo, "plain_calls_on_cuda"),
    "open_direct_plain": (fod, "plain_calls_on_cuda"),
    "fused_randousha_plain": (fr, "plain_calls_on_cuda"),
    "sub_bcast_packed_plain": (fk, "plain_calls_on_cuda"),
}
# Least 32-bit integer instructions per Montgomery product on 8 words of 32
# bits, counted as for MUL_ADD_OPS_PER_ELEMENT without its add: 8 x 8 x
# (low, high half multiply-add) for the product and as many for the
# reduction, 8 for m, 8 x 2 carries out, conditional subtract 8 + 8. A
# modular add is 8 + 8 + 8.
MONT_MUL_OPS = 2 * (8 * 8 * 2) + 8 + 16 + 16
# Least per term of a CIOS matmul output: the 512-bit product added into an
# unreduced wide sum, 8 rows x 2 chains x (8 multiply-adds + 1 carry add);
# per output: one reduction of the sum (as much, and 8 for the m's), the
# fold of the carry words (9) and five 9-word conditional subtracts (5 x 18)
CIOS_TERM_OPS = 8 * 2 * (8 + 1)
CIOS_OUTPUT_OPS = CIOS_TERM_OPS + 8 + 9 + 5 * 18
# Least integer instructions per output element of the MXU epilogues on
# 16-bit carry-save limbs (the reference's own fold): each diagonal pair
# costs an add and a shift, its three chunks 6 operations and 3 adds; a
# REDC round is m (2) + 16 multiply-adds split into low and high halves
# (48) + the shift (2); the carry chain 3 x 16; a conditional subtract
# 3 x 16 + 16 selects.
FOLD37_OPS_BASE = 19 * 11 + 48 + 2 * 64       # + 52 per REDC round
REDC73_OPS = 37 * 11 + 17 * 52 + 48 + 64
BAD_PARTIES = tuple(range(0, 3 * T, 3))     # 21 parties, both sides of k
PROGRAMS = ("randousha", "generate_triples", "generate_bits")
# chunk counts of the eager randousha's check opens at k = 4096 slots:
# 4096 * 2t = 172,032 columns per party, padded to a multiple of t+1 = 22
# (7820 chunks) and of 2t+1 = 43 (4001 chunks)
C_T = -(-KT * 2 * T // K)
C_2T = -(-KT * 2 * T // (2 * T + 1))
FAULT_KT = 16                     # slots of the in-program fault case


def say(phase, **rec):
    print(json.dumps({"phase": phase, **rec}), flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def sync():
    torch.cuda.synchronize()


def time_ms(fn, reps):
    """Mean device time of fn() over `reps` calls (CUDA events, warm)."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps, kernel_name):
    """Mean device time of one launch of the CUDA kernel `kernel_name`
    over `reps` calls of fn() (one launch each), from the profiler's device
    trace (so host time between launches does not count): the mean over
    the launches the trace holds. The profiler may drop events, and the
    result must not depend on it: where the trace holds fewer than half of
    the launches, CUDA events around the `reps` calls instead (which count
    host time between launches only where the kernel is shorter than it)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel_name in ev.key:
            total_us += getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0))
            count += ev.count
    if total_us <= 0.0 or 2 * count < reps:
        return time_ms(fn, reps), f"cuda_events (trace held {count} " \
            f"of {reps} launches)"
    return total_us / count / 1e3, f"profiler ({count} of {reps} launches)"


def max_abs_err(a, b):
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def timed_once(fn):
    """Device time in ms of one call of fn() (CUDA events). The caller has
    run fn() before, so the allocator is warm."""
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    sync()
    return start.elapsed_time(end)


def reset_launches():
    for mod, attr in list(KERNEL_COUNTERS.values()) + \
            list(PLAIN_COUNTERS.values()):
        setattr(mod, attr, 0)


def read_launches():
    return {name: getattr(mod, attr)
            for name, (mod, attr) in KERNEL_COUNTERS.items()}


def read_plain():
    return {name: getattr(mod, attr)
            for name, (mod, attr) in PLAIN_COUNTERS.items()}


# -- bounds ------------------------------------------------------------------

def bound(nbytes, ops, ops_per_s):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def open_bound(n, k, b):
    nv = n - k
    nbytes = 4 * PL * n * b + (nv + 1) * 8 * k * 128 + 4 * PL * b + 4 * nv
    ops = 2 * (nv + 1) * 32 * 32 * k * b
    return bound(nbytes, ops, INT8_OPS_PER_S)


def band_bound(b, k, m):
    nbytes = 4 * PL * b * k + m * 8 * k * 128 + 4 * PL * b * m
    ops = 2 * m * 32 * 32 * k * b
    return bound(nbytes, ops, INT8_OPS_PER_S)


def rand_bound(numel):
    return bound(4 * L * numel, RAND_OPS_PER_ELEMENT * numel, INT32_OPS_PER_S)


def deal_bound(n, k, sp):
    """Writes the receive tensor, reads the band; the encode dot on the
    tensor cores and the sampler on the CUDA cores, whichever is longer."""
    b = n * sp
    nbytes = 4 * PL * n * b + n * 8 * k * 128
    dot_ms = 2 * n * 32 * 32 * k * b / INT8_OPS_PER_S * 1e3
    draw_ms = RAND_OPS_PER_ELEMENT * k * b / INT32_OPS_PER_S * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = max(dot_ms, draw_ms)
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


def extract_bound(n, n_out, n_outp, sp):
    b = n * sp
    nbytes = 4 * PL * b * (n + n_outp + 1) + (n_out + 1) * 8 * n * 128
    ops = 2 * (n_out + 1) * 32 * 32 * n * b
    return bound(nbytes, ops, INT8_OPS_PER_S)


def mul_add_bound(numel):
    return bound(4 * 4 * PL * numel, MUL_ADD_OPS_PER_ELEMENT * numel,
                 INT32_OPS_PER_S)


def sub_bcast_bound(numel, n):
    return bound(4 * PL * (2 * numel + numel // n),
                 SUB_BCAST_OPS_PER_ELEMENT * numel, INT32_OPS_PER_S)


# -- phase 3: kernels against their plain versions ---------------------------

def deal_packed(dev, n, deg, b, key):
    """Packed shares [PL, n, b] of b random degree-`deg` sharings, dealt
    with the band matmul kernel (b a multiple of deg+1)."""
    k = deg + 1
    coeffs = pack_limbs(fk.rand_limbs(key, b * k, dev).reshape(L, b, k))
    mat = _vandermonde_int_rows(tuple(range(1, n + 1)), k)
    return bm.band_matmul_packed(coeffs, mat).permute(0, 2, 1).contiguous()


def compare_rand(dev, numel):
    got = fk.rand_limbs((11, 12), numel, dev)
    want = fk._rand_limbs_plain((11, 12), numel, dev)
    sync()
    check(torch.equal(got, want), f"rand_limbs != plain at numel={numel}")
    return max_abs_err(got, want)


def compare_band(dev, b, k, m):
    """band_matmul against its plain version, bit for bit, and a Python-int
    sample: out = sum_i a_i * mat[i][col] holds in Montgomery form too."""
    a = pack_limbs(fk.rand_limbs((21, k), b * k, dev).reshape(L, b, k))
    mat = _vandermonde_int_rows(tuple(range(1, m + 1)), k)
    got = bm.band_matmul_packed(a, mat)
    want = bm._band_matmul_plain(a, mat)
    sync()
    check(torch.equal(got, want), f"band_matmul != plain at {(b, k, m)}")
    for bb, col in sorted({(0, 0), (b - 1, m - 1), (b // 2, m // 2)}):
        ai = packed_ints(a[:, bb], list(range(k)))
        check(packed_ints(got[:, bb, col], [0])[0]
              == sum(x * mat[i][col] for i, x in enumerate(ai)) % P,
              f"band_matmul != Python ints at {(b, k, m)} [{bb}, {col}]")
    return max_abs_err(got, want), a, mat


def deal_packed_plain(dev, n, deg, b, key):
    """deal_packed for a degree above band_matmul's k <= 64: the encode
    through band_matmul's plain version on the card."""
    k = deg + 1
    coeffs = pack_limbs(fk.rand_limbs(key, b * k, dev).reshape(L, b, k))
    mat = _vandermonde_int_rows(tuple(range(1, n + 1)), k)
    return bm._band_matmul_plain(coeffs, mat).permute(0, 2, 1).contiguous()


def tolerated_parties(n, t):
    """t parties spread over 0..n-1, on both sides of k = t + 1."""
    return sorted({(i * n) // t for i in range(t)})


def open_faults(shares, n, t):
    """The direct open's fault cases: name -> faulted shares [PL, n, B] and
    the per-party counts they must give (None: the plain version's only)."""
    k, b = t + 1, shares.shape[-1]
    cases = {"honest": (shares, [0] * n)}
    x = shares.clone()
    x[3, n - 1, b // 2] ^= 0x2482                  # a validating party
    x[0, 0, b - 1] ^= 1                            # an interpolating party
    cases["validating_and_interpolating"] = (x, None)
    # two lanes of one warp and 64-lane block at the last compare column:
    # one atomic for both
    x = shares.clone()
    x[3, n - 1, 3] ^= 0x10
    x[0, n - 1, 12] ^= 1
    cases["two_lanes_last_column"] = (x, [0] * (n - 1) + [2])
    x = shares.clone()
    x[7, k, b - 1] ^= 0x40000000                   # the first compare column
    cases["first_column"] = (x, [0] * k + [1] + [0] * (n - k - 1))
    x = shares.clone()                             # t faulty parties
    for p in tolerated_parties(n, t):
        x[p % PL, p] ^= p + 1
    cases["t_faulty_parties"] = (x, None)
    return cases


def compare_open(dev, n, t, b):
    """The direct open's kernel (the route k takes: the wgmma core up to
    k = 81, the mma.sync kernel above) against its plain version on every
    case of open_faults: secrets and per-source counts equal, the counts
    where a case fixes them."""
    k = t + 1
    pts = tuple(range(1, n + 1))
    route = fod._direct_route(k)
    deal = deal_packed if k <= fo.KMAX else deal_packed_plain
    shares = deal(dev, n, t, b, (31, n))
    worst = 0
    for name, (x, want) in open_faults(shares, n, t).items():
        before = (fod.launches, fod.launches_mma)
        sec, errs = fod._open_direct_cuda(x, n, k, pts)
        sec_p, errs_p = fod._open_direct_plain(x, n, k, pts)
        sync()
        moved = (fod.launches - before[0], fod.launches_mma - before[1])
        check(moved == ((1, 0) if route == "wgmma" else (0, 1)),
              f"open_direct at k={k} took the wrong route: {moved}")
        check(torch.equal(sec, sec_p) and torch.equal(errs, errs_p),
              f"open_direct ({route}) != plain at n={n} t={t} B={b} {name}")
        check((int(errs.sum()) > 0) == (name != "honest"),
              f"open_direct verdict wrong at n={n} t={t} {name}")
        check(want is None or errs.tolist() == want,
              f"open_direct counts at n={n} t={t} {name}: {errs.tolist()}")
        check(not bool(errs[:k].any()),
              f"open_direct charged an interpolating party at {name}")
        worst = max(worst, max_abs_err(sec, sec_p), max_abs_err(errs, errs_p))
    return worst, shares, pts


def phase_kernels(dev):
    t0 = time.perf_counter()
    err = {"open_direct": 0, "band_matmul": 0, "rand_limbs": 0}
    shapes = []
    # one element, one and two blocks' elements either side, a large odd
    # count, one pass of the resident grid and either side of it, the
    # open path's draws
    wave = fk.rand_wave()
    for numel in (1, 77, 255, 257, 5000, 131071, wave - 1, wave, wave + 1,
                  SEG, SEG * T):
        err["rand_limbs"] = max(err["rand_limbs"], compare_rand(dev, numel))
        shapes.append(f"rand_limbs numel={numel}")
    band_in = {}
    for b, k, m in BAND_SHAPES:
        e, a, mat = compare_band(dev, b, k, m)
        err["band_matmul"] = max(err["band_matmul"], e)
        shapes.append(f"band_matmul B={b} k={k} m={m}")
        if (b, m) in ((SEG, N), (N * KT, N)):
            band_in[b, k] = (a, mat)
        del a, mat
        torch.cuda.empty_cache()
    a_main, mat_main = band_in[SEG, K]
    # the large-k route (k = 86 > 81: the mma.sync kernel), then small,
    # unaligned, the degree-2t open (k = 43) and the main path's shape
    n_l, t_l = LARGE_K
    e, shares_l, pts_l = compare_open(dev, n_l, t_l, (t_l + 1) * 64)
    err["open_direct_mma"] = e
    shapes.append(f"open_direct n={n_l} k={t_l + 1} B={(t_l + 1) * 64} "
                  f"(mma.sync route)")
    for n, t, b in ((8, 2, 48), (7, 2, 33), (N, 2 * T, 43 * 392),
                    (N, T, SEG)):
        e, shares_main, pts = compare_open(dev, n, t, b)
        err["open_direct"] = max(err["open_direct"], e)
        shapes.append(f"open_direct n={n} k={t + 1} B={b} "
                      f"({len(open_faults(shares_main, n, t))} cases)")
    faulty_main = open_faults(shares_main, N, T)["t_faulty_parties"][0]

    # times at the main-path shapes (the band dots are far from the memory
    # bound, so a warm L2 does not flatter them; the open is also timed over
    # 64 distinct segments in phase 7)
    times = {
        "open_direct": (
            kernel_ms(lambda: fod._open_direct_cuda(shares_main, N, K, pts),
                      20, "open_direct_kernel"),
            time_ms(lambda: fod._open_direct_plain(shares_main, N, K, pts), 3),
            open_bound(N, K, SEG)),
        # a segment with 21 faulty parties: every compare column of every
        # lane mismatches, one atomic per warp, column and 64-lane block
        "open_direct_faulty": (
            kernel_ms(lambda: fod._open_direct_cuda(faulty_main, N, K, pts),
                      20, "open_direct_kernel"),
            time_ms(lambda: fod._open_direct_plain(faulty_main, N, K, pts),
                    3),
            open_bound(N, K, SEG)),
        "open_direct_mma": (
            kernel_ms(lambda: fod._open_direct_cuda(shares_l, n_l, t_l + 1,
                                                    pts_l),
                      20, "open_direct_mma_kernel"),
            time_ms(lambda: fod._open_direct_plain(shares_l, n_l, t_l + 1,
                                                   pts_l), 3),
            open_bound(n_l, t_l + 1, (t_l + 1) * 64)),
        "band_matmul": (
            kernel_ms(lambda: bm.band_matmul_packed(a_main, mat_main), 20,
                      "band_matmul_kernel"),
            time_ms(lambda: bm._band_matmul_plain(a_main, mat_main), 3),
            band_bound(SEG, K, N)),
        "rand_limbs": (
            kernel_ms(lambda: fk.rand_limbs((1, 2), SEG * T, dev), 50,
                      "rand_limbs_kernel"),
            time_ms(lambda: fk._rand_limbs_plain((1, 2), SEG * T, dev), 3),
            rand_bound(SEG * T)),
    }
    # row 3 at the eager programs' encodes (B = n x 4096 slots)
    for k in EAGER_BAND_K:
        a, mat = band_in[N * KT, k]
        times[f"band_matmul_eager_k{k}"] = (
            kernel_ms(lambda: bm.band_matmul_packed(a, mat), 10,
                      "band_matmul_kernel"),
            timed_once(lambda: bm._band_matmul_plain(a, mat)),
            band_bound(N * KT, k, N))
    del band_in, a, mat, shares_l, faulty_main
    torch.cuda.empty_cache()
    say("kernels_vs_plain", ok=True, tolerance="exact (torch.equal)",
        shapes=shapes, timed_by={k: v[0][1] for k, v in times.items()},
        seconds=round(time.perf_counter() - t0, 3))
    return err, {k: (v[0][0], v[1], v[2]) for k, v in times.items()}


# -- phases 4-7: the main path -----------------------------------------------

def deal_segments(pre, nseg):
    segs = []
    for _ in range(nseg):
        pre.generate_rands(SEG)
        segs.append(pack_limbs(pre.get_rands(SEG).limbs))
    return segs


def mont_ints(packed_cols):
    """Packed words [PL, ...] on the card -> Python ints (still in
    Montgomery form; Lagrange interpolation is linear, so the oracle works
    on Montgomery-form values directly)."""
    limbs = unpack_limbs(packed_cols).cpu().numpy().astype("int64")
    flat = limbs.reshape(L, -1)
    vals = [sum(int(flat[j, i]) << (16 * j) for j in range(L))
            for i in range(flat.shape[1])]
    return vals, limbs.shape[1:]


def oracle_check(seg, sec, cols):
    """Opened secrets at `cols` against Python-int Lagrange interpolation
    at 0, once from the first K parties and once from the last K parties
    (which the kernel never interpolates from)."""
    idx = torch.tensor(cols, device=seg.device)
    shares, _ = mont_ints(seg[:, :, idx])                 # [n, len(cols)]
    opened, _ = mont_ints(sec[:, idx])
    for parties in (range(K), range(N - K, N)):
        lam = _lam_int([j + 1 for j in parties], 0)
        for ci in range(len(cols)):
            want = sum(l * shares[j * len(cols) + ci]
                       for l, j in zip(lam, parties)) % P
            check(opened[ci] == want, f"opened secret != oracle at column "
                                      f"{cols[ci]} from parties {parties}")


def phase_main(dev, nseg, reps):
    run = _sim_reconstruct_packed_jit(N, T, False, True, fallback=False,
                                      replicate=False)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    pre = PreProcessedElements(N, T, seed=0)
    segs = deal_segments(pre, nseg)
    sync()
    deal_s = time.perf_counter() - t0
    outs = [run(s) for s in segs]
    sync()
    launches = read_launches()
    total_s = time.perf_counter() - t0

    nerr = sum(int(o[1].sum()) for o in outs)
    check(nerr == 0, f"main path: nerr = {nerr} on honest shares")
    for name in OPEN_PATH_KERNELS:
        check(launches[name] > 0,
              f"main path never launched the {name} kernel")
    check(launches["open_direct"] == nseg and launches["open_direct_mma"] == 0,
          "one open launch per segment, on the wgmma core")
    for sec, ne in outs:
        check(tuple(sec.shape) == (PL, SEG) and sec.dtype == torch.int32
              and tuple(ne.shape) == (N,), "opened shapes")
    cols = [0, 1, C - 1, C, SEG // 2 + 5, SEG - 1]
    for si in sorted({0, nseg // 2, nseg - 1}):
        oracle_check(segs[si], outs[si][0], cols)
    check(not torch.equal(outs[0][0], outs[-1][0]) or nseg == 1,
          "segments must hold different secrets")
    say("main_path", ok=True, n=N, t=T, segments=nseg, sharings=nseg * SEG,
        packed_share_bytes=sum(s.numel() * 4 for s in segs),
        peak_device_bytes=torch.cuda.max_memory_allocated(),
        launches=launches, nerr=nerr,
        oracle_columns_checked=len(cols) * len({0, nseg // 2, nseg - 1}),
        seconds=round(total_s, 3))

    # phase 5: fault detection
    seg = segs[nseg // 2]
    bad = seg.clone()
    z = K + 7
    bad[5, z, 1234] ^= 0x10
    _, ne = run(bad)
    check(int(ne[z]) > 0 and int(ne.sum()) == int(ne[z]),
          f"fault at party {z} not charged to it: {ne.tolist()}")
    bad = seg.clone()
    bad[2, 3, 99] ^= 0x4000
    _, ne2 = run(bad)
    check(int(ne2.sum()) > 0 and int(ne2[:K].sum()) == 0,
          "fault at an interpolating party not detected")
    say("fault_detection", ok=True, party=z, nerr_at_party=int(ne[z]),
        nerr_sum_interpolating_fault=int(ne2.sum()))

    # phase 6: state across save/load
    pre.generate_rands(SEG)
    tmp = tempfile.mkdtemp(prefix="hbmpc_smoke_")
    try:
        pre.save(tmp)
        fresh = PreProcessedElements(N, T, seed=123)
        fresh.load(tmp)
        saved_bytes = sum(os.path.getsize(os.path.join(tmp, f))
                          for f in os.listdir(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a = pack_limbs(pre.get_rands(SEG).limbs)
    b = pack_limbs(fresh.get_rands(SEG).limbs)
    (sa, ea), (sb, eb) = run(a), run(b)
    check(torch.equal(a, b) and torch.equal(sa, sb) and int(ea.sum()) == 0
          and int(eb.sum()) == 0, "state across save/load differs")
    say("state_across", ok=True, saved_bytes=saved_bytes)

    # phase 7: timing over the resident segments (cold L2: 2.2 GB of input)
    for s in segs:
        run(s)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        for s in segs:
            run(s)
    sync()
    open_s = (time.perf_counter() - t0) / reps
    # the dealer again, warm: the first pass above also grew the allocator
    nwarm = min(nseg, 8)
    deal_segments(pre, nwarm)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        deal_segments(pre, nwarm)
    sync()
    warm_s = (time.perf_counter() - t0) / reps
    return launches, {"opened_sharings_per_s": nseg * SEG / open_s,
                      "open_ms_per_segment": open_s / nseg * 1e3,
                      "dealt_sharings_per_s": nwarm * SEG / warm_s,
                      "dealt_party_shares_per_s": nwarm * SEG * N / warm_s,
                      "deal_ms_per_segment": warm_s / nwarm * 1e3,
                      "first_pass_deal_ms_per_segment": deal_s / nseg * 1e3,
                      "timed_repeats": reps}


# -- offline path: the four kernels against their plain versions -------------

def deal_plain_full(key, n, t, degree, sp, pts, dev, window=512):
    """The deal's plain version over all sp slots, `window` slots at a time
    (its int64 dot intermediates at 64 x 4096 lanes would take gigabytes)."""
    parts = [fr._randousha_deal_plain(key, n, t, degree, sp, pts, dev,
                                      slot0=s0,
                                      nslot=min(window, sp - s0))
             for s0 in range(0, sp, window)]
    return torch.cat(parts, dim=-1)


def lane_tiles(k):
    """64-lane blocks per thread block whose planes of k operands fit
    shared memory: every lane tile a plan may launch for k."""
    return [mb for mb in (4, 2, 1) if smem_bytes(k, mb) <= SMEM_MAX]


def plans_text(k):
    return ", ".join(str(64 * mb) for mb in lane_tiles(k))


def compare_deal(dev, n, t, degree, sp, key):
    """The deal against its plain version through its wrapper, then at
    every lane tile that fits (its plan picks one by k and lane count) on
    an output filled with nonzero bytes: every word must be written."""
    pts = fr._party_points(n)
    got = fr.randousha_deal(key, n, t, degree, sp, pts, dev)
    want = deal_plain_full(key, n, t, degree, sp, pts, dev)
    sync()
    check(torch.equal(got, want),
          f"randousha_deal != plain at n={n} t={t} degree={degree} sp={sp}")
    launch = fr._deal_launcher(n, t, degree, sp, pts, dev)
    for mb in lane_tiles(launch.kk):
        junk = torch.full_like(want, 0x5A5A5A5A)
        rc, _ = launch(key, plan=mb, out=junk)
        sync()
        check(rc == 0 and torch.equal(junk, want),
              f"randousha_deal at {64 * mb}-lane tiles "
              f"on a 0x5A-filled output != plain at n={n} t={t} "
              f"degree={degree} sp={sp}")
        del junk
    return max_abs_err(got, want), got, pts


def compare_extract(dev, n, t, sp, key, cols):
    """The aggregated extraction against its plain version through its
    wrapper, then at every lane tile that fits on outputs filled with
    nonzero bytes (the dot's n_out + 1 columns end in a half-empty tile,
    keep rows n_out+1.. are written zero by the kernel's finish)."""
    run = fr._randousha_calls(n, t, sp, fr._party_points(n), device=dev)
    n_out, n_outp = run.meta[:2]
    band = run.folded_band(key)[0]
    keep, z = fr.randousha_extract(cols, band, n_out, n_outp)
    keep_p, z_p = fr._randousha_extract_plain(cols, band, n_out, n_outp)
    sync()
    check(torch.equal(keep, keep_p) and torch.equal(z, z_p),
          f"randousha_extract != plain at n={n} t={t} sp={sp}")
    check(torch.equal(keep[:, :, n_out], z)
          and not bool(keep[:, :, n_out + 1:].any()),
          "extract: row n_out must be the check sharing, rows above zero")
    launch = fr._extract_launcher(n, n_out, n_outp, band.shape[0] // 32,
                                  band.shape[1], None, dev)
    for mb in lane_tiles(n):
        junk = [torch.full_like(x, 0x5A5A5A5A) for x in (keep_p, z_p)]
        rc, _, _ = launch(cols, band, *junk, plan=mb)
        sync()
        check(rc == 0 and torch.equal(junk[0], keep_p)
              and torch.equal(junk[1], z_p),
              f"randousha_extract at {64 * mb}-lane tiles "
              f"on 0x5A-filled outputs != plain at n={n} t={t} sp={sp}")
        del junk
    return max(max_abs_err(keep, keep_p), max_abs_err(z, z_p)), keep, z, band


def compare_finish(dev, a, b, c, pad):
    """mul_add_packed4 (4D and flat form, unpadded and padded) and
    sub_bcast_packed4 (its minuend a prefix view of a longer tensor)
    against their plain versions."""
    _, n, r, s_ = a.shape
    got = fk.mul_add_packed4(a, b, c)
    want = fk._mul_add_packed4_plain(a, b, c)
    sync()
    check(torch.equal(got, want), f"mul_add_packed4 != plain at {a.shape}")
    for pd in (0, pad):
        flat = fk.mul_add_packed4_flat(a, b, c, pad=pd)
        sync()
        check(torch.equal(flat[:, :, :r * s_], want.reshape(PL, n, r * s_))
              and not bool(flat[:, :, r * s_:].any()),
              f"mul_add_packed4 flat form wrong at {a.shape} pad={pd}")
    err_ma = max_abs_err(got, want)
    long = torch.cat([got[:, 0].reshape(PL, r * s_),
                      got[:, 0].reshape(PL, r * s_)[:, :pad + 3]], dim=-1)
    minuend = long[:, :r * s_].reshape(PL, r, s_)     # planes lie apart
    got2 = fk.sub_bcast_packed4(minuend, b)
    want2 = fk._sub_bcast_packed4_plain(minuend, b)
    sync()
    check(torch.equal(got2, want2), f"sub_bcast_packed4 != plain at {b.shape}")
    return err_ma, max_abs_err(got2, want2), minuend


def phase_kernels_offline(dev):
    t0 = time.perf_counter()
    err = {"randousha_deal": 0, "randousha_extract": 0,
           "mul_add_packed4": 0, "sub_bcast_packed4": 0}
    shapes = []
    # small: n=8, t=2, one slot tile; values < p in every limb pattern come
    # from the deal itself
    for degree in (2, 4):
        e, cols_s, _ = compare_deal(dev, 8, 2, degree, 128, (5, 6))
        err["randousha_deal"] = max(err["randousha_deal"], e)
        shapes.append(f"randousha_deal n=8 t=2 degree={degree} sp=128, "
                      f"lane tiles {plans_text(degree + 1)} on "
                      "0x5A-filled outputs")
        e, keep_s, _, _ = compare_extract(dev, 8, 2, 128, (5, 6), cols_s)
        err["randousha_extract"] = max(err["randousha_extract"], e)
        shapes.append(f"randousha_extract n=8 t=2 sp=128 (degree {degree}; "
                      "5 columns: a half-empty last tile, zero keep rows "
                      f"5-7), lane tiles {plans_text(8)}")
    sm = keep_s[:, :3, :5, :77].contiguous()           # unaligned [8,3,5,77]
    e1, e2, _ = compare_finish(dev, sm, sm.flip(3), sm.flip(2), 7)
    err["mul_add_packed4"], err["sub_bcast_packed4"] = e1, e2
    shapes.append("mul_add_packed4, sub_bcast_packed4 [8,3,5,77] pad 0, 7")
    # odd n and R*S, one party, one element, and every operand at p - 1
    pm1 = torch.tensor(P_WORDS_SIGNED[1], dtype=torch.int32, device=dev)
    for shape, pad in (((7, 3, 43), 1), ((1, 1, 127), 42), ((1, 1, 1), 0)):
        x = keep_s[:, :shape[0], :shape[1], :shape[2]].contiguous()
        e1, e2, _ = compare_finish(dev, x, x.flip(3), x.flip(1), pad)
        full = pm1.reshape(PL, 1, 1, 1).expand(PL, *shape).contiguous()
        e3, e4, _ = compare_finish(dev, full, full, full, pad)
        err["mul_add_packed4"] = max(err["mul_add_packed4"], e1, e3)
        err["sub_bcast_packed4"] = max(err["sub_bcast_packed4"], e2, e4)
        shapes.append(f"mul_add_packed4, sub_bcast_packed4 [8,{shape[0]},"
                      f"{shape[1]},{shape[2]}] pad 0, {pad}; and every "
                      "operand at p - 1")

    # main-path width: n=64, t=21, all 4096 slots, both degrees
    key = (41, 42)
    e, cols_t, pts = compare_deal(dev, N, T, T, KT, key)
    err["randousha_deal"] = max(err["randousha_deal"], e)
    e, keep_t, _, band = compare_extract(dev, N, T, KT, key, cols_t)
    err["randousha_extract"] = max(err["randousha_extract"], e)
    e, cols_2t, _ = compare_deal(dev, N, T, 2 * T, KT, key)
    err["randousha_deal"] = max(err["randousha_deal"], e)
    check(not torch.equal(cols_t, cols_2t), "the two degrees must differ")
    e, keep_2t, _, _ = compare_extract(dev, N, T, KT, key, cols_2t)
    err["randousha_extract"] = max(err["randousha_extract"], e)
    shapes += [f"randousha_deal n={N} t={T} degree={d} sp={KT} (all slots), "
               f"lane tiles {plans_text(d + 1)}" for d in (T, 2 * T)]
    shapes.append(f"randousha_extract n={N} t={T} sp={KT} (both degrees; "
                  f"{N_OUT + 1} columns: a half-empty last tile, zero keep "
                  f"row {N_OUT + 1}), lane tiles {plans_text(N)}")
    del cols_2t
    keep_b = keep_t.roll(1, dims=3)                    # a second operand
    pad = (-N_OUTP * KT) % (2 * T + 1)
    e1, e2, minuend = compare_finish(dev, keep_t, keep_b, keep_2t, pad)
    err["mul_add_packed4"] = max(err["mul_add_packed4"], e1)
    err["sub_bcast_packed4"] = max(err["sub_bcast_packed4"], e2)
    shapes.append(f"mul_add_packed4, sub_bcast_packed4 [8,{N},{N_OUTP},{KT}]"
                  f" pad 0, {pad}")

    n_out, n_outp = N_OUT, N_OUTP
    numel = N * N_OUTP * KT
    times = {}
    for name, degree in (("randousha_deal", T),
                         ("randousha_deal_2t", 2 * T)):
        times[name] = (
            kernel_ms(lambda d=degree: fr.randousha_deal(key, N, T, d, KT,
                                                         pts, dev),
                      10, "randousha_deal_kernel"),
            timed_once(lambda d=degree: deal_plain_full(key, N, T, d, KT,
                                                        pts, dev)),
            deal_bound(N, degree + 1, KT))
    times["randousha_extract"] = (
        kernel_ms(lambda: fr.randousha_extract(cols_t, band, n_out, n_outp),
                  10, "randousha_extract_kernel"),
        timed_once(lambda: fr._randousha_extract_plain(cols_t, band, n_out,
                                                       n_outp)),
        extract_bound(N, n_out, n_outp, KT))
    times["mul_add_packed4"] = (
        kernel_ms(lambda: fk.mul_add_packed4_flat(keep_t, keep_b, keep_2t,
                                                  pad=pad),
                  10, "mul_add_packed4_kernel"),
        timed_once(lambda: fk._mul_add_packed4_plain(keep_t, keep_b,
                                                     keep_2t)),
        mul_add_bound(numel))
    times["sub_bcast_packed4"] = (
        kernel_ms(lambda: fk.sub_bcast_packed4(minuend, keep_t), 10,
                  "sub_bcast_packed4_kernel"),
        timed_once(lambda: fk._sub_bcast_packed4_plain(minuend, keep_t)),
        sub_bcast_bound(numel, N))
    say("offline_kernels_vs_plain", ok=True,
        tolerance="exact (torch.equal)", shapes=shapes,
        timed_by={k: v[0][1] for k, v in times.items()},
        seconds=round(time.perf_counter() - t0, 3))
    return err, {k: (v[0][0], v[1], v[2]) for k, v in times.items()}


# -- phases 8-10: verified Beaver triples ------------------------------------

def open_rows(run, p4):
    """Open a packed 4D share tensor [PL, n, R, S] at degree t -> (opened
    [PL, R, S], nerr [n]); the column count is padded to a multiple of
    t+1 with zero sharings."""
    _, n, r, s_ = p4.shape
    flat = p4.reshape(PL, n, r * s_)
    pad = (-r * s_) % K
    if pad:
        flat = torch.cat([flat, flat.new_zeros((PL, n, pad))], dim=-1)
    sec, nerr = run(flat)
    return sec[:, :r * s_].reshape(PL, r, s_), nerr


def plain_int(packed_word_col):
    """One packed element [PL] on the card -> its plain residue (out of
    Montgomery form) as a Python int."""
    limbs = unpack_limbs(packed_word_col.reshape(PL, 1)).cpu().tolist()
    v = sum(int(limbs[j][0]) << (16 * j) for j in range(L))
    return v * pow(R_MOD_P, P - 2, P) % P


def flip_word(degree_hit):
    def tamper(cols, degree):
        if degree == degree_hit:
            cols[3, 5, 7, KT // 4 + 1] ^= 0x10   # dealer 7's share for party 5
        return cols
    return tamper


def stage_times(fn, reps):
    """Device time per call of every stage of fn(i), from the profiler's
    device trace: the port's kernels by name, everything else (PyTorch's
    own elementwise and copy kernels) as 'other'."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = ("randousha_deal_kernel", "randousha_extract_kernel",
             "open_direct_kernel", "mul_add_packed4_kernel",
             "sub_bcast_packed4_kernel", "mont_mul_kernel")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        sync()
    out = {nm: 0.0 for nm in names}
    out["other"] = 0.0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(ev, "device_time_total",
                     getattr(ev, "cuda_time_total", 0.0))
        hit = [nm for nm in names if nm in ev.key]
        out[hit[0] if hit else "other"] += us
    return {k.replace("_kernel", "") + "_ms": v / reps / 1e3
            for k, v in out.items()}


def phase_triples(dev, reps):
    fn = sim_offline_jit("generate_triples_packed", N, T, KT)
    run = _sim_reconstruct_packed_jit(N, T, False, True, fallback=False,
                                      replicate=False)
    fn((2026, 0))                     # builds the bands and launchers
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    pa, pb, pab, ok = fn((2026, 1))
    sync()
    launches = read_launches()
    call_s = time.perf_counter() - t0

    check(bool(ok), "triple call: ok is false on an honest run")
    want = {"randousha_deal": 4, "randousha_extract": 4,
            "mul_add_packed4": 1, "sub_bcast_packed4": 1, "open_direct": 5,
            "mont_mul": 6}                 # two per folded_band
    for name, count in want.items():
        check(launches[name] == count,
              f"triple call launched {name} {launches[name]} times, "
              f"expected {count}")
    for x in (pa, pb, pab):
        check(tuple(x.shape) == (PL, N, N_OUTP, KT)
              and x.dtype == torch.int32 and x.is_cuda, "triple shapes")
    nerr = 0
    opened = []
    for x in (pa, pb, pab):
        sec, ne = open_rows(run, x)
        nerr += int(ne.sum())
        opened.append(sec[:, :N_OUT].contiguous())     # real triples only
    check(nerr == 0, f"opening a, b, ab at degree t: nerr = {nerr}")
    a, b, ab = opened                                  # [PL, 22, 4096]
    # Montgomery form: mont_mul(aR, bR) = abR, so the product check needs
    # no conversion
    prod = pack_limbs(mont.mont_mul(unpack_limbs(a), unpack_limbs(b)))
    nbad = int((prod != ab).any(dim=0).sum())
    ntrip = N_OUT * KT
    check(nbad == 0, f"ab != a*b for {nbad} of {ntrip} triples")
    check(a.reshape(PL, -1).unique(dim=1).shape[1] == ntrip,
          "the a secrets must be distinct")
    sample = [(0, 0), (0, 1), (N_OUT // 3, KT // 2 - 1),
              (N_OUT - 1, KT - 1), (N_OUT // 2, KT // 32)]
    for r, c in sample:
        ai, bi, abi = (plain_int(x[:, r, c]) for x in (a, b, ab))
        check(abi == ai * bi % P, f"Python ints: ab != a*b at {(r, c)}")
    say("triples", ok=True, n=N, t=T, k=KT, triples=ntrip,
        padding_rows_excluded=N_OUTP - N_OUT, launches=launches, nerr=nerr,
        product_mismatches=nbad, python_int_samples=len(sample),
        peak_device_bytes=torch.cuda.max_memory_allocated(),
        first_call_seconds=round(call_s, 4))
    del pa, pb, pab, opened, prod

    # phase 9: a flipped word between deal and extract flips ok
    verdicts = {}
    for name, hit in (("honest", None), ("degree_t", T),
                      ("degree_2t", 2 * T)):
        *_, okf = fr.sim_randousha_fused((7, 7), N, T, KT, padded=True,
                                         tamper=flip_word(hit))
        verdicts[name] = bool(okf)
    check(verdicts == {"honest": True, "degree_t": False,
                       "degree_2t": False},
          f"fault verdicts wrong: {verdicts}")
    _, okf = fr.sim_ransha_fused((7, 8), N, T, KT, padded=True,
                                 tamper=flip_word(T))
    check(not bool(okf), "RanSha did not detect the flipped word")
    say("triple_fault_detection", ok=True, ok_flags=verdicts,
        ransha_ok_flag=bool(okf))

    # phase 10: timing (a new key every call)
    for i in range(2):
        fn((2027, i))
    sync()
    t0 = time.perf_counter()
    for i in range(reps):
        out = fn((2028, i))
    sync()
    dt = (time.perf_counter() - t0) / reps
    check(bool(out[3]), "timed triple call: ok is false")
    stages = stage_times(lambda i: fn((2029, i)), min(reps, 5))
    # the per-run extraction band alone (plain tensor code, three per call):
    # host clock around calls that end in a synchronize
    fold = fr._randousha_calls(N, T, KT, fr._party_points(N),
                               device=dev).folded_band
    fold((2030, 0))
    sync()
    t0 = time.perf_counter()
    for i in range(5):
        fold((2031, i))
    sync()
    band_ms = (time.perf_counter() - t0) / 5 * 1e3
    return launches, {"triples_per_s": ntrip / dt, "ms_per_call": dt * 1e3,
                      "triples_per_call": ntrip, "timed_calls": reps,
                      "device_ms_per_call_by_stage": stages,
                      "device_busy_ms_per_call": sum(stages.values()),
                      "folded_band_ms_each": band_ms,
                      "folded_bands_per_call": 3}


# -- the robust open: four kernels against their plain versions -------------

def mont_limbs_ints(limbs):
    """int32 limbs [L, ...] on the card -> flat list of Python ints (the
    Montgomery representatives)."""
    x = limbs.reshape(L, -1).cpu().numpy().astype("int64")
    return [sum(int(x[j, i]) << (16 * j) for j in range(L))
            for i in range(x.shape[1])]


def matmul_oracle(a, v, rows, cols):
    """Python-int a @ v in Montgomery form at the given (row, column) pairs
    of a[L, B, k] @ v[L, k, n]."""
    k, n = v.shape[1], v.shape[2]
    rinv = pow(R_MOD_P, P - 2, P)
    vv = mont_limbs_ints(v)
    out = []
    for b, c in zip(rows, cols):
        aa = mont_limbs_ints(a[:, b])
        acc = sum(aa[j] * vv[j * n + c] for j in range(k))
        out.append(acc * rinv % P)
    return out


def check_oracle(got, a, v, what):
    """A sample of got [L, B, n] against matmul_oracle."""
    B, n = got.shape[1], got.shape[2]
    rows = [r % B for r in (0, 1, B // 2, B - 1, B // 3)]
    cols = [c % n for c in (0, n - 1, n // 2, 1, n // 3)]
    want = matmul_oracle(a, v, rows, cols)
    have = [mont_limbs_ints(got[:, b, c])[0] for b, c in zip(rows, cols)]
    check(have == want, f"{what}: kernel != Python-int oracle")


def rand_field(dev, key, shape):
    n = 1
    for d in shape:
        n *= d
    return fk.rand_limbs(key, n, dev).reshape((L,) + tuple(shape))


def nsm(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _signed_words(value, count, bits):
    """`value`'s `count` little-endian words of `bits` bits as int32."""
    words = [(value >> (bits * j)) & ((1 << bits) - 1) for j in range(count)]
    return [w - (1 << 32) if w >= 1 << 31 else w for w in words]


# p - 1 as 16 limbs and as 8 packed words (the worst-case operand)
P_WORDS_SIGNED = (_signed_words(P - 1, L, 16), _signed_words(P - 1, PL, 32))


def mont_mul_bound(numel):
    return bound(3 * 64 * numel, MONT_MUL_OPS * numel, INT32_OPS_PER_S)


def cios_bound(b, k, n):
    return bound(64 * (b * k + k * n + b * n),
                 b * n * (k * CIOS_TERM_OPS + CIOS_OUTPUT_OPS),
                 INT32_OPS_PER_S)


def fused2_bound(b, k, n, rounds):
    """Reads a's limbs and the band, writes the limbs; the int8 dot of the
    folded scheme (37 diagonals x 37 digits x k per output) on the tensor
    cores and the fold on the CUDA cores, whichever is longer."""
    npl = mxu.NPLANES
    nbytes = 64 * b * k + n * npl * k * npl + 64 * b * n
    dot_ms = 2 * b * n * npl * npl * k / INT8_OPS_PER_S * 1e3
    fold_ms = (FOLD37_OPS_BASE + 52 * rounds) * b * n / INT32_OPS_PER_S * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = max(dot_ms, fold_ms)
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def redc_bound(m):
    return bound((73 * 4 + 64) * m, REDC73_OPS * m, INT32_OPS_PER_S)


def phase_kernels_robust(dev):
    """Rows 9, 12, 13 and 15 at the robust open's shapes, bit for bit
    against their plain versions on the card, a Python-int sample each,
    times and bounds."""
    t0 = time.perf_counter()
    pts = tuple(range(1, N + 1))
    err, shapes, times = {}, [], {}

    # row 9: the Gao EEA's [L, 2048, 65] and folded_band's [L, 42, 64]
    for shape in ((2048, N + 1), (2 * T, N)):
        a = rand_field(dev, (51, shape[0]), shape)
        b = rand_field(dev, (52, shape[1]), shape)
        got = fk.mont_mul_pallas(a, b)
        want = mont._mont_mul_plain(a, b)
        sync()
        check(torch.equal(got, want), f"mont_mul != plain at {shape}")
        for i in (0, 7, shape[1] * 3 + 1):
            ai = mont_limbs_ints(a.reshape(L, -1)[:, i])[0]
            bi = mont_limbs_ints(b.reshape(L, -1)[:, i])[0]
            gi = mont_limbs_ints(got.reshape(L, -1)[:, i])[0]
            check(gi == ai * bi * pow(R_MOD_P, P - 2, P) % P,
                  f"mont_mul != Python ints at {shape}")
        err["mont_mul"] = max(err.get("mont_mul", 0), max_abs_err(got, want))
        shapes.append(f"mont_mul [L,{shape[0]},{shape[1]}]")
    times["mont_mul_folded_band"] = (       # the last shape: [L, 42, 64]
        kernel_ms(lambda: fk.mont_mul_pallas(a, b), 50, "mont_mul_kernel"),
        timed_once(lambda: mont._mont_mul_plain(a, b)),
        mont_mul_bound(a[0].numel()))
    # three operand pairs (77 MB) in turn, so each launch finds its
    # operands outside the 50 MB L2
    pair_list = [(rand_field(dev, (53, i), (2048, N + 1)),
                  rand_field(dev, (54, i), (2048, N + 1))) for i in range(3)]
    a, b = pair_list[0]
    pairs = itertools.cycle(pair_list)
    times["mont_mul"] = (
        kernel_ms(lambda: fk.mont_mul_pallas(*next(pairs)), 50,
                  "mont_mul_kernel"),
        timed_once(lambda: mont._mont_mul_plain(a, b)),
        mont_mul_bound(a[0].numel()))

    # row 15: Gao's interpolation from all 64 shares, one 2048 segment
    a = rand_field(dev, (55, 1), (2048, N))
    lag = dev_const(_lagrange_matrix_np, (pts,), dev)          # [L, 64, 64]
    diag = mxu._mxu_diagonals(a, lag)
    got = mxu._redc_cuda(diag, N)
    want = mxu._redc_diagonals(diag)
    sync()
    check(torch.equal(got, want), "mxu_redc != plain at B=2048 k=64 n=64")
    check_oracle(got.reshape(L, 2048, N), a, lag, "mxu_redc")
    err["mxu_redc"] = max_abs_err(got, want)
    shapes.append(f"mxu_redc B=2048 k={N} n={N} (M={2048 * N})")
    ap = mxu._planes7(a).reshape(2048, N * mxu.NPLANES)
    vband = mxu._build_vband(lag)
    diags = itertools.cycle([diag, diag.roll(1, dims=1).contiguous()])
    times["mxu_redc"] = (          # two diagonal sets (92 MB) in turn
        kernel_ms(lambda: mxu._redc_cuda(next(diags), N), 50,
                  "mxu_redc_kernel"),
        timed_once(lambda: mxu._redc_diagonals(diag)),
        redc_bound(2048 * N))
    int_mm_ms = time_ms(lambda: mxu._dot_s8(ap, vband), 20)

    # row 13: decode_validate_matmul of the open's two rounds
    big = N * C                       # the decodes of one round
    for ncol, want_coeffs in ((N - K + 1, False), (N, True)):
        w = dev_const(_decode_validate_np, (pts, K, want_coeffs), dev)
        a = rand_field(dev, (56, ncol), (big, K))
        r = mxu._rounds_for(K)
        wd = mxu._folded_band_digits(w, r)
        got = mxu._fused2_cuda(a, wd, r)
        want = mxu._fused2_plain(a, wd, r)
        sync()
        check(torch.equal(got, want),
              f"mxu_fused2 != plain at B={big} k={K} n={ncol}")
        check_oracle(got, a, w, "mxu_fused2")
        err["mxu_fused2"] = max(err.get("mxu_fused2", 0),
                                max_abs_err(got, want))
        shapes.append(f"mxu_fused2 B={big} k={K} n={ncol}")
        key = "mxu_fused2" if ncol < N else f"mxu_fused2_n{N}"
        times[key] = (
            kernel_ms(lambda: mxu._fused2_cuda(a, wd, r), 20,
                      "Fold37"),
            timed_once(lambda: mxu._fused2_plain(a, wd, r)),
            fused2_bound(big, K, ncol, r))

    # row 12: robust_open_single's decode at n=64, at the plan's split and
    # at every other
    w = dev_const(_decode_validate_np, (pts, K, False), dev)      # [L,22,43]
    a = rand_field(dev, (57, 1), (N, K))
    got = fk.fp_matmul_pallas(a, w)
    want = _matmul_kernel(a, w, mul=mont._mont_mul_plain)
    sync()
    check(torch.equal(got, want), f"fp_matmul_cios != plain at B={N} k={K}")
    check_oracle(got, a, w, "fp_matmul_cios")
    err["fp_matmul_cios"] = max_abs_err(got, want)
    plan = fk._cios_plan(N, K, N - K + 1, nsm(dev))
    for split in CIOS_SPLITS:
        check(torch.equal(fk._fp_matmul_cios_cuda(a, w, split), want),
              f"fp_matmul_cios != plain at B={N} k={K} split={split}")
    shapes.append(f"fp_matmul_cios B={N} k={K} n={N - K + 1} (plan: split "
                  f"{plan}; and splits {list(CIOS_SPLITS)})")
    times["fp_matmul_cios"] = (
        kernel_ms(lambda: fk.fp_matmul_pallas(a, w), 50,
                  "fp_matmul_cios_kernel"),
        timed_once(lambda: _matmul_kernel(a, w, mul=mont._mont_mul_plain)),
        cios_bound(N, K, N - K + 1))
    # small and unaligned shapes: odd batches, 2 REDC rounds (k > 27), the
    # folded kernel's 32-lane plan (k = 64), unpadded dot sides
    for shape in ((5,), (1500,)):
        a, b = rand_field(dev, (58, 1), shape), rand_field(dev, (59, 1), shape)
        check(torch.equal(fk.mont_mul_pallas(a, b),
                          mont._mont_mul_plain(a, b)),
              f"mont_mul != plain at {shape}")
        shapes.append(f"mont_mul {shape}")
    for bb, k, n in CIOS_EDGES:
        a, v = rand_field(dev, (60, bb), (bb, k)), rand_field(dev, (61, n),
                                                               (k, n))
        top = torch.tensor(P_WORDS_SIGNED[0], dtype=torch.int32,
                           device=dev).reshape(L, 1, 1)       # p - 1
        for x, y, what in ((a, v, ""), (top.expand(L, bb, k).contiguous(),
                                        top.expand(L, k, n).contiguous(),
                                        ", every operand p - 1")):
            got = fk.fp_matmul_pallas(x, y)
            check(torch.equal(got,
                              _matmul_kernel(x, y, mul=mont._mont_mul_plain)),
                  f"fp_matmul_cios != plain at {(bb, k, n)}{what}")
            check_oracle(got, x, y, "fp_matmul_cios")
            shapes.append(f"fp_matmul_cios B={bb} k={k} n={n} (split "
                          f"{fk._cios_plan(bb, k, n, nsm(dev))}){what}")
    for bb, k, n in ((130, 31, 8), (300, N, 8), (256, K, N)) + ROW13_EDGES:
        a, v = rand_field(dev, (62, bb), (bb, k)), rand_field(dev, (63, n),
                                                               (k, n))
        r = mxu._rounds_for(k)
        wd = mxu._folded_band_digits(v, r)
        got = mxu._fused2_cuda(a, wd, r)
        check(torch.equal(got, mxu._fused2_plain(a, wd, r)),
              f"mxu_fused2 != plain at {(bb, k, n)}")
        check_oracle(got, a, v, "mxu_fused2")
        shapes.append(f"mxu_fused2 B={bb} k={k} n={n}")
    for bb, k, n in ((256, 9, 12), (1030, 3, 2)):
        a, v = rand_field(dev, (64, bb), (bb, k)), rand_field(dev, (65, n),
                                                               (k, n))
        diag = mxu._mxu_diagonals(a, v)
        got = mxu._redc_cuda(diag, k)
        check(torch.equal(got, mxu._redc_diagonals(diag)),
              f"mxu_redc != plain at {(bb, k, n)}")
        check_oracle(got.reshape(L, bb, n), a, v, "mxu_redc")
        shapes.append(f"mxu_redc B={bb} k={k} n={n}")
    say("robust_kernels_vs_plain", ok=True, tolerance="exact (torch.equal)",
        shapes=shapes, timed_by={k: v[0][1] for k, v in times.items()},
        int_mm_dot_ms=int_mm_ms, seconds=round(time.perf_counter() - t0, 3))
    return err, {k: (v[0][0], v[1], v[2]) for k, v in times.items()}, \
        int_mm_ms


def device_busy_ms(fn, top=0, cpu=True):
    """Device time of one call of fn(), summed over every CUDA kernel the
    profiler saw, and the number of kernel launches; with top > 0 also the
    `top` kernels by device time {name: ms}. A lower bound where the
    profiler drops events. cpu=False traces the device alone (a call of
    hundreds of thousands of launches then costs the profiler less)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    us, count, by_name = 0.0, 0, {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        t = getattr(ev, "device_time_total",
                    getattr(ev, "cuda_time_total", 0.0))
        us += t
        count += ev.count
        by_name[ev.key[:60]] = by_name.get(ev.key[:60], 0.0) + t / 1e3
    if not top:
        return us / 1e3, count
    best = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return us / 1e3, count, dict(best)


def phase_robust_open(dev):
    """One 16896-sharing segment dealt by the port's dealer, opened honestly
    and then with 21 parties' shares replaced (parties on both sides of k):
    the two-phase sim_batch_reconstruct, batch_reconstruct with its Gao
    fallback, sim_open_direct_packed(robust=True), robust_open_single."""
    pre = PreProcessedElements(N, T, seed=77, device=dev)
    pre.generate_rands(SEG)
    shares = pre.get_rands(SEG)                           # [n, SEG]
    sync()
    reset_launches()

    # (a) honest: phase one only
    sec_a, nerr_a = rec.sim_batch_reconstruct(shares, N, T)
    sync()
    la = read_launches()
    check(int(nerr_a.sum()) == 0, "honest robust open: nerr != 0")
    check(la["mxu_redc"] == 0 and la["mont_mul"] == 0
          and la["mxu_fused2"] == 0 and la["fp_matmul_cios"] == 0,
          f"an honest open must launch no Gao: {la}")
    check(la["open_direct"] == 1, "honest open: one direct-open launch")
    check(tuple(sec_a.shape) == (N, SEG), "opened shapes")
    check(bool((sec_a.limbs == sec_a.limbs[:, :1]).all()),
          "every party must open the same secrets")
    oracle_check(pack_limbs(shares.limbs), pack_limbs(sec_a.limbs[:, 0]),
                 [0, 1, C, SEG // 2, SEG - 1])

    # (b) 21 faulty parties: phase one sees them, the redo corrects them
    faulty = rec.inject_share_faults(shares, SimBackend(N).my_ids(dev),
                                     BAD_PARTIES, (2026, 3))
    check(not torch.equal(faulty.limbs[:, 0], shares.limbs[:, 0])
          and torch.equal(faulty.limbs[:, 1], shares.limbs[:, 1]),
          "fault injection hit the wrong parties")
    _, nerr_p1 = rec._sim_reconstruct_jit(N, T, False, True, fallback=False)(
        faulty.limbs)
    check(int(nerr_p1.sum()) > 0, "phase one did not see the faults")
    sync()
    reset_launches()
    t0 = time.perf_counter()
    sec_b, nerr_b = rec.sim_batch_reconstruct(faulty, N, T)
    sync()
    redo_s = time.perf_counter() - t0
    lb = read_launches()
    want_nerr = C * len(BAD_PARTIES)
    check(torch.equal(sec_b.limbs, sec_a.limbs),
          "robust open: secrets differ from the honest open")
    check(nerr_b.tolist() == [want_nerr] * N,
          f"robust open: nerr {nerr_b.tolist()[:4]}..., want {want_nerr}")
    check(lb["mxu_redc"] > 0 and lb["mont_mul"] > 0,
          f"the redo did not go through Gao on the kernels: {lb}")

    # (c) the generic program and the direct open's robust branch
    t0 = time.perf_counter()
    sec_c, nerr_c = rec.batch_reconstruct(SimBackend(N), faulty, N, T)
    sync()
    br_s = time.perf_counter() - t0
    check(torch.equal(sec_c.limbs, sec_a.limbs)
          and nerr_c.tolist() == [want_nerr] * N,
          "batch_reconstruct disagrees with the robust open")
    pts = tuple(range(1, N + 1))
    sec_d, nerr_d = fod.sim_open_direct_packed(pack_limbs(faulty.limbs), N,
                                               T, pts, robust=True)
    sync()
    check(torch.equal(sec_d, pack_limbs(sec_a.limbs))
          and nerr_d.tolist() == [want_nerr] * N,
          "sim_open_direct_packed(robust=True) disagrees")

    # (d) one secret's 64 scalar shares, 21 of them wrong
    vals, errs = rec.robust_open_single(SimBackend(N), faulty[:, 0], N, T)
    sync()
    check(torch.equal(vals.limbs, sec_a.limbs[:, :, 0])
          and errs.tolist() == [len(BAD_PARTIES)] * N,
          f"robust_open_single: errs {errs.tolist()[:4]}...")
    launches = read_launches()
    plain = read_plain()
    check(all(v == 0 for v in plain.values()),
          f"plain versions ran on the card: {plain}")
    for name in ("mont_mul", "fp_matmul_cios", "mxu_fused2", "mxu_redc"):
        check(launches[name] > 0, f"the robust open never launched {name}")

    # (e) the three-kernel open: K1-K3 see the faults at every destination
    # (the direct open charges only the sources), and its fallback returns
    # the honest secrets with the per-destination counts
    packed_bad = pack_limbs(faulty.limbs)
    reset_launches()
    _, nerr_k = fo.sim_open_fused_packed(packed_bad, N, T, pts, robust=False)
    _, nerr_dir = fod.sim_open_direct_packed(packed_bad, N, T, pts)
    sync()
    check(all(v > 0 for v in nerr_k.tolist())
          and sum(nerr_dir.tolist()[:K]) == 0,
          f"three-kernel counts {nerr_k.tolist()[:4]}... must charge every "
          "destination")
    t0 = time.perf_counter()
    sec_e, nerr_e = _sim_reconstruct_packed_jit(
        N, T, False, True, fallback=True)(packed_bad)
    sync()
    fused_fallback_s = time.perf_counter() - t0
    le = read_launches()
    check(torch.equal(sec_e, pack_limbs(sec_a.limbs))
          and nerr_e.tolist() == [want_nerr] * N,
          "three-kernel open with fallback disagrees with the robust open")
    check(all(le[f"open_fused_k{s}"] == 2 for s in (1, 2, 3)),
          f"three-kernel open: K1-K3 launches {le}")
    del packed_bad

    # the redo's time: one Gao segment and the encode, on the device
    recv = rec._redo_encode_jit(N, False, K)(faulty.limbs.contiguous())
    seg = recv.reshape(L, N * C, N)[:, :rec._REDO_SEG].contiguous()
    gao = rec._redo_gao_jit(N, False, K)
    gao(seg)
    sync()
    t0 = time.perf_counter()
    gao(seg)
    sync()
    gao_seg_ms = (time.perf_counter() - t0) * 1e3
    seg_busy_ms, seg_kernels = device_busy_ms(lambda: gao(seg))
    enc_busy_ms, _ = device_busy_ms(
        lambda: rec._redo_encode_jit(N, False, K)(faulty.limbs.contiguous()))
    nseg = 2 * (-(-N * C // rec._REDO_SEG))
    say("robust_open", ok=True, n=N, t=T, sharings=SEG,
        bad_parties=len(BAD_PARTIES), nerr_per_party=want_nerr,
        launches_honest=la, launches_redo=lb,
        launches_all=launches, plain_calls_on_card=plain,
        batch_reconstruct_ms=br_s * 1e3,
        three_kernel_nerr_min=min(nerr_k.tolist()),
        three_kernel_fallback_ms=fused_fallback_s * 1e3)
    return launches, {
        "redo_ms_per_segment": redo_s * 1e3,
        "redo_sharings_per_s": SEG / redo_s,
        "gao_segments_per_redo": nseg, "gao_segment_instances":
        rec._REDO_SEG, "gao_segment_ms": gao_seg_ms,
        "gao_segment_device_busy_ms": seg_busy_ms,
        "gao_segment_kernel_launches": seg_kernels,
        "encode_device_busy_ms": enc_busy_ms,
        "device_busy_ms_per_redo": enc_busy_ms + nseg * seg_busy_ms,
        "device_busy_per_redo_from": "encode + segments x one segment",
        "launches_per_redo": lb,
        "batch_reconstruct_ms": br_s * 1e3}


# -- the offline programs: the three-kernel open and the flat finish --------

def open_fused_bound(stage, n, k, c):
    """Bytes: each input read once, each output written once; operations:
    the int8 dot as the kernel runs it (32 diagonals x 32k digits per lane
    and column), K3 decoding once."""
    nv = n - k
    if stage == 1:
        lanes, ncol = n * c, n
        nbytes = 32 * n * k * c + 32 * n * n * c
    elif stage == 2:
        lanes, ncol = n * c, nv + 1
        nbytes = 32 * n * n * c + 32 * n * c + 4 * n
    else:
        lanes, ncol = c, n
        nbytes = 32 * n * c + 32 * k * c + 4
    nbytes += ncol * 8 * k * 128                      # the band
    return bound(nbytes, 2 * lanes * ncol * 32 * 32 * k, INT8_OPS_PER_S)


def packed_ints(packed, idx):
    """Montgomery-form ints of packed [PL, ...] at flat element indices."""
    return [v for v in mont_ints(packed.reshape(PL, -1)[:, idx])[0]]


def compare_open_fused(dev, n, k, c, key):
    """K1, K2, K3 against their plain versions on consistent shares, then
    on faulted ones, with a Python-int sample of each stage. Returns the
    worst error and the path-shape inputs of the three stages."""
    pts = tuple(range(1, n + 1))
    view = deal_packed(dev, n, k - 1, k * c, key).reshape(PL, n, k, c)
    cols = fo.open_k1(view, pts)
    want = fo._k1_plain(view, pts)
    sync()
    check(torch.equal(cols, want), f"open_fused K1 != plain at {(n, k, c)}")
    worst = max_abs_err(cols, want)
    # Python ints: party p's predicted column for destination j
    p, j, cc = n - 1, n // 2, c - 1
    co = packed_ints(view[:, p, :, cc], list(range(k)))
    got = packed_ints(cols[:, p, j, cc], [0])[0]
    check(got == sum(x * pow(j + 1, i, P) for i, x in enumerate(co)) % P,
          f"open_fused K1 != Python ints at {(n, k, c)}")
    stage_in = [view, cols, None]
    for faulted in (False, True):
        x = cols
        if faulted:
            x = cols.clone()
            x[3, n - 1, 2, c - 1] ^= 0x10          # dst 2, validating source
            x[0, 0, n - 1, 0] ^= 1                 # dst n-1, interpolating
        vals, errs = fo.open_k2(x, pts, k)
        vals_p, errs_p = fo._k2_plain(x, pts, k)
        sync()
        check(torch.equal(vals, vals_p) and torch.equal(errs, errs_p),
              f"open_fused K2 != plain at {(n, k, c)} faulted={faulted}")
        bad = errs.tolist()
        check((bad[2] > 0 and bad[n - 1] > 0 and sum(bad) == bad[2]
               + bad[n - 1]) if faulted else sum(bad) == 0,
              f"open_fused K2 counts {bad} (faulted={faulted})")
        worst = max(worst, max_abs_err(vals, vals_p), max_abs_err(errs, errs_p))
        if not faulted:
            lam0 = _lam_int(list(range(1, k + 1)), 0)
            ys = packed_ints(cols[:, :k, j, cc], list(range(k)))
            check(packed_ints(vals[:, j, cc], [0])[0]
                  == sum(l * y for l, y in zip(lam0, ys)) % P,
                  f"open_fused K2 != Python ints at {(n, k, c)}")
            stage_in[2] = vals
    vals = stage_in[2]
    for faulted in (False, True):
        x = vals
        if faulted:
            x = vals.clone()
            x[5, n - 1, c // 2] ^= 0x100
        sec, errs = fo.open_k3(x, pts, k)
        sec_p, errs_p = fo._k3_plain(x, pts, k)
        sync()
        check(torch.equal(sec, sec_p) and torch.equal(errs, errs_p),
              f"open_fused K3 != plain at {(n, k, c)} faulted={faulted}")
        check(errs.tolist() == [int(faulted)],
              f"open_fused K3 counts {errs.tolist()} (faulted={faulted})")
        worst = max(worst, max_abs_err(sec, sec_p), max_abs_err(errs, errs_p))
    # Python ints: the k secret coefficients re-encode to party j's psi
    sec, _ = fo.open_k3(vals, pts, k)
    co = packed_ints(sec[:, :, cc], list(range(k)))
    check(packed_ints(vals[:, j, cc], [0])[0]
          == sum(x * pow(j + 1, i, P) for i, x in enumerate(co)) % P,
          f"open_fused K3 != Python ints at {(n, k, c)}")
    return worst, stage_in


def compare_k1(dev, n, k, c, key):
    """K1 alone against its plain version, bit for bit, and a Python-int
    sample: the edges of the wgmma core's lane tiles (C = 1, 7819)."""
    pts = tuple(range(1, n + 1))
    view = pack_limbs(fk.rand_limbs(key, n * k * c, dev).reshape(
        L, n, k, c)).contiguous()
    cols = fo.open_k1(view, pts)
    want = fo._k1_plain(view, pts)
    sync()
    check(torch.equal(cols, want), f"open_fused K1 != plain at {(n, k, c)}")
    for p, j, cc in sorted({(0, 0, 0), (n - 1, n - 1, c - 1),
                            (n // 2, 1, c // 2)}):
        co = packed_ints(view[:, p, :, cc], list(range(k)))
        check(packed_ints(cols[:, p, j, cc], [0])[0]
              == sum(x * pow(j + 1, i, P) for i, x in enumerate(co)) % P,
              f"open_fused K1 != Python ints at {(n, k, c)}")
    return max_abs_err(cols, want)


def compare_k2(dev, n, k, c, key):
    """K2 alone against its plain version, bit for bit, on consistent
    columns and with faults in its last and first compare columns (sources
    n-1 and k) at two destinations whose lanes share a 64-lane tile (C = 1:
    lanes 2 and 3; else lanes 64 and 65, a destination boundary inside the
    tile), and in the first at the last lane: the per-destination counts
    equal the plain version's and one per fault."""
    pts = tuple(range(1, n + 1))
    view = deal_packed(dev, n, k - 1, k * c, key).reshape(PL, n, k, c)
    cols = fo.open_k1(view, pts)
    del view
    (j0, c0), (j1, c1) = ((2, 0), (3, 0)) if c == 1 else ((0, c - 1), (1, 0))
    worst = 0
    for faults in ((), ((3, n - 1, j0, c0), (0, k, j1, c1),
                        (7, k, n - 1, c - 1))):
        x = cols
        if faults:
            x = cols.clone()
            for w, src, j, cc in faults:
                x[w, src, j, cc] ^= 0x40
        vals, errs = fo.open_k2(x, pts, k)
        vals_p, errs_p = fo._k2_plain(x, pts, k)
        sync()
        check(torch.equal(vals, vals_p) and torch.equal(errs, errs_p),
              f"open_fused K2 != plain at {(n, k, c)} faults={faults}")
        want = [0] * n
        for _, _, j, _ in faults:
            want[j] += 1
        check(errs.tolist() == want, f"open_fused K2 counts "
              f"{errs.tolist()} at {(n, k, c)}, want {want}")
        worst = max(worst, max_abs_err(vals, vals_p),
                    max_abs_err(errs, errs_p))
    return worst


def k3_faults(vals, n, k):
    """K3's fault cases on consistent vals [PL, n, C]: name -> (faulted
    vals, the count every destination is charged)."""
    c = vals.shape[-1]
    cases = {"honest": (vals, 0)}
    x = vals.clone()                   # the last compare column, two lanes
    x[3, n - 1, 0] ^= 0x10             # of one warp (one lane where C = 1)
    x[0, n - 1, min(3, c - 1)] ^= 1
    cases["two_lanes_last_column"] = (x, 1 if c == 1 else 2)
    x = vals.clone()                   # the first compare column, last lane
    x[7, k, c - 1] ^= 0x40000000
    cases["first_column_last_lane"] = (x, 1)
    x = vals.clone()                   # an interpolating operand: its lane
    x[2, 0, c // 2] ^= 0x100           # mismatches at every compare column
    cases["interpolating_operand"] = (x, n - k)
    x = vals.clone()                   # one lying party at every lane
    x[5, n - 1] ^= 0x2482
    cases["lying_party"] = (x, c)
    return cases


def compare_k3(dev, n, k, c, key):
    """K3 alone against its plain version, bit for bit, on the shares of c
    random degree k-1 polynomials at the points 1..n and on each fault case
    of k3_faults: secrets and the one count equal, the count as the case
    fixes it; on honest shares the secrets are the dealt coefficients
    (Python ints on a sample). -> (worst error, the launch plan)."""
    pts = tuple(range(1, n + 1))
    coeffs = pack_limbs(fk.rand_limbs(key, c * k, dev).reshape(L, c, k))
    mat = _vandermonde_int_rows(pts, k)
    vals = bm.band_matmul_packed(coeffs, mat).permute(0, 2, 1).contiguous()
    worst = 0
    for name, (x, want) in k3_faults(vals, n, k).items():
        before = fo.launches_k3
        sec, errs = fo.open_k3(x, pts, k)
        sec_p, errs_p = fo._k3_plain(x, pts, k)
        sync()
        check(fo.launches_k3 == before + 1, "open_fused K3 did not launch")
        check(torch.equal(sec, sec_p) and torch.equal(errs, errs_p),
              f"open_fused K3 != plain at {(n, k, c)} {name}")
        check(errs.tolist() == [want], f"open_fused K3 count "
              f"{errs.tolist()} at {(n, k, c)} {name}, want {want}")
        if name == "honest":
            check(torch.equal(sec, coeffs.permute(0, 2, 1)),
                  f"open_fused K3 != the dealt coefficients at {(n, k, c)}")
            for cc in sorted({0, c - 1, c // 2}):
                ys = packed_ints(vals[:, :, cc], list(range(n)))
                co = packed_ints(sec[:, :, cc], list(range(k)))
                check(all(ys[j] == sum(a * pow(j + 1, e, P)
                                       for e, a in enumerate(co)) % P
                          for j in (0, k - 1, n - 1)),
                      f"open_fused K3 != Python ints at {(n, k, c)}")
        worst = max(worst, max_abs_err(sec, sec_p), max_abs_err(errs, errs_p))
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    return worst, _gemm_split(k, c, n, nsm)


def compare_mul_add(dev, b):
    x = [pack_limbs(rand_field(dev, (71 + i, b), (b,))) for i in range(3)]
    got = fk.mul_add_packed(*x)
    want = fk._mul_add_packed_plain(*x)
    sync()
    check(torch.equal(got, want), f"mul_add_packed != plain at B={b}")
    rinv = pow(R_MOD_P, P - 2, P)
    for i in sorted({0, b // 2, b - 1}):
        a_, b_, c_, o = (packed_ints(t, [i])[0] for t in (*x, got))
        check(o == (a_ * b_ * rinv + c_) % P,
              f"mul_add_packed != Python ints at B={b} element {i}")
    return max_abs_err(got, want), x


def phase_kernels_programs(dev):
    """Rows 10 and 16-18 of PERF.md (mul_add_packed, K1-K3) against their
    plain versions on the card, bit for bit, with Python-int samples, at
    the programs' shapes (k = 22 and 43), an unaligned chunk count and a
    small shape; times and bounds."""
    t0 = time.perf_counter()
    err = {f"open_fused_k{s}": 0 for s in (1, 2, 3)}
    shapes, times = [], {}
    for n, k, c in ((8, 3, 5), (N, K, 33), (N, K, C_T),
                    (N, 2 * T + 1, C_2T)):
        worst, stage_in = compare_open_fused(dev, n, k, c, (73, c))
        for s in (1, 2, 3):
            err[f"open_fused_k{s}"] = max(err[f"open_fused_k{s}"], worst)
        shapes.append(f"open_fused K1-K3 n={n} k={k} C={c} (+ faults)")
        if n == N and c in (C_T, C_2T):
            pts = tuple(range(1, N + 1))
            view, cols, vals = stage_in
            tag = "" if k == K else f"_k{k}"
            runs = ((1, lambda: fo.open_k1(view, pts),
                     lambda: fo._k1_plain(view, pts)),
                    (2, lambda: fo.open_k2(cols, pts, k),
                     lambda: fo._k2_plain(cols, pts, k)),
                    (3, lambda: fo.open_k3(vals, pts, k),
                     lambda: fo._k3_plain(vals, pts, k)))
            for s, kern, plain in runs:
                times[f"open_fused_k{s}{tag}"] = (
                    kernel_ms(kern, 10, K3_KERNEL if s == 3 else
                              f"open_fused_k{s}_kernel"),
                    timed_once(plain), open_fused_bound(s, N, k, c))
            del view, cols, vals, stage_in
    for n, k, c in ((N, K, 1), (N, K, C_T - 1), (N, 2 * T + 1, 1),
                    (N, 2 * T + 1, C_T - 1), (N, 2 * T + 1, C_T)):
        err["open_fused_k1"] = max(err["open_fused_k1"],
                                   compare_k1(dev, n, k, c, (79, c)))
        shapes.append(f"open_fused K1 n={n} k={k} C={c}")
    # K2 on the wgmma core: the ragged column tile (nv + 1 = 43 at k = 22),
    # destination boundaries inside a 64-lane tile (C = 1, 65), the ragged
    # 256-lane tile (C = 7819 at k = 22)
    for n, k, c in ((N, K, 1), (N, K, 65), (N, K, C_T - 1),
                    (N, 2 * T + 1, 1), (N, 2 * T + 1, 65)):
        err["open_fused_k2"] = max(err["open_fused_k2"],
                                   compare_k2(dev, n, k, c, (83, c)))
        shapes.append(f"open_fused K2 n={n} k={k} C={c} (+ faults in the "
                      f"first and last compare columns)")
    # K3 on the wgmma core: the programs' shapes (2 and 4 column groups),
    # ragged 64-lane tiles (C = 1, 65, 7819), small n (one group, an odd
    # column count)
    for n, k, c in ((N, K, C_T), (N, 2 * T + 1, C_2T), (N, K, 1),
                    (N, K, 65), (N, K, C_T - 1), (N, 2 * T + 1, 65),
                    (8, 3, 5), (7, 3, 130)):
        e, plan = compare_k3(dev, n, k, c, (89, c))
        err["open_fused_k3"] = max(err["open_fused_k3"], e)
        shapes.append(f"open_fused K3 n={n} k={k} C={c} (lane tile, column "
                      f"groups {plan}; honest, 4 fault cases)")
    worst = 0
    for b in (1, 777, N * N_OUT * KT):
        e, operands = compare_mul_add(dev, b)
        worst = max(worst, e)
        shapes.append(f"mul_add_packed B={b}")
    err["mul_add_packed"] = worst
    times["mul_add_packed"] = (
        kernel_ms(lambda: fk.mul_add_packed(*operands), 20,
                  "mul_add_packed_kernel"),
        timed_once(lambda: fk._mul_add_packed_plain(*operands)),
        mul_add_bound(N * N_OUT * KT))
    say("program_kernels_vs_plain", ok=True, tolerance="exact (torch.equal)",
        shapes=shapes, timed_by={k: v[0][1] for k, v in times.items()},
        seconds=round(time.perf_counter() - t0, 3))
    return err, {k: (v[0][0], v[1], v[2]) for k, v in times.items()}


def open_fp(x, deg):
    """Open FpArray shares [n, m] on the card at degree `deg` with the
    detect-only direct open -> (one copy [PL, m], nerr [n]); the column
    count is padded with zero sharings to a multiple of deg+1."""
    packed = pack_limbs(x.limbs)
    m = packed.shape[-1]
    pad = (-m) % (deg + 1)
    if pad:
        packed = torch.cat([packed, packed.new_zeros((PL, N, pad))], dim=-1)
    run = _sim_reconstruct_packed_jit(N, deg, False, True, fallback=False,
                                      replicate=False)
    sec, nerr = run(packed)
    return sec[:, :m], nerr


def check_program(prog, fb, out):
    """The program's outputs are right: ok; double sharings open to equal
    secrets at both degrees; ab = a*b for every triple (and in Python ints
    for a sample); every bit is 0 or 1 and both occur."""
    what = f"{prog} in_graph_fallback={fb}"
    check(bool(out[-1]), f"{what}: ok is false on an honest run")
    m = N_OUT * KT
    for x in out[:-1]:
        check(x.shape == (N, m) and x.limbs.is_cuda, f"{what}: shapes")
    if prog == "randousha":
        st, e1 = open_fp(out[0], T)
        s2, e2 = open_fp(out[1], 2 * T)
        check(int(e1.sum()) == 0 and int(e2.sum()) == 0
              and torch.equal(st, s2), f"{what}: r_t, r_2t disagree")
        check(st.unique(dim=1).shape[1] == m, f"{what}: secrets repeat")
        return {"opened_equal": True}
    if prog == "generate_triples":
        (a, ea), (b, eb), (ab, eab) = (open_fp(x, T) for x in out[:3])
        check(int(ea.sum() + eb.sum() + eab.sum()) == 0,
              f"{what}: a, b, ab do not open cleanly")
        prod = pack_limbs(mont.mont_mul(unpack_limbs(a), unpack_limbs(b)))
        nbad = int((prod != ab).any(dim=0).sum())
        check(nbad == 0, f"{what}: ab != a*b for {nbad} of {m} triples")
        for i in (0, m // 3, m - 1):
            ai, bi, abi = (plain_int(x[:, i]) for x in (a, b, ab))
            check(abi == ai * bi % P, f"{what}: Python ints ab != a*b")
        return {"product_mismatches": nbad}
    bits, e = open_fp(out[0], T)
    check(int(e.sum()) == 0, f"{what}: bits do not open cleanly")
    one = pack_limbs(FpArray.from_int(1, device=bits.device).limbs)[:, None]
    is0, is1 = (bits == 0).all(dim=0), (bits == one).all(dim=0)
    check(bool((is0 | is1).all()), f"{what}: a bit is neither 0 nor 1")
    check(bool(is0.any()) and bool(is1.any()), f"{what}: one bit value only")
    return {"zeros": int(is0.sum()), "ones": int(is1.sum())}


def phase_programs(dev, reps):
    """sim_offline_jit(program, 64, 21, 4096, in_graph_fallback) for the
    three eager-path programs in both modes. Each call runs with the launch
    counts set to 0 just before it and read just after; the path's counts
    are their sum. Then the outputs are checked, and each program timed."""
    fns = {(p, fb): sim_offline_jit(p, N, T, KT, fb)
           for p in PROGRAMS for fb in (False, True)}
    for i, fn in enumerate(fns.values()):        # bands and launchers
        fn((3030, i))
    sync()
    torch.cuda.empty_cache()
    path = {name: 0 for name in KERNEL_COUNTERS}
    per_call, rows = {}, {}
    for i, ((prog, fb), fn) in enumerate(fns.items()):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        sync()
        t0 = time.perf_counter()
        out = fn((3031, i))
        sync()
        first_s = time.perf_counter() - t0
        counts, plain = read_launches(), read_plain()
        for name, v in counts.items():
            path[name] += v
        check(all(v == 0 for v in plain.values()),
              f"{prog} fb={fb}: plain versions ran on the card: {plain}")
        ran = {name: v for name, v in counts.items() if v}
        tag = f"{prog}{'_fallback' if fb else ''}"
        rows[tag] = {"launches": ran,
                     "peak_device_bytes": torch.cuda.max_memory_allocated(),
                     "first_call_ms": first_s * 1e3,
                     **check_program(prog, fb, out)}
        if fb:
            for s in (1, 2, 3):
                check(counts[f"open_fused_k{s}"] > 0,
                      f"{tag} never launched K{s}")
            check(counts["open_direct"] == 0,
                  f"{tag}: the robust program ran a detect-only open")
        if prog == "generate_triples" and not fb:
            for name in ("mul_add_packed", "sub_bcast_packed"):
                check(counts[name] == 1,
                      f"{tag}: {name} launched {counts[name]} times, "
                      "expected 1")
        del out
        torch.cuda.empty_cache()
    for s in (1, 2, 3):
        check(path[f"open_fused_k{s}"] > 0, f"the programs never ran K{s}")
    check(path["mul_add_packed"] > 0, "the programs never ran mul_add_packed")
    check(path["sub_bcast_packed"] > 0,
          "the programs never ran sub_bcast_packed")
    say("programs", ok=True, n=N, t=T, k=KT, outputs_per_call=N_OUT * KT,
        calls=rows, launches=path)

    # timing: a new key every call; device time of one more, profiled
    nrep = min(reps, 5)
    for i, ((prog, fb), fn) in enumerate(fns.items()):
        tag = f"{prog}{'_fallback' if fb else ''}"
        sync()
        t0 = time.perf_counter()
        for r in range(nrep):
            out = fn((3032 + i, r))
        sync()
        dt = (time.perf_counter() - t0) / nrep
        check(bool(out[-1]), f"timed {tag}: ok is false")
        del out
        busy_ms, nkern, top = device_busy_ms(lambda: fn((3040 + i, 0)), 12)
        per_call[tag] = {"ms_per_call": dt * 1e3,
                         "outputs_per_s": N_OUT * KT / dt,
                         "device_busy_ms_per_call": busy_ms,
                         "device_kernels_per_call": nkern,
                         "device_ms_top_kernels": top,
                         "timed_calls": nrep,
                         "launches_per_call": rows[tag]["launches"],
                         "peak_device_bytes":
                         rows[tag]["peak_device_bytes"]}
        torch.cuda.empty_cache()
    return path, per_call


def phase_program_fault(dev):
    """generate_triples with in_graph_fallback=True at a small k, party 5
    sending wrong shares of a*b + r: the three-kernel open sees it, the
    Gao fallback inside the call corrects it — a, b, ab equal the honest
    run's — and ok still turns False, as in the reference."""
    fn = sim_offline_jit("generate_triples", N, T, FAULT_KT, True)
    bump = FpArray.from_int(1, device=dev)

    def tamper(name, cols):
        if name != "ab_plus_r":
            return cols
        limbs = cols.limbs.clone()
        limbs[:, 5] = (FpArray(limbs[:, 5]) + bump).limbs
        return FpArray(limbs)

    reset_launches()
    honest = fn((3050, 0))
    sync()
    counts_h = read_launches()
    reset_launches()
    t0 = time.perf_counter()
    faulty = fn((3050, 0), tamper=tamper)
    sync()
    secs = time.perf_counter() - t0
    counts = read_launches()
    check(bool(honest[3]) and not bool(faulty[3]),
          "in-program fallback: ok must be true honest, false faulty")
    for x, y in zip(honest[:3], faulty[:3]):
        check(torch.equal(x.limbs, y.limbs),
              "in-program fallback: outputs differ from the honest run")
    # the Gao decoder is thousands of elementwise multiplies
    check(counts["open_fused_k1"] > 0
          and counts["mont_mul"] > counts_h["mont_mul"] + 1000,
          f"in-program fallback: no three-kernel open or no Gao: {counts}")
    say("program_fault", ok=True, program="generate_triples", k=FAULT_KT,
        faulty_party=5, ok_flags=[bool(honest[3]), bool(faulty[3])],
        outputs_equal_honest=True,
        launches={k: v for k, v in counts.items() if v},
        ms=secs * 1e3)


# -- the coding layer: rows 13 and 14 against their plain versions ----------

# (B, k, n): row 12 at the edges of its plan: one output, one term, a
# contraction that is not a multiple of the split (23 at 16 lanes, 130 at
# 32: two runs of 64 terms in some lanes), the largest batch it serves, and
# k = 3599, which takes the CIOS route at every batch (32 lanes of 113
# terms each, two runs per lane)
CIOS_EDGES = ((1, 1, 1), (1, 22, 43), (64, 1, 43), (3, 23, 5), (13, 5, 7),
              (1, 3, 1), (7, 130, 9), (N, N, N), (1023, 43, 8),
              (1, 3599, 2))
CIOS_SPLITS = (1, 2, 4, 8, 16, 32)
# (B, k, n): rows 13 and 14 on the wgmma core at its edges: one lane, ragged
# 64- and 128-lane blocks, a batch of blocks; one chunk of 16 operands and
# the chunk edges (k = 32, 33), the REDC round edge (27, 28), the pair edge
# (55, 56), streamed planes (k >= 39); one, two and ragged tiles of columns
ROW13_EDGES = ((1, 1, 4), (1, 56, 64), (63, 27, 5), (63, 28, 43),
               (65, 32, 8), (65, 33, 16), (1031, 55, 43), (1031, 56, 5),
               (1031, 27, 64), (1031, 1, 16), (49152, 28, 8), (49152, 33, 4),
               (1, 438, 4), (65, 438, 5))
ROW14_EDGES = ((1, 439, 4), (63, 858, 4), (65, 439, 5), (1031, 858, 8),
               (1031, 439, 16), (1, 9, 12), (1031, 56, 5))

# row 14's windows (n -> contractions) and row 13's streamed shapes, PERF.md
ROW14_SHAPES = ((4, 439), (4, 512), (4, 858), (8, 313), (8, 422),
                (16, 196), (16, 204))
ROW13_SHAPES = ((4, 92), (4, 256), (4, 438), (8, 312), (16, 195),
                (22, 151), (32, 108))
CODING_B = 16896                  # the reference bench's segment, 22 * 768
# fp_matmul at a batch of 1024 on both sides of every window edge
WINDOW_EDGES = ((4, 91), (4, 92), (4, 438), (4, 439), (4, 858), (4, 859),
                (4, 3598), (4, 3599), (8, 312), (8, 313), (8, 422),
                (8, 423), (16, 195), (16, 196), (16, 204), (16, 205),
                (22, 151), (22, 152), (32, 108), (32, 109), (43, 80),
                (43, 81), (64, 52), (64, 53))
ROUTE_COUNTER = {"mxu2": "mxu_fused2", "mxu_fused": "mxu_fused",
                 "mxu": "mxu_redc", "cios": "fp_matmul_cios"}


def fused_bound(b, k, n):
    """Reads a's and v's limbs, writes the limbs; the least int8 work of
    the product convolution (37 x 37 digit products per operand and
    output) on the tensor cores and the 73-diagonal REDC on the CUDA
    cores, whichever is longer."""
    npl = mxu.NPLANES
    nbytes = 64 * (b * k + k * n + b * n)
    dot_ms = 2 * b * n * npl * npl * k / INT8_OPS_PER_S * 1e3
    fold_ms = REDC73_OPS * b * n / INT32_OPS_PER_S * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = max(dot_ms, fold_ms)
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def phase_kernels_coding(dev):
    """Rows 14 and 13 bit for bit against their plain versions on the card
    at the windows fp_matmul routes to them, a Python-int sample each, times
    and bounds; then fp_matmul on CUDA tensors at every window edge: no
    raise, the routed kernel launched, no plain version on the card."""
    from honeybadgermpc_tpu_torch.ops.fpmatmul import _route, fp_matmul
    t0 = time.perf_counter()
    err, shapes, times = {"mxu_fused": 0}, [], {}
    for i, (n, k) in enumerate(ROW14_SHAPES):
        for bb in ((1024, 1031)[i % 2], CODING_B):
            if bb == CODING_B and (n, k) not in ((4, 512), (8, 313),
                                                 (16, 204), (4, 858)):
                continue
            a = rand_field(dev, (80, bb + k), (bb, k))
            v = rand_field(dev, (81, n + k), (k, n))
            got = mxu._fused_cuda(a, v)
            want = mxu._fused_plain(a, v)
            sync()
            check(torch.equal(got, want),
                  f"mxu_fused != plain at B={bb} k={k} n={n}")
            check_oracle(got, a, v, f"mxu_fused B={bb} k={k} n={n}")
            err["mxu_fused"] = max(err["mxu_fused"], max_abs_err(got, want))
            shapes.append(f"mxu_fused B={bb} k={k} n={n}")
            if (bb, n, k) == (CODING_B, 4, 512):
                times["mxu_fused"] = (
                    kernel_ms(lambda: mxu._fused_cuda(a, v), 10, "Redc73"),
                    timed_once(lambda: mxu._fused_plain(a, v)),
                    fused_bound(bb, k, n))
    for bb, k, n in ROW14_EDGES:
        a = rand_field(dev, (86, bb + k), (bb, k))
        v = rand_field(dev, (87, n + k), (k, n))
        got = mxu._fused_cuda(a, v)
        sync()
        check(torch.equal(got, mxu._fused_plain(a, v)),
              f"mxu_fused != plain at B={bb} k={k} n={n}")
        check_oracle(got, a, v, f"mxu_fused B={bb} k={k} n={n}")
        shapes.append(f"mxu_fused B={bb} k={k} n={n}")
    for i, (n, k) in enumerate(ROW13_SHAPES + ((4, 438),)):
        bb = CODING_B if i == len(ROW13_SHAPES) else (1024, 1031)[i % 2]
        a = rand_field(dev, (82, bb + k), (bb, k))
        v = rand_field(dev, (83, n + k), (k, n))
        r = mxu._rounds_for(k)
        wd = mxu._folded_band_digits(v, r)
        got = mxu._fused2_cuda(a, wd, r)
        want = mxu._fused2_plain(a, wd, r)
        sync()
        check(torch.equal(got, want),
              f"mxu_fused2 != plain at B={bb} k={k} n={n}")
        check_oracle(got, a, v, f"mxu_fused2 B={bb} k={k} n={n}")
        err["mxu_fused2"] = max(err.get("mxu_fused2", 0),
                                max_abs_err(got, want))
        shapes.append(f"mxu_fused2 B={bb} k={k} n={n}")
    times["mxu_fused2_streamed"] = (
        kernel_ms(lambda: mxu._fused2_cuda(a, wd, r), 10, "Fold37"),
        timed_once(lambda: mxu._fused2_plain(a, wd, r)),
        fused2_bound(CODING_B, 438, 4, mxu._rounds_for(438)))

    edges = []
    for n, k in WINDOW_EDGES:
        a = rand_field(dev, (84, k), (1024, k))
        v = rand_field(dev, (85, n), (k, n))
        route = _route(1024, k, n)
        reset_launches()
        out = fp_matmul(FpArray(a), FpArray(v))
        sync()
        moved = {name: c for name, c in read_launches().items() if c}
        check(moved.get(ROUTE_COUNTER[route], 0) >= 1,
              f"fp_matmul k={k} n={n}: route {route} launched nothing")
        check(not any(moved.get(ROUTE_COUNTER[r], 0) for r in ROUTE_COUNTER
                      if r != route),
              f"fp_matmul k={k} n={n}: another matmul kernel ran: {moved}")
        check(not any(read_plain().values()),
              f"fp_matmul k={k} n={n}: a plain version ran on the card")
        check_oracle(out.limbs, a, v, f"fp_matmul k={k} n={n}")
        edges.append(f"n={n} k={k}: {route}")
    say("coding_kernels_vs_plain", ok=True, tolerance="exact (torch.equal)",
        shapes=shapes, fp_matmul_window_edges=edges,
        timed_by={k: v[0][1] for k, v in times.items()},
        seconds=round(time.perf_counter() - t0, 3))
    return err, {k: (v[0][0], v[1], v[2]) for k, v in times.items()}


# -- NTL and coding on the card ----------------------------------------------

def _rate(fn, units, count, reps=5):
    """Host-clock ms per call (mean of `reps` after a warm-up, each ending
    in a synchronize), the rate in `units`, device-busy ms and launches of
    one call from the profiler; where its trace holds no kernel, CUDA
    events around one call instead (host gaps between launches
    included). The launch counters are left as they were: timing
    repeats are not the path's launches."""
    saved = read_launches()
    fn()
    sync()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
        sync()
    ms = (time.perf_counter() - t) / reps * 1e3
    busy, launches = device_busy_ms(fn)
    out = {"ms_per_call": ms, units: count / ms * 1e3,
           "device_busy_ms": busy, "kernel_launches": launches}
    if launches == 0:
        out["device_busy_ms"] = None
        out["device_ms_cuda_events"] = timed_once(fn)
    for name, (mod, attr) in KERNEL_COUNTERS.items():
        setattr(mod, attr, saved[name])
    return out


def _int_rows(arr, rows):
    return [[int(v) for v in arr[r].to_ints()] for r in rows]


def _horner(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def phase_ntl(dev):
    """The reference bench's grids through the port's coding layer and
    every ntl function once on CUDA tensors, each against Python ints on a
    sample; vandermonde_batch_evaluate of 1024 polynomials with 512
    coefficients at 4 points reaches row 14 through the entry point."""
    from honeybadgermpc_tpu_torch import ntl
    from honeybadgermpc_tpu_torch.ops import ntt
    from honeybadgermpc_tpu_torch.ops.fpmatmul import \
        vandermonde_batch_interpolate
    from honeybadgermpc_tpu_torch.ops.rs import Encoding
    from honeybadgermpc_tpu_torch.polynomial import get_omega_int
    from honeybadgermpc_tpu_torch.runtime.refinement import (
        refine_randoms, refine_randoms_host)
    from honeybadgermpc_tpu_torch.field import GF
    t0 = time.perf_counter()
    reset_launches()
    rates = {}
    for n in (16, 128, 1024):
        xs = list(range(1, n + 1))
        ys = FpArray(rand_field(dev, (90, n), (8, n)))
        c = vandermonde_batch_interpolate(xs, ys)
        want = _int_rows(ys, [0, 7])
        got = _int_rows(c, [0, 7])
        for r in range(2):
            for j in (0, n // 2, n - 1):
                check(_horner(got[r], xs[j]) == want[r][j],
                      f"vandermonde_batch_interpolate n={n}")
        rates[f"lagrange_interpolate_n{n}"] = _rate(
            lambda: vandermonde_batch_interpolate(xs, ys), "points_per_s",
            8 * n)
    for logn in (4, 8, 12, 14):
        n = 1 << logn
        batch = (1 << 16) // n
        omega = get_omega_int(P, n, seed=0)
        ys = FpArray(rand_field(dev, (91, n), (batch, n)))
        coeffs = ntt.fft_interpolate(ys, omega)
        evals = ntt.fft_evaluate(coeffs, omega, n)
        check(torch.equal(evals.limbs, ys.limbs),
              f"fft_evaluate(fft_interpolate(y)) != y at n={n}")
        got = _int_rows(coeffs, [0, batch - 1])
        want = _int_rows(ys, [0, batch - 1])
        for r in range(2):
            for j in (0, 1, n - 1):
                check(_horner(got[r], pow(omega, j, P)) == want[r][j],
                      f"fft_interpolate n={n}")
        rates[f"fft_interpolate_n{n}"] = _rate(
            lambda: ntt.fft_interpolate(ys, omega), "points_per_s",
            batch * n)
        rates[f"fft_evaluate_n{n}"] = _rate(
            lambda: ntt.fft_evaluate(coeffs, omega, n), "points_per_s",
            batch * n)
    for n in (4, 16, 64):
        t = (n - 1) // 3
        k = n - t
        shares = FpArray(rand_field(dev, (92, n), (512, k)))
        out = refine_randoms(n, t, shares)
        for r in (0, 511):
            check(_int_rows(out, [r])[0] == refine_randoms_host(
                n, t, GF(P), _int_rows(shares, [r])[0]),
                f"refine_randoms n={n}")
        rates[f"random_refinement_n{n}"] = _rate(
            lambda: refine_randoms(n, t, shares), "outputs_per_s",
            512 * (k - t))

    enc = Encoding(128, use_omega_powers=True)
    zs = tuple(range(0, 128, 3))                      # 43 parties
    coeffs = FpArray(rand_field(dev, (93, 1), (CODING_B, len(zs))))
    shares = enc.encode(coeffs)
    sub = shares.take(list(zs), axis=1)
    back = enc.decode(zs, sub)
    check(torch.equal(back.limbs, coeffs.limbs),
          "Encoding(128, omega): decode(encode(c)) != c")
    row = _int_rows(coeffs, [CODING_B - 1])[0]
    check(_int_rows(shares, [CODING_B - 1])[0][5] ==
          _horner(row, enc.points[5]), "omega encode != Python ints")
    rates["fnt_encode_n128"] = _rate(lambda: enc.encode(coeffs),
                                     "polys_per_s", CODING_B)
    rates["fnt_decode_n128_from43"] = _rate(lambda: enc.decode(zs, sub),
                                            "polys_per_s", CODING_B)

    # every ntl function once, against the host fallbacks and Python ints
    rng = __import__("random").Random(2026)
    pts = list(range(1, 6))
    poly = [rng.randrange(P) for _ in range(5)]
    vals = [ntl.evaluate(poly, x, P) for x in pts]
    check(ntl.lagrange_interpolate(pts, vals, P) == poly,
          "ntl.lagrange_interpolate")
    check(ntl.vandermonde_inverse(pts, P) == [
        ntl._lagrange_coeffs_host(pts, [int(i == j) for i in range(5)], P)
        for j in range(5)], "ntl.vandermonde_inverse")
    polys = [[rng.randrange(P) for _ in range(4)] for _ in range(3)]
    evals = ntl.vandermonde_batch_evaluate(pts[:4], polys, P)
    check(evals == [[ntl.evaluate(q, x, P) for x in pts[:4]] for q in polys],
          "ntl.vandermonde_batch_evaluate (small)")
    check(ntl.vandermonde_batch_interpolate(pts[:4], evals, P) == polys,
          "ntl.vandermonde_batch_interpolate")
    n = 8
    omega = get_omega_int(P, n, seed=0)
    full = ntl.fft(polys[0] + [0] * 4, omega, P, n)
    check(full == ntl._fft_host(polys[0], omega, P, n), "ntl.fft")
    check(ntl.partial_fft(polys[0], omega, P, n, 3) == full[:3],
          "ntl.partial_fft")
    check(ntl.fft_batch_evaluate(polys, omega, P, n, n) ==
          [ntl._fft_host(q, omega, P, n) for q in polys],
          "ntl.fft_batch_evaluate")
    fz = [0, 2, 5, 7]
    fys = [full[z] for z in fz]
    check(ntl.fft_interpolate(fz, fys, omega, P, n)[:4] == polys[0],
          "ntl.fft_interpolate")
    check(ntl.fft_batch_interpolate(fz, [fys], omega, P, n)[0][:4] ==
          polys[0], "ntl.fft_batch_interpolate")
    gx = list(range(1, 10))
    gy = [ntl.evaluate(polys[1][:3], x, P) for x in gx]
    gy[1], gy[6] = (gy[1] + 17) % P, None
    msg, errp = ntl.gao_interpolate(gx, gy, 3, P)
    check(msg[:3] == polys[1][:3] and ntl.evaluate(errp, 2, P) == 0,
          "ntl.gao_interpolate")
    keep = [i for i, y in enumerate(gy) if y is not None]
    check(ntl._gao_host([gx[i] for i in keep], [gy[i] for i in keep], 3,
                        P)[0] == polys[1][:3], "ntl._gao_host")
    sq = poly[0] * poly[0] % P
    check(ntl.sqrt_mod(sq, P) ** 2 % P == sq, "ntl.sqrt_mod")
    ntl.SetNumThreads(4)
    ntl.SetNTLNumThreads(4)
    check(ntl.AvailableNTLThreads() == ntl.GetMaxThreads() == 1,
          "ntl thread controls")
    try:
        ntl.lagrange_interpolate([1, 1], [2, 3], P)
        check(False, "ntl.InterpolationError not raised")
    except ntl.InterpolationError:
        pass
    # row 14 through the entry point: 1024 polynomials, 512 coefficients,
    # 4 points (fused2_fits fails, fused_fits holds)
    big = [[rng.randrange(P) for _ in range(512)] for _ in range(1024)]
    before = mxu.launches_fused
    bx = [3, 5, 7, 11]
    bev = ntl.vandermonde_batch_evaluate(bx, big, P)
    check(mxu.launches_fused == before + 1,
          "ntl.vandermonde_batch_evaluate(1024 x 512 at 4 points) did not "
          "launch mxu_fused")
    for r in (0, 511, 1023):
        check(bev[r] == [ntl.evaluate(big[r], x, P) for x in bx],
              "ntl.vandermonde_batch_evaluate (row 14) != Python ints")
    cs = FpArray.from_ints(big, dev)
    from honeybadgermpc_tpu_torch.ops.fpmatmul import \
        vandermonde_batch_evaluate
    rates["vandermonde_batch_evaluate_1024x512_at4"] = _rate(
        lambda: vandermonde_batch_evaluate(bx, cs), "points_per_s", 4096)
    launches = read_launches()
    plain = read_plain()
    check(not any(plain.values()), f"a plain version ran on the card: "
          f"{plain}")
    check(launches["mont_mul"] > 0 and launches["mxu_fused"] > 0 and
          launches["mxu_redc"] > 0 and launches["fp_matmul_cios"] > 0,
          f"the coding path missed a kernel: {launches}")
    say("ntl", ok=True, launches={k: v for k, v in launches.items() if v},
        plain_on_card=plain, seconds=round(time.perf_counter() - t0, 3))
    return launches, rates


# -- the per-column check: rows 5b, 6 and 11 --------------------------------

def extract_pc_bound(n, n_outp, ncheckp, sp):
    """Reads the receive tensor and the band, writes keep and the check
    tensor; the int8 dot at all n columns (32 diagonals x 32n digits per
    lane and column)."""
    b = n * sp
    nbytes = 4 * PL * b * (n + n_outp + ncheckp) + n * 8 * n * 128
    return bound(nbytes, 2 * n * 32 * 32 * n * b, INT8_OPS_PER_S)


def check_bound(n, k, ncheckp, sp):
    """Reads the check tensor and the band, writes vals and errs; K2's dot
    (nv + 1 columns x 32 diagonals x 32k digits) on every lane."""
    lanes = ncheckp * sp
    nv = n - k
    nbytes = 4 * PL * n * lanes + 4 * PL * lanes + 4 * lanes \
        + (nv + 1) * 8 * k * 128
    return bound(nbytes, 2 * lanes * (nv + 1) * 32 * 32 * k, INT8_OPS_PER_S)


def compare_extract_pc(dev, n, t, sp, cols):
    """The per-column extraction against its plain version, and its two
    traps: keep rows n_out.. are the first check columns, check columns
    2t.. are zero."""
    pts = fr._party_points(n)
    n_out, ncheck = n - 2 * t, 2 * t
    n_outp, ncheckp = -(-n_out // 8) * 8, -(-ncheck // 8) * 8
    band = fr._encode_band_device(pts, n, dev)[0]
    keep, chk = fr.randousha_extract(cols, band, n_out, n_outp, ncheckp)
    keep_p, chk_p = fr._randousha_extract_plain(cols, band, n_out, n_outp,
                                                ncheckp)
    sync()
    check(torch.equal(keep, keep_p) and torch.equal(chk, chk_p),
          f"randousha_extract_pc != plain at n={n} t={t} sp={sp}")
    # the kernel once more, on outputs that hold nonzero bytes: it must
    # write every word, the zero check rows too
    junk = [torch.full((PL, n, rows, sp), 0x5A5A5A5A, dtype=torch.int32,
                       device=dev) for rows in (n_outp, ncheckp)]
    tiles = band.reshape(-1)[torch.from_numpy(
        _gemm_band_index(band.shape[0] // 32, n, n, band.shape[1])).to(dev)]
    rc = _build.lib().hb_randousha_extract_pc(
        cols.data_ptr(), tiles.data_ptr(), junk[0].data_ptr(),
        junk[1].data_ptr(), n, sp, n_out, n_outp, ncheckp,
        *fo._gemm_args(n, n * sp, dev),
        torch.cuda.current_stream().cuda_stream)
    sync()
    check(rc == 0 and torch.equal(junk[0], keep_p)
          and torch.equal(junk[1], chk_p),
          f"randousha_extract_pc on 0x5A-filled outputs != plain at n={n}")
    del junk, tiles
    check(torch.equal(keep[:, :, n_out:], chk[:, :, :n_outp - n_out])
          and not bool(chk[:, :, ncheck:].any()),
          "extract_pc: keep rows n_out.. must be the first check columns, "
          "check columns 2t.. zero")
    return max(max_abs_err(keep, keep_p), max_abs_err(chk, chk_p)), keep, \
        chk, band


def compare_check(chk, k, pts, want_errs=None):
    """The per-column check against its plain version; honest check
    tensors must give no error, a faulted one `want_errs`."""
    vals, errs = fr.randousha_check(chk, k, pts)
    vals_p, errs_p = fr._randousha_check_plain(chk, k, pts)
    sync()
    check(torch.equal(vals, vals_p) and torch.equal(errs, errs_p),
          f"randousha_check != plain at k={k} {tuple(chk.shape)}")
    if want_errs is None:
        check(not bool(errs.any()), f"randousha_check: errors on honest "
                                    f"columns at k={k}")
    else:
        check(torch.equal(errs, want_errs),
              f"randousha_check: wrong per-lane counts at k={k}")
    return max(max_abs_err(vals, vals_p), max_abs_err(errs, errs_p)), vals


def compare_sub_bcast_flat(a, b):
    """Row 11 against its plain version and against the generic
    montgomery.sub_mod on the unpacked operands."""
    got = fk.sub_bcast_packed(a, b)
    want = fk._sub_bcast_packed_plain(a, b)
    generic = pack_limbs(mont.sub_mod(unpack_limbs(a)[:, None],
                                      unpack_limbs(b)))
    sync()
    check(torch.equal(got, want) and torch.equal(got, generic),
          f"sub_bcast_packed != plain / sub_mod at {tuple(b.shape)}")
    return max_abs_err(got, want)


def phase_kernels_per_column(dev):
    """Rows 5b, 6 and 11 against their plain versions on the card, bit for
    bit: the per-column extraction and check at n=8, t=2, sp=128 and at
    n=64, t=21, sp=4096, both degrees, the check also on a flipped word at
    a validating party; the flat subtract at an unaligned [8, 3, 77] and at
    the flat triple finish's [8, 90112] - [8, 64, 90112]. Times and
    bounds."""
    t0 = time.perf_counter()
    err = {"randousha_extract_pc": 0, "randousha_check": 0,
           "sub_bcast_packed": 0}
    shapes, times = [], {}
    for n, t, sp in ((8, 2, 128), (N, T, KT)):
        pts = fr._party_points(n)
        ncheck = 2 * t
        for degree in (t, 2 * t):
            cols = fr.randousha_deal((61, degree), n, t, degree, sp, pts,
                                     dev)
            e, keep, chk, band = compare_extract_pc(dev, n, t, sp, cols)
            err["randousha_extract_pc"] = max(err["randousha_extract_pc"], e)
            shapes.append(f"randousha_extract_pc n={n} t={t} sp={sp} "
                          f"(degree {degree})")
            k = degree + 1
            e, _ = compare_check(chk, k, pts)
            # a flipped word at a validating party: 1 at that lane only
            c0, s0 = ncheck - 1, sp // 2 + 3
            bad = chk.clone()
            bad[3, n - 1, c0, s0] ^= 0x10
            want = torch.zeros((chk.shape[2], sp), dtype=torch.int32,
                               device=dev)
            want[c0, s0] = 1
            e2, _ = compare_check(bad, k, pts, want)
            # flips in two lanes of one 64-lane block (column 0, slots 3
            # and 12) at the last and the first compare column
            bad = chk.clone()
            bad[3, n - 1, 0, 3] ^= 0x10
            bad[0, k, 0, 12] ^= 1
            want = torch.zeros_like(want)
            want[0, 3] = want[0, 12] = 1
            e3, _ = compare_check(bad, k, pts, want)
            err["randousha_check"] = max(err["randousha_check"], e, e2, e3)
            shapes.append(f"randousha_check n={n} k={k} ncheckp="
                          f"{chk.shape[2]} sp={sp} (+ a flipped word, + "
                          f"two lanes of one block)")
            del bad
            if n == N:
                tag = "" if degree == T else "_2t"
                times["randousha_extract_pc" + tag] = (
                    kernel_ms(lambda: fr.randousha_extract(
                        cols, band, N_OUT, N_OUTP, NCHECKP), 10,
                        "randousha_extract_pc_kernel"),
                    timed_once(lambda: fr._randousha_extract_plain(
                        cols, band, N_OUT, N_OUTP, NCHECKP)),
                    extract_pc_bound(N, N_OUTP, NCHECKP, KT))
                ktag = "" if degree == T else f"_k{k}"
                times["randousha_check" + ktag] = (
                    kernel_ms(lambda: fr.randousha_check(chk, k, pts), 10,
                              "randousha_check_kernel"),
                    timed_once(lambda: fr._randousha_check_plain(chk, k,
                                                                 pts)),
                    check_bound(N, k, NCHECKP, KT))
            del cols, keep, chk
    torch.cuda.empty_cache()

    # row 11: unaligned, then the flat finish's shape, its subtrahend a
    # column slice of the padded keep layout as the finish passes it
    a = pack_limbs(rand_field(dev, (95, 1), (77,)))
    b = pack_limbs(rand_field(dev, (96, 1), (3, 77)))
    b[:, 1, :40] = a[:, :40]                           # a == b -> 0
    err["sub_bcast_packed"] = compare_sub_bcast_flat(a, b)
    shapes.append("sub_bcast_packed [8,77] - [8,3,77]")
    cnt = N_OUT * KT
    opened = pack_limbs(rand_field(dev, (97, 1), (cnt + 11,)))
    a = opened[:, :cnt]                                # a prefix view
    wide = pack_limbs(rand_field(dev, (98, 1), (N, N_OUTP * KT)))
    b = wide[:, :, :cnt]                               # a column slice
    err["sub_bcast_packed"] = max(err["sub_bcast_packed"],
                                  compare_sub_bcast_flat(a, b))
    shapes.append(f"sub_bcast_packed [8,{cnt}] - [8,{N},{cnt}] (views)")
    times["sub_bcast_packed"] = (
        kernel_ms(lambda: fk.sub_bcast_packed(a, b), 20,
                  "sub_bcast_packed_kernel"),
        timed_once(lambda: fk._sub_bcast_packed_plain(a, b)),
        sub_bcast_bound(N * cnt, N))
    say("per_column_kernels_vs_plain", ok=True,
        tolerance="exact (torch.equal)", shapes=shapes,
        timed_by={k: v[0][1] for k, v in times.items()},
        seconds=round(time.perf_counter() - t0, 3))
    return err, {k: (v[0][0], v[1], v[2]) for k, v in times.items()}


def shift_dealer(cols, dealer, delta):
    """Add delta to every share `dealer` dealt (receive tensor
    [PL, dst, src, sp]): the dealing of secret + delta, degree unchanged."""
    lim = unpack_limbs(cols[:, :, dealer])
    dv = FpArray.from_int(delta, device=cols.device).limbs.reshape(L, 1, 1)
    cols[:, :, dealer] = pack_limbs(mont.add_mod(lim, dv))
    return cols


def phase_per_column(dev, reps):
    """_randousha_calls(64, 21, 4096, aggregate=False) in double and in
    single mode, each call with the launch counts set to 0 just before and
    read just after: nerr == 0, the extracted sharings equal the aggregated
    run's, the opened check values equal at both degrees and to Python-int
    interpolation on a sample; a flipped receive word and the known-rho
    bypass are caught; ms per call and device-busy ms."""
    t0 = time.perf_counter()
    pts = fr._party_points(N)
    key = (2026, 7)
    run_d = fr._randousha_calls(N, T, KT, pts, aggregate=False, device=dev)
    run_s = fr._randousha_calls(N, T, KT, pts, aggregate=False, single=True,
                                device=dev)
    run_a = fr._randousha_calls(N, T, KT, pts, device=dev)
    run_d((1, 1))                       # bands and launchers
    run_s((1, 1))
    sync()
    torch.cuda.empty_cache()
    calls, full, out = {}, {}, {}
    for mode, run, want in (("double", run_d, 2), ("single", run_s, 1)):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        sync()
        t1 = time.perf_counter()
        out[mode] = run(key)
        sync()
        first_s = time.perf_counter() - t1
        counts, plain = read_launches(), read_plain()
        check(int(out[mode][-1]) == 0, f"per-column {mode}: nerr = "
                                       f"{int(out[mode][-1])} on an honest run")
        for name in ("randousha_deal", "randousha_extract_pc",
                     "randousha_check"):
            check(counts[name] == want, f"per-column {mode} launched {name} "
                                        f"{counts[name]} times, want {want}")
        check(counts["randousha_extract"] == 0
              and counts["open_direct"] == 0,
              f"per-column {mode}: an aggregate-mode kernel ran: {counts}")
        check(not any(plain.values()),
              f"per-column {mode}: a plain version ran on the card: {plain}")
        full[mode] = counts
        calls[mode] = {"launches": {k: v for k, v in counts.items() if v},
                       "peak_device_bytes": torch.cuda.max_memory_allocated(),
                       "first_call_ms": first_s * 1e3}
    keep_t, keep_2t, _ = out["double"]
    check(torch.equal(out["single"][0], keep_t), "single and double keep_t")
    ka, k2a, nerr_a = run_a(key)
    check(int(nerr_a) == 0, "aggregated run: nerr != 0")
    check(torch.equal(keep_t[:, :, :N_OUT], ka[:, :, :N_OUT])
          and torch.equal(keep_2t[:, :, :N_OUT], k2a[:, :, :N_OUT]),
          "per-column keep rows [:22] differ from the aggregated run's")
    del ka, k2a, out

    # the opened check values, stage by stage
    kd_t, kd_2, ke, kc_t, kc_2 = run_d.parts
    cols = kd_t(key)
    _, chk_t = ke(cols)
    del cols
    vt, et = kc_t(chk_t)
    cols = kd_2(key)
    _, chk_2 = ke(cols)
    del cols
    v2, e2 = kc_2(chk_2)
    check(not bool(et.any()) and not bool(e2.any())
          and torch.equal(vt[:, :2 * T], v2[:, :2 * T]),
          "opened check values differ between the degrees")
    sample = [(0, 0), (1, 17), (2 * T - 1, KT - 1), (T, KT // 2)]
    for c, s in sample:
        for chk, vals, k in ((chk_t, vt, K), (chk_2, v2, 2 * T + 1)):
            shares, _ = mont_ints(chk[:, :, c, s])
            lam = _lam_int(list(pts[:k]), 0)
            want = sum(l * y for l, y in zip(lam, shares[:k])) % P
            check(mont_ints(vals[:, c, s])[0][0] == want,
                  f"opened check value != Python ints at {(c, s)} k={k}")
    del chk_t, chk_2

    # faults: a flipped receive word at destination party 30 >= t+1 (a
    # validating party at degree t): nerr > 0, and its degree-t errs are 1
    # in every real check column at that slot and 0 elsewhere
    s0, dst = KT // 3, K + (N - K) // 5

    def flip(cols, degree):
        if degree == T:
            cols[3, dst, 7, s0] ^= 0x10
        return cols

    nerr_flip = int(run_d(key, tamper=flip)[2])
    check(nerr_flip > 0, "per-column run missed a flipped receive word")
    _, chk_t = ke(flip(kd_t(key), T))
    _, et = kc_t(chk_t)
    want = torch.zeros_like(et)
    want[:2 * T, s0] = 1
    check(torch.equal(et, want), "flipped word: degree-t errs not 1 in "
                                 "every real check column at its slot")
    del chk_t

    # the known-rho bypass: two dealers who know rho shift their degree-2t
    # secrets with delta1*S(d1) + delta2*S(d2) = 0
    rho = mont_limbs_ints(fr._rho_plain(key, dev)[:, :2 * T])
    d1, d2 = 2, 5
    S = [sum(r * pow(pts[N_OUT + c], d, P) for c, r in enumerate(rho)) % P
         for d in (d1, d2)]
    check(S[0] != 0 and S[1] != 0, "degenerate rho sums")
    delta1 = 12345
    delta2 = (-delta1 * S[0] * pow(S[1], P - 2, P)) % P

    def collude(cols, degree):
        if degree == 2 * T:
            shift_dealer(shift_dealer(cols, d1, delta1), d2, delta2)
        return cols

    nerr_agg = int(run_a(key, tamper=collude)[2])
    nerr_pc = int(run_d(key, tamper=collude)[2])
    check(nerr_agg == 0, "bypass failed: the aggregated check caught it")
    check(nerr_pc > 0, "the per-column check missed the known-rho bypass")
    say("per_column", ok=True, n=N, t=T, k=KT, calls=calls,
        extracted_equal_aggregate_run=True,
        python_int_samples=2 * len(sample), nerr_flipped_word=nerr_flip,
        bypass_nerr={"aggregate": nerr_agg, "per_column": nerr_pc},
        seconds=round(time.perf_counter() - t0, 3))

    # timing: a new key every call; device time of one more, profiled
    rates = {}
    nrep = max(5, min(reps, 10))
    for mode, run in (("double", run_d), ("single", run_s)):
        run((3100, 0))
        sync()
        t1 = time.perf_counter()
        for r in range(nrep):
            res = run((3101, r))
        sync()
        dt = (time.perf_counter() - t1) / nrep
        check(int(res[-1]) == 0, f"timed per-column {mode}: nerr != 0")
        del res
        busy_ms, nkern, top = device_busy_ms(lambda: run((3102, 0)), 6)
        rates[mode] = {"ms_per_call": dt * 1e3,
                       "sharings_per_s": N_OUT * KT / dt,
                       "device_busy_ms_per_call": busy_ms,
                       "device_kernels_per_call": nkern,
                       "device_ms_top_kernels": top, "timed_calls": nrep,
                       "launches_per_call": calls[mode]["launches"],
                       "peak_device_bytes":
                       calls[mode]["peak_device_bytes"],
                       # CUDA events around one call (host gaps between
                       # launches included): where the trace drops a
                       # launch, busy time is a lower bound and this an
                       # upper one
                       "device_ms_cuda_events": timed_once(
                           lambda: run((3103, 0)))}
        if nkern < sum(calls[mode]["launches"].values()):
            rates[mode]["device_busy_ms_per_call"] = None
        torch.cuda.empty_cache()
    return full["double"], rates


# -- phases 20-21: the MPC runtime core and the models ------------------------

RT_B = 1 << 16                    # values per multiply (an open of 2^17)
RT_REPS = 3                       # timed multiplies per strategy
RT_INV_B = 4096                   # inversions and divisions
RT_GAO_B = 220                    # the multiply with 21 lying parties
EQ_B, LT_B = 1024, 256            # equality and less-than comparisons
REF_BATCHES, REF_D1 = 1024, 64    # refine_triples: batches of d+1 triples
MIMC_B = 1000                     # bench_mimc's largest batch
NET_K = 1024                      # the asynchromix butterfly epoch
# the direct open, the sampler and the band encode (the dealer), mont_mul
RUNTIME_KERNELS = ("open_direct", "rand_limbs", "band_matmul", "mont_mul")
# fp_matmul's routes: the Gao redo and refinement's interpolations
MATMUL_KERNELS = ("fp_matmul_cios", "mxu_fused2", "mxu_fused", "mxu_redc")


def rt_values(seed, count, bound=P):
    """`count` Python ints in [0, bound) from a seed (host side)."""
    rng = random.Random(seed)
    return [rng.randrange(bound) for _ in range(count)]


def rt_share(ctx, vals):
    """Degree-t shares [n, B] of the values, dealt by the context's dealer
    (the sampler and the band encode on the card)."""
    return ctx.ShareArray(ctx.preproc._share_values(
        FpArray.from_ints(vals, device=ctx.device)))


def rt_open_ints(sa):
    """Open a ShareArray (the context checks that every party's view is
    equal); party 0's values as Python ints."""
    return party0_ints(sa.open())


def party0_ints(opened):
    """Party 0's row of an opened [n, ...] FpArray as Python ints (the
    other 63 copies are not converted on the host)."""
    return [int(v) for v in FpArray(opened.limbs[:, 0]).to_ints().reshape(-1)]


def rt_check_clean(what):
    plain = read_plain()
    check(all(v == 0 for v in plain.values()),
          f"{what}: plain versions ran on the card: {plain}")


def rt_profile(fn, cpu=True):
    """Device-busy ms, kernel launches and the top kernels of one call."""
    busy, count, top = device_busy_ms(fn, 12, cpu)
    check(count > 0, "the profiler saw no kernel of the call")
    return {"device_busy_ms": busy, "kernel_launches": count,
            "device_ms_top_kernels": top}


def rt_timed(fn, units, count, reps, deal=lambda: None, cpu=True):
    """Host-clock ms per call over `reps` calls (each ends in a
    synchronize) and the rate; the peak bytes of one more call above what
    was allocated before it, and its device profile (`cpu` as for
    device_busy_ms). `deal` fills the pools before each call, outside its
    window; nothing else draws."""
    secs = 0.0
    for _ in range(reps):
        deal()
        secs += host_timed(fn)[1]
    ms = secs / reps * 1e3
    deal()
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    sync()
    peak = torch.cuda.max_memory_allocated() - base
    deal()
    sync()
    return {"ms_per_call": ms, units: count / ms * 1e3,
            "peak_bytes_per_call": peak, **rt_profile(fn, cpu)}


def beaver_breakdown(ctx, x, y):
    """Where the device time of one Beaver multiply goes: the whole
    multiply, its open alone (pack, direct open, unpack, the agreement
    check) and its mont_mul launches; the rest is the int64 add_mod /
    sub_mod ripples and the concatenations."""
    from honeybadgermpc_tpu_torch.runtime.context import ShareArray
    mul = rt_profile(lambda: x * y)
    B = x.v.shape[-1]
    a, b, _ = ctx.preproc.get_triples(B)
    both = ShareArray.concat([x - ctx.from_preproc(a),
                              y - ctx.from_preproc(b)])
    sync()
    opn = rt_profile(lambda: ctx.open_share_array(both))
    mont_ms = sum(v for k, v in mul["device_ms_top_kernels"].items()
                  if "mont_mul" in k)
    return {"multiply_busy_ms": mul["device_busy_ms"],
            "open_busy_ms": opn["device_busy_ms"],
            "open_top_kernels": opn["device_ms_top_kernels"],
            "mont_mul_ms": mont_ms,
            "add_sub_glue_ms": mul["device_busy_ms"]
            - opn["device_busy_ms"] - mont_ms,
            "multiply_top_kernels": mul["device_ms_top_kernels"],
            "multiply_launches": mul["kernel_launches"]}


def host_timed(fn):
    """(result, host-clock seconds) of one call that ends in a
    synchronize."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def phase_runtime(dev, reps):
    """The MPC runtime core at n=64, t=21 through MpcContext and
    ShareArray's operators, each result against Python ints: Beaver and
    double-sharing multiplies of B = 65,536, invert and divide, a multiply
    with 21 lying parties (the Gao redo), equality and less-than,
    refine_triples. The launch counts are set to 0 just before and read
    after the checked calls (each op's first call); the timed calls come
    after, warm, each on pools dealt before its window."""
    from honeybadgermpc_tpu_torch.runtime import comparison
    from honeybadgermpc_tpu_torch.runtime.context import (
        MixinConstants, MpcContext, double_sharing_multiply_arrays)
    from honeybadgermpc_tpu_torch.runtime.refinement import refine_triples
    t_start = time.perf_counter()
    pre = PreProcessedElements(N, T, seed=1515, device=dev)
    ctx = comparison.install(MpcContext(N, T, preproc=pre, device=dev))
    dsh = MpcContext(N, T, preproc=pre, device=dev, mixins={
        MixinConstants.MultiplyShareArray: double_sharing_multiply_arrays})
    sync()
    reset_launches()
    rows = {}

    # Beaver and double-sharing multiplies, all products checked
    xs, ys = rt_values(1, RT_B), rt_values(2, RT_B)
    want = [u * v % P for u, v in zip(xs, ys)]
    x, y = rt_share(ctx, xs), rt_share(ctx, ys)
    pre.generate_triples(RT_B)
    pre.generate_double_shares(RT_B)
    for name, c in (("beaver", ctx), ("double_sharing", dsh)):
        xc, yc = c.ShareArray(x.v), c.ShareArray(y.v)
        z, secs = host_timed(lambda: xc * yc)
        check(rt_open_ints(z) == want, f"{name} multiply: wrong products")
        rows[name] = {"B": RT_B, "products_checked": RT_B,
                      "first_call_ms": secs * 1e3}
    check(pre._pool("triples").remaining() == 0
          and pre._pool("double_shares").remaining() == 0,
          "a multiply took other than B preprocessed elements")

    # invert and divide
    nz = [v or 1 for v in rt_values(3, RT_INV_B)]
    nz2 = [v or 1 for v in rt_values(4, RT_INV_B)]
    pre.generate_rands(2 * RT_INV_B)
    pre.generate_triples(3 * RT_INV_B)
    xi, yi = rt_share(ctx, nz), rt_share(ctx, nz2)
    inv, inv_s = host_timed(xi.invert)
    check(rt_open_ints(inv) == [pow(v, P - 2, P) for v in nz],
          "invert: wrong values")
    quo, div_s = host_timed(lambda: xi / yi)
    check(rt_open_ints(quo) == [u * pow(v, P - 2, P) % P
                                for u, v in zip(nz, nz2)],
          "divide: wrong values")
    rows["invert_divide"] = {"B": RT_INV_B, "invert_ms": inv_s * 1e3,
                             "divide_ms": div_s * 1e3}

    # a multiply with 21 lying parties: the Gao redo corrects the open
    gx, gy = rt_values(5, RT_GAO_B), rt_values(6, RT_GAO_B)
    pre.generate_triples(RT_GAO_B)
    sx, sy = rt_share(ctx, gx), rt_share(ctx, gy)
    bad = rec.inject_share_faults(sx.v, SimBackend(N).my_ids(dev),
                                  BAD_PARTIES, (1515, 7))
    check(not torch.equal(bad.limbs, sx.v.limbs), "no share was corrupted")
    before = ctx.nerr_total.clone()
    z, gao_s = host_timed(lambda: ctx.ShareArray(bad) * sy)
    nerr = (ctx.nerr_total - before).tolist()
    check(tuple(ctx.nerr_total.shape) == (N,), "nerr_total is not [n]")
    # the 220 x - a values are 10 chunks of t+1, each with 21 wrong sources
    check(nerr == [RT_GAO_B // K * len(BAD_PARTIES)] * N,
          f"Gao multiply: per-party counts {nerr}")
    check(rt_open_ints(z) == [u * v % P for u, v in zip(gx, gy)],
          "Gao multiply: wrong products")
    rows["gao_multiply"] = {"B": RT_GAO_B, "lying_parties": len(BAD_PARTIES),
                            "nerr_per_party": nerr[0], "ms": gao_s * 1e3}

    # equality (half the pairs equal) and less-than (some pairs equal)
    ex = rt_values(7, EQ_B)
    ey = [v if i % 2 == 0 else w
          for i, (v, w) in enumerate(zip(ex, rt_values(8, EQ_B)))]
    la, lb = rt_values(9, LT_B, 1 << 250), rt_values(10, LT_B, 1 << 250)
    lb[:LT_B // 32] = la[:LT_B // 32]

    def deal_equality():
        pre.generate_bits(32 * EQ_B)
        pre.generate_rands(64 * EQ_B)
        pre.generate_triples(127 * EQ_B)

    def deal_less_than():
        pre.generate_share_bits(2 * LT_B)
        pre.generate_triples(768 * LT_B)

    deal_equality()
    ea, eb = rt_share(ctx, ex), rt_share(ctx, ey)
    eq, eq_s = host_timed(lambda: ea == eb)
    check([v != 0 for v in rt_open_ints(eq)] == [u == v for u, v in
                                                 zip(ex, ey)],
          "equality: wrong results")
    deal_less_than()
    lsa, lsb = rt_share(ctx, la), rt_share(ctx, lb)
    lt, lt_s = host_timed(lambda: lsa < lsb)
    check(rt_open_ints(lt) == [int(u < v) for u, v in zip(la, lb)],
          "less_than: wrong results")
    check(pre._pool("triples").remaining() == 0
          and pre._pool("bits").remaining() == 0
          and pre._pool("share_bits").remaining() == 0,
          "the comparisons took other than their preprocessing")
    rows["comparison"] = {"equality_B": EQ_B, "less_than_B": LT_B,
                          "equality_first_call_ms": eq_s * 1e3,
                          "less_than_first_call_ms": lt_s * 1e3}

    # refine_triples: 1,024 batches of 64 dirty triples, 43 out each
    nd = REF_BATCHES * REF_D1
    kout = REF_D1 - T

    def dirty():
        pre.generate_triples(nd + REF_BATCHES * (REF_D1 - 1))
        return [ctx.ShareArray(v.reshape(N, REF_BATCHES, REF_D1))
                for v in pre.get_triples(nd)]

    da, db, dc = dirty()
    (ra, rb, rc), ref_s = host_timed(lambda: refine_triples(ctx, da, db, dc))
    check(tuple(ra.shape) == (REF_BATCHES, kout), "refined shape")
    va, vb, vc = (party0_ints(v)
                  for v in ctx.open_share_arrays([ra, rb, rc]))
    check(len(va) == REF_BATCHES * kout
          and all(a * b % P == c for a, b, c in zip(va, vb, vc)),
          "refine_triples: c != a*b")
    rows["refine_triples"] = {"batches": REF_BATCHES, "d_plus_1": REF_D1,
                              "out_per_batch": kout,
                              "first_call_ms": ref_s * 1e3}

    sync()
    launches = read_launches()
    rt_check_clean("runtime phase")
    for name in RUNTIME_KERNELS:
        check(launches[name] > 0, f"the runtime path never ran {name}")
    check(any(launches[k] > 0 for k in MATMUL_KERNELS),
          f"no fp_matmul route ran: {launches}")
    check(tuple(ctx.nerr_total.shape) == (N,)
          and ctx.nerr_total.dtype == torch.int32, "nerr_total not int32 [n]")
    say("runtime", ok=True, n=N, t=T, checks=rows,
        launches={k: v for k, v in launches.items() if v},
        seconds=time.perf_counter() - t_start)

    # timing: warm calls, each on pools dealt before its window
    timing = {}
    for name, c, kind in (("beaver", ctx, "triples"),
                          ("double_sharing", dsh, "double_shares")):
        # warm, timed, peak and profiled calls; the breakdown's two
        getattr(pre, f"generate_{kind}")(
            RT_B * (reps + (5 if name == "beaver" else 3)))
        xc, yc = c.ShareArray(x.v), c.ShareArray(y.v)
        xc * yc
        timing[name] = rt_timed(lambda: xc * yc, "multiplies_per_s", RT_B,
                                reps)
        if name == "beaver":
            timing[name]["breakdown"] = beaver_breakdown(c, xc, yc)
    deal_equality()
    _, secs = host_timed(lambda: ea == eb)
    timing["equality"] = {"B": EQ_B, "ms": secs * 1e3,
                          "comparisons_per_s": EQ_B / secs}
    deal_less_than()
    _, secs = host_timed(lambda: lsa < lsb)
    timing["less_than"] = {"B": LT_B, "ms": secs * 1e3,
                           "comparisons_per_s": LT_B / secs}
    da, db, dc = dirty()
    _, secs = host_timed(lambda: refine_triples(ctx, da, db, dc))
    timing["refine_triples"] = {"ms": secs * 1e3, "refined_triples_per_s":
                                REF_BATCHES * kout / secs}
    timing["gao_multiply_ms"] = gao_s * 1e3
    torch.cuda.empty_cache()
    return launches, timing


def phase_models(dev):
    """MiMC (one body under both of the reference's names) at bench_mimc's
    batch of 1,000 against mimc_plain, and the k = 1,024 butterfly network (100
    rounds of 512 switches) opening to a shuffle of its inputs, with the
    launch counts set to 0 just before and read after the checked calls;
    then a warm call of each timed by the host clock, on pools dealt
    before its window."""
    from honeybadgermpc_tpu_torch.models import butterfly, mimc
    from honeybadgermpc_tpu_torch.runtime.context import MpcContext
    t_start = time.perf_counter()
    pre = PreProcessedElements(N, T, seed=1516, device=dev)
    ctx = MpcContext(N, T, preproc=pre, device=dev)
    sync()
    reset_launches()
    key = rt_values(20, 1)[0]
    msg = rt_values(21, MIMC_B)
    want = [mimc.mimc_plain(m, key) for m in msg]
    xm = rt_share(ctx, msg)
    check(mimc.mimc_mpc_batch_jit is mimc.mimc_mpc_batch,
          "mimc_mpc_batch_jit: not the one body of mimc_mpc_batch")
    pre.generate_cubes(mimc.ROUND * MIMC_B)
    enc = mimc.mimc_mpc_batch_jit(ctx, xm, key)
    check(rt_open_ints(enc) == want, "mimc_mpc_batch_jit: != mimc_plain")
    rounds = int(math.log2(NET_K)) ** 2

    def deal_net():
        pre.generate_one_minus_ones(rounds * NET_K // 2)
        pre.generate_triples(rounds * NET_K // 2)

    vals = rt_values(22, NET_K)
    xs = rt_share(ctx, vals)
    deal_net()
    out = butterfly.iterated_butterfly_network_jit(ctx, xs, NET_K)
    got = rt_open_ints(out)
    check(sorted(got) == sorted(vals) and got != vals,
          "butterfly: the output is not a shuffle of the input")
    check(pre._pool("triples").remaining() == 0
          and pre._pool("one_minus_ones").remaining() == 0,
          "butterfly: one take per kind, all used")
    sync()
    launches = read_launches()
    rt_check_clean("models phase")
    for name in RUNTIME_KERNELS:
        check(launches[name] > 0, f"the models path never ran {name}")
    check(ctx.nerr_total.tolist() == [0] * N, "honest models: nerr != 0")
    say("models", ok=True, n=N, t=T, mimc_B=MIMC_B, net_k=NET_K,
        launches={k: v for k, v in launches.items() if v},
        seconds=time.perf_counter() - t_start)

    timing = {}
    pre.generate_cubes(mimc.ROUND * MIMC_B)
    _, secs = host_timed(lambda: mimc.mimc_mpc_batch_jit(ctx, xm, key))
    timing["mimc_mpc_batch_jit"] = {"B": MIMC_B, "ms": secs * 1e3,
                                    "blocks_per_s": MIMC_B / secs}
    deal_net()
    _, secs = host_timed(
        lambda: butterfly.iterated_butterfly_network_jit(ctx, xs, NET_K))
    timing["butterfly_network"] = {"k": NET_K, "rounds": rounds,
                                   "switches": rounds * NET_K // 2,
                                   "ms": secs * 1e3}
    deal_net()
    timing["butterfly_network"].update(rt_profile(
        lambda: butterfly.iterated_butterfly_network_jit(ctx, xs, NET_K)))
    torch.cuda.empty_cache()
    return launches, timing


# -- phase 22: fixed point, power mixing and the AsynchroMix app --------------

FX_MUL_B, FX_LT_B, FX_TRUNC_B = 4096, 1024, 1024
FX_SIGNED_BITS = 62               # |x| < 2^62 for trunc and div2m
PM_KS = (64, 256)                 # the bench's power-mix rows
EPOCH_K = 64                      # the event-driven epoch


def fx_reps(seed, count):
    """Fixed-point values in [-100, 100) from a seed and their reps."""
    from honeybadgermpc_tpu_torch.models.fixedpoint import \
        to_fixed_point_repr
    rng = random.Random(seed)
    vals = [rng.uniform(-100.0, 100.0) for _ in range(count)]
    return vals, [to_fixed_point_repr(v) for v in vals]


def signed_ints(opened):
    """Party 0's opened values as signed ints (above p/2: negative)."""
    return [v - P if v > P // 2 else v for v in party0_ints(opened)]


def mix_pairs(group, msgs, poly):
    """The clients' masked inputs (m + r, i) of an epoch: each mask r
    interpolated from t+1 servers' shares (the bench's client path)."""
    pairs = []
    for i, m in enumerate(msgs):
        mask = int(poly.interpolate_at(
            [(j + 1, group.mask_share(j, i)) for j in range(T + 1)], 0))
        pairs.append(((m + mask) % P, i))
    return pairs


def power_mix_breakdown(group, pairs, want):
    """Where a warm power-mix epoch's host time goes: compute_power_shares
    (its open of e = m - b included), that open alone, power_sums (the
    sum and the second open), that open alone, Newton and the host root
    finder; then the device profile and peak bytes of compute_power_shares
    (O(k) launch groups: its launches), each on freshly dealt powers."""
    from honeybadgermpc_tpu_torch.models import powermixing as pm
    ctx, k = group.ctx, group.k
    msg = group.message_shares(pairs)
    group.pre.generate_powers(k, k)
    bp = ctx.from_preproc(group.pre.get_powers(k))
    b1 = ctx.ShareArray(FpArray(bp.v.limbs[..., 0]), bp.t)
    mp, cps_s = host_timed(lambda: pm.compute_power_shares(ctx, msg, bp))
    _, open1_s = host_timed(lambda: ctx.open_share_array(msg - b1))
    sums, ps_s = host_timed(lambda: pm.power_sums(ctx, mp))
    summed = ctx.ShareArray(pm._sum_axis(mp.v, 1), mp.t)
    _, open2_s = host_timed(lambda: ctx.open_share_array(summed))
    psums = party0_ints(sums)
    roots, roots_s = host_timed(
        lambda: pm.find_roots(pm.newton_inversion(psums, k)))
    check(roots == want, f"power mix k={k}: the pieces' roots are wrong")
    group.pre.generate_powers(k, k)
    bp = ctx.from_preproc(group.pre.get_powers(k))
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pm.compute_power_shares(ctx, msg, bp)
    sync()
    peak = torch.cuda.max_memory_allocated() - base
    group.pre.generate_powers(k, k)
    bp = ctx.from_preproc(group.pre.get_powers(k))
    sync()
    prof = rt_profile(lambda: pm.compute_power_shares(ctx, msg, bp))
    return {"compute_power_shares_ms": cps_s * 1e3,
            "open_e_ms": open1_s * 1e3, "power_sums_ms": ps_s * 1e3,
            "open_sums_ms": open2_s * 1e3,
            "newton_find_roots_host_ms": roots_s * 1e3,
            "compute_power_shares_chunks": len(list(pm._chunks(
                k, pm.CHUNK_ELEMENTS // (N * k)))),
            "compute_power_shares_peak_bytes": peak,
            "compute_power_shares_device_busy_ms": prof["device_busy_ms"],
            "compute_power_shares_launches": prof["kernel_launches"],
            "compute_power_shares_top_kernels":
                prof["device_ms_top_kernels"]}


def phase_apps(dev, triples_per_s):
    """Fixed-point arithmetic, power mixing and the AsynchroMix app at
    n=64, t=21, each result against a host oracle, with the launch counts
    set to 0 just before and read after the checked calls; then warm calls
    timed by the host clock (with device busy, launches and peak bytes
    where the profiler applies), every pool dealt before its window."""
    import asyncio

    from honeybadgermpc_tpu_torch import GF
    from honeybadgermpc_tpu_torch.apps import asynchromix as amx
    from honeybadgermpc_tpu_torch.models import fixedpoint as fx
    from honeybadgermpc_tpu_torch.polynomial import polynomials_over
    from honeybadgermpc_tpu_torch.runtime.context import MpcContext
    t_start = time.perf_counter()
    pre = PreProcessedElements(N, T, seed=1517, device=dev)
    ctx = MpcContext(N, T, preproc=pre, device=dev)
    poly = polynomials_over(GF(P))
    sync()
    reset_launches()
    rows, timing = {}, {}

    # fixed point: a multiply of B = 4,096, lt, trunc and div2m of 1,024
    av, ar = fx_reps(30, FX_MUL_B)
    bv, br = fx_reps(31, FX_MUL_B)

    def deal_mul():                  # trunc_pr's 32 + 128 bits, one triple
        pre.generate_bits((2 * fx.K + fx.KAPPA) * FX_MUL_B)
        pre.generate_triples(FX_MUL_B)

    pre.generate_zeros(2 * FX_MUL_B)
    deal_mul()
    a, b = fx.FixedPointArray(ctx, av), fx.FixedPointArray(ctx, bv)
    prod, mul_s = host_timed(lambda: a * b)
    got = party0_ints(ctx.open_share_array(prod.share))
    check(all((g - (x * y >> fx.F)) % P in (0, 1)
              for g, x, y in zip(got, ar, br)),
          "fixed-point multiply: not the truncated product of the reps")
    floats = prod.open()
    check(floats.shape == (N, FX_MUL_B) and bool(
        (abs(floats - [x * y for x, y in zip(av, bv)]) <= 1e-3).all()),
        "fixed-point multiply: off the float product by more than 1e-3")

    lv, lr = fx_reps(32, FX_LT_B)
    mv, mr = fx_reps(33, FX_LT_B)
    mv[:FX_LT_B // 8], mr[:FX_LT_B // 8] = lv[:FX_LT_B // 8], \
        lr[:FX_LT_B // 8]

    def deal_lt():                   # trunc(K, K-1): 63 + 33 bits, a
        pre.generate_bits((fx.K + fx.KAPPA) * FX_LT_B)     # 64-leaf tree
        pre.generate_triples(3 * (fx.K - 1) * FX_LT_B)

    pre.generate_zeros(2 * FX_LT_B)
    deal_lt()
    la, lb = fx.FixedPointArray(ctx, lv), fx.FixedPointArray(ctx, mv)
    lt, lt_s = host_timed(lambda: la.lt(lb))
    check(party0_ints(ctx.open_share_array(lt))
          == [int(x < y) for x, y in zip(lr, mr)],
          "fixed-point lt: wrong results")

    xs = [v - (1 << FX_SIGNED_BITS) for v in
          rt_values(34, FX_TRUNC_B, 1 << (FX_SIGNED_BITS + 1))]
    m = fx.F

    def deal_trunc():                # div2m: 32 + 64 bits, a 33-leaf tree
        pre.generate_bits((fx.K + fx.KAPPA) * FX_TRUNC_B)
        pre.generate_triples(3 * m * FX_TRUNC_B)

    deal_trunc()
    deal_trunc()
    xsh = rt_share(ctx, xs)
    q, trunc_s = host_timed(lambda: fx.trunc(ctx, xsh, fx.K, m))
    r, div2m_s = host_timed(lambda: fx.div2m(ctx, xsh, fx.K, m))
    qo, ro = ctx.open_share_arrays([q, r])
    check(signed_ints(qo) == [v >> m for v in xs], "trunc: wrong quotients")
    check(party0_ints(ro) == [v % (1 << m) for v in xs],
          "div2m: wrong remainders")
    rows["fixed_point"] = {
        "mul_B": FX_MUL_B, "lt_B": FX_LT_B, "trunc_div2m_B": FX_TRUNC_B,
        "first_call_ms": {"mul": mul_s * 1e3, "lt": lt_s * 1e3,
                          "trunc": trunc_s * 1e3, "div2m": div2m_s * 1e3}}

    # the power mix at the bench's k = 64 and 256: epoch 0 checked
    groups = {}
    for k in PM_KS:
        group = amx.ServerGroupSim(N, T, k, seed=3, mix="powers", device=dev)
        group.deal_masks(k)
        msgs = rt_values(40 + k, k, 1 << 64)
        pairs = mix_pairs(group, msgs, poly)
        out, secs = host_timed(lambda: group.mix_epoch(0, pairs))
        check(out == sorted(msgs), f"power mix k={k}: not the message set")
        groups[k] = (group, pairs, sorted(msgs))
        rows[f"power_mix_k{k}"] = {"first_epoch_ms": secs * 1e3}

    # the butterfly epoch at k = 1,024 (the bench's north-star row)
    net = amx.ServerGroupSim(N, T, NET_K, seed=3, device=dev)
    net.deal_masks(NET_K)
    net.deal_mix_preproc(2)
    nmsgs = rt_values(50, NET_K, 1 << 64)
    npairs = mix_pairs(net, nmsgs, poly)
    out, secs = host_timed(lambda: net.mix_epoch(0, npairs))
    check(out == sorted(nmsgs), "butterfly epoch: not the message set")
    rows["butterfly_epoch"] = {"k": NET_K, "first_epoch_ms": secs * 1e3}

    # one event-driven epoch through the coordinator, untimed
    messages, mixed = asyncio.run(asyncio.wait_for(amx.run_one_epoch(
        n=N, t=T, k=EPOCH_K, seed=17, mix="powers", device=dev), 600))
    check(mixed == sorted(messages), "event-driven epoch: wrong output")
    rows["event_driven_epoch"] = {"n": N, "t": T, "k": EPOCH_K,
                                  "mix": "powers", "messages": len(mixed)}

    sync()
    launches = read_launches()
    rt_check_clean("apps phase")
    for name in RUNTIME_KERNELS:
        check(launches[name] > 0, f"the apps path never ran {name}")
    check(ctx.nerr_total.tolist() == [0] * N, "honest apps: nerr != 0")
    say("apps", ok=True, n=N, t=T, checks=rows,
        launches={k: v for k, v in launches.items() if v},
        seconds=time.perf_counter() - t_start)

    # warm calls, each on pools dealt before its window
    timing["fixed_point_mul"] = rt_timed(lambda: a * b, "multiplies_per_s",
                                         FX_MUL_B, 1, deal_mul)
    timing["fixed_point_lt"] = rt_timed(
        lambda: la.lt(lb), "comparisons_per_s", FX_LT_B, 1, deal_lt)
    timing["trunc"] = rt_timed(lambda: fx.trunc(ctx, xsh, fx.K, m),
                               "values_per_s", FX_TRUNC_B, 1, deal_trunc)
    timing["div2m"] = rt_timed(lambda: fx.div2m(ctx, xsh, fx.K, m),
                               "values_per_s", FX_TRUNC_B, 1, deal_trunc)
    for k, (group, pairs, want) in groups.items():
        group.pre.generate_powers(k, k)
        out, secs = host_timed(lambda: group.mix_epoch(1, pairs))
        check(out == want, f"power mix k={k}: warm epoch wrong")
        timing[f"power_mix_k{k}"] = {
            "k": k, "epoch_ms": secs * 1e3, "messages_per_s": k / secs,
            **power_mix_breakdown(group, pairs, want)}
    out, secs = host_timed(lambda: net.mix_epoch(1, npairs))
    check(out == sorted(nmsgs), "butterfly epoch: warm epoch wrong")
    rounds = int(math.log2(NET_K)) ** 2
    need = rounds * NET_K
    refill = need / triples_per_s
    timing["butterfly_epoch"] = {
        "k": NET_K, "switch_rounds": rounds, "epoch_ms": secs * 1e3,
        "messages_per_s_online": NET_K / secs,
        "triples_per_epoch": need, "triple_rate_per_s": triples_per_s,
        "refill_ms": refill * 1e3,
        "messages_per_s_with_refill": NET_K / (secs + refill),
        "offline_fraction": refill / (secs + refill)}
    del groups, net
    torch.cuda.empty_cache()
    timing["seconds"] = time.perf_counter() - t_start
    return launches, timing


# -- phase 23: the fused runner (CUDA graphs), Jubjub and the PKC -------------

JJ_B = 64                         # the bench's batch (run_benchmarks.py:262)
JJ_BIG = 4096
JJ_SCALAR = 0xFFFF                # jubjub_scalar_mul16's 16-bit ladder
PKC_BITS, PKC_MSGS = 64, 64
FUSED_REPS = 3


def _jubjub_add_double(c, px, py):
    """The bench's program (benchmark/run_benchmarks.py:242-246)."""
    from honeybadgermpc_tpu_torch.models.jubjub import SharedPoint
    pt = SharedPoint(c, c.ShareArray(px.v, px.t), c.ShareArray(py.v, py.t))
    out = pt.add(pt.double())
    return out.xs, out.ys


def _eager_ladder(ctx, sp, scalar):
    """The program jubjub_mul_jit replays, called eagerly on ctx: its
    ladder step looped over the scalar's bits (MSB first)."""
    from honeybadgermpc_tpu_torch.models.jubjub import (SharedPoint,
                                                        _ladder_step)
    from honeybadgermpc_tpu_torch.elliptic_curve import Point
    bits = torch.tensor([(scalar >> i) & 1
                         for i in reversed(range(scalar.bit_length()))],
                        dtype=torch.int32, device=ctx.device)
    ident = SharedPoint.from_point(ctx, Point(0, 1, sp.curve),
                                   sp.xs.v.shape[ctx.lead:])
    carry = (ident.xs, ident.ys, sp.xs, sp.ys)
    for bit in bits:
        carry = _ladder_step(ctx, carry, bit)
    return SharedPoint(ctx, carry[0], carry[1], sp.curve)


def multiples(base, count):
    """[i * base for i = 1..count] on the host, one curve addition each."""
    pts, acc = [], base
    for _ in range(count):
        pts.append(acc)
        acc = acc + base
    return pts


def share_points(ctx, pts):
    """Degree-t shares of the points' coordinates (the port's dealer)."""
    return (rt_share(ctx, [int(q.x) for q in pts]),
            rt_share(ctx, [int(q.y) for q in pts]))


def opened_points(xs, ys):
    """Open two coordinate ShareArrays [n, B] in one open -> [(x, y)]."""
    ox, oy = xs.ctx.open_share_arrays([xs, ys])
    return list(zip(party0_ints(ox), party0_ints(oy)))


def coords(pts):
    return [(int(q.x), int(q.y)) for q in pts]


def top_up(pre, demand, calls=1):
    """Deal each kind until the pool holds `calls` times the demand."""
    for kind, c in demand.items():
        need = c * calls - pre._pool(kind).remaining()
        if need > 0:
            getattr(pre, "generate_" + kind)(need)


def pool_state(pre):
    return {k: (list(p.segs), p.cursor) for k, p in pre._pools.items()}


def restore_pools(pre, state):
    for k, (segs, cursor) in state.items():
        pool = pre._pool(k)
        pool.segs, pool.cursor = list(segs), cursor


def replay_name(key):
    """A fused cache key -> "<program> B=<batch>" ("scan <step> ..." for a
    scan's step)."""
    if key[0] == "scan":
        return f"scan {key[1].__name__} B={key[7][0][0][-1]}"
    return f"{key[0].__name__} B={key[-1][0][0][-1]}"


def phase_fused(dev):
    """The fused runner at n=64, t=21 (robust opens): the bench's
    jubjub_add_double program through run_fused at B = 64 and 4,096 on
    distinct points i*GP (a captured CUDA graph replayed per call) against
    the host oracle 3*P_i and word for word against the same program
    called eagerly on the same pool slices; jubjub_mul_jit(0xFFFF) at
    B = 64 (one captured ladder step replayed 16 times) against
    0xFFFF*P_i and word for word against its step looped eagerly on the
    same pool slices, and the eager montgomery_mul against 0xFFFF*P_i;
    share_mul of a 64-bit shared key and the PKC round trip of 64
    messages; a call whose argument shares 21 parties falsified (redone
    eagerly with robust opens); a cache hit, and a replay after the
    public-constant cache was cleared and junk allocated. Launch counts set to 0 just before and read after; then
    (``fused_timing``) both bench rows eager and replayed, pools dealt
    outside every window."""
    from honeybadgermpc_tpu_torch.elliptic_curve import Point
    from honeybadgermpc_tpu_torch.models import mimc_jubjub_pkc as pkc
    from honeybadgermpc_tpu_torch.models.jubjub import (SharedPoint,
                                                        jubjub_mul_jit,
                                                        share_mul)
    from honeybadgermpc_tpu_torch.ops import fparray
    from honeybadgermpc_tpu_torch.runtime import fused
    from honeybadgermpc_tpu_torch.runtime.context import MpcContext
    t_start = time.perf_counter()
    pre = PreProcessedElements(N, T, seed=1518, device=dev)
    ctx = MpcContext(N, T, preproc=pre, device=dev)
    gp = pkc.GP
    sync()
    reset_launches()
    rows, timing = {}, {}
    captures0, replays0 = fused.captures, fused.graph_replays
    redos0 = fused.fused_redos

    # add + double: fused against the oracle and the eager words
    demand = {}
    for B in (JJ_B, JJ_BIG):
        pts = multiples(gp, B)
        want = coords(multiples(gp * 3, B))
        px, py = share_points(ctx, pts)
        sync()
        base = torch.cuda.memory_allocated()
        dem, build_s = host_timed(
            lambda: fused.fused_demand(ctx, _jubjub_add_double, px, py))
        graph_bytes = torch.cuda.memory_allocated() - base
        demand[B] = dem
        top_up(pre, dem)
        state = pool_state(pre)
        (fx, fy), first_s = host_timed(
            lambda: fused.run_fused(ctx, _jubjub_add_double, px, py))
        check(opened_points(fx, fy) == want,
              f"run_fused add_double B={B}: != 3*P_i")
        restore_pools(pre, state)
        (ex, ey), eager_s = host_timed(
            lambda: _jubjub_add_double(ctx, px, py))
        check(torch.equal(ex.v.limbs, fx.v.limbs)
              and torch.equal(ey.v.limbs, fy.v.limbs),
              f"run_fused add_double B={B}: words != the eager call's")
        check(all(pre._pool(k).remaining() == 0 for k in dem),
              f"add_double B={B}: took other than its demand")
        rows[f"add_double_B{B}"] = {
            "B": B, "demand": dem, "build_ms": build_s * 1e3,
            "first_replay_ms": first_s * 1e3, "eager_ms": eager_s * 1e3,
            "graph_pool_bytes": graph_bytes, "points_checked": B}
        if B == JJ_B:
            keep = (px, py, want)
    check(fused.captures - captures0 == 2, "add_double: not one capture "
          "per shape")

    # a second call with the same shapes: a cache hit on fresh pools
    px, py, want = keep
    top_up(pre, demand[JJ_B])
    caps = fused.captures
    (fx, fy), _ = host_timed(
        lambda: fused.run_fused(ctx, _jubjub_add_double, px, py))
    check(fused.captures == caps, "the second call captured again")
    check(all(pre._pool(k).remaining() == 0 for k in demand[JJ_B]),
          "the second call did not take fresh pools")
    check(opened_points(fx, fy) == want, "cache hit: != 3*P_i")

    # the graphs pin the public constants they read: drop them from the
    # bounded cache, let junk take any freed block, replay again
    fparray._scalar_const.cache_clear()
    junk = [torch.full((L,), -1, dtype=torch.int32, device=dev)
            for _ in range(4096)]
    top_up(pre, demand[JJ_B])
    fx, fy = fused.run_fused(ctx, _jubjub_add_double, px, py)
    check(fused.captures == caps, "the call after the cache clear captured")
    check(opened_points(fx, fy) == want,
          "a replay after the constant cache was cleared: != 3*P_i")
    del junk

    # 21 lying parties in the argument shares: detect, then the eager redo
    bad = [ctx.ShareArray(rec.inject_share_faults(
        s.v, SimBackend(N).my_ids(dev), BAD_PARTIES, (1518, i)))
        for i, s in enumerate((px, py))]
    top_up(pre, demand[JJ_B])
    redos = fused.fused_redos
    (fx, fy), redo_s = host_timed(
        lambda: fused.run_fused(ctx, _jubjub_add_double, *bad))
    check(fused.fused_redos == redos + 1, "faulted call: not one redo")
    check(fused.captures == caps, "faulted call: captured again")
    check(opened_points(fx, fy) == want, "faulted call: != 3*P_i")
    rows["faulted_add_double"] = {"B": JJ_B, "lying_parties":
                                  len(BAD_PARTIES), "ms": redo_s * 1e3}

    # the 16-bit ladder: one captured step replayed per bit
    pts = multiples(gp, JJ_B)
    want16 = coords(multiples(gp * JJ_SCALAR, JJ_B))
    sp = SharedPoint(ctx, *share_points(ctx, pts))
    top_up(pre, demand[JJ_B], 16)
    state = pool_state(pre)
    reps = fused.graph_replays
    q, ladder_s = host_timed(lambda: jubjub_mul_jit(ctx, sp, JJ_SCALAR))
    check(fused.graph_replays - reps == 16, "jubjub_mul_jit: not 16 "
          "replays of its step")
    check(opened_points(q.xs, q.ys) == want16, "jubjub_mul_jit: != 0xFFFF*P")
    restore_pools(pre, state)
    el = _eager_ladder(ctx, sp, JJ_SCALAR)
    check(torch.equal(el.xs.v.limbs, q.xs.v.limbs)
          and torch.equal(el.ys.v.limbs, q.ys.v.limbs),
          "jubjub_mul_jit: words != its ladder step looped eagerly")
    top_up(pre, demand[JJ_B], 16)
    q, mont_s = host_timed(lambda: sp.montgomery_mul(JJ_SCALAR))
    check(opened_points(q.xs, q.ys) == want16, "montgomery_mul: != 0xFFFF*P")
    rows["scalar_mul16"] = {"B": JJ_B, "first_call_ms": ladder_s * 1e3,
                            "montgomery_mul_ms": mont_s * 1e3}

    # share_mul of a 64-bit shared key, then the PKC round trip
    key = rt_values(60, 1, 1 << PKC_BITS)[0]
    sbits = rt_share(ctx, [(key >> i) & 1 for i in range(PKC_BITS)])
    sbits = ctx.ShareArray(sbits.v.reshape(N, 1, PKC_BITS))
    pre.generate_triples(9 * PKC_BITS)
    pre.generate_rands(2 * PKC_BITS)
    q = share_mul(ctx, sbits, gp)
    check(opened_points(q.xs, q.ys) == coords([gp * key]),
          "share_mul: != key*GP")
    pre.generate_bits(PKC_BITS)
    pre.generate_triples(18 * PKC_BITS)
    pre.generate_rands(4 * PKC_BITS)
    (priv, pub), keygen_s = host_timed(
        lambda: pkc.key_generation(ctx, key_bits=PKC_BITS))
    x = sum(b << i for i, b in enumerate(party0_ints(priv.open())))
    check((int(pub.x), int(pub.y)) == coords([gp * x])[0],
          "key_generation: the public key is not x*GP")
    msgs = rt_values(61, PKC_MSGS)
    kg, cts = pkc.mimc_encrypt(pub, msgs, rt_values(62, 1, 1 << 64)[0])
    got, dec_s = host_timed(lambda: pkc.mimc_decrypt(ctx, priv, kg, cts))
    check(got == msgs, "mimc_decrypt: not the messages sent")
    rows["pkc"] = {"key_bits": PKC_BITS, "messages": PKC_MSGS,
                   "key_generation_ms": keygen_s * 1e3,
                   "decrypt_ms": dec_s * 1e3}

    sync()
    launches = read_launches()
    rt_check_clean("fused phase")
    for name in RUNTIME_KERNELS:
        check(launches[name] > 0, f"the fused path never ran {name}")
    check(fused.captures - captures0 == 3 and fused.graph_replays
          - replays0 == 5 + 16, "the replays did not go through graphs")
    check(fused.fused_redos - redos0 == 1, "honest calls were redone")
    check(ctx.nerr_total.tolist() == [0] * N, "honest eager calls: nerr")
    per_replay = {replay_name(k): v
                  for k, v in fused.launches_per_replay.items()}
    say("fused", ok=True, n=N, t=T, checks=rows,
        captures=fused.captures - captures0,
        graph_replays=fused.graph_replays - replays0,
        fused_redos=fused.fused_redos - redos0,
        wrapper_launches_per_replay=per_replay,
        launches={k: v for k, v in launches.items() if v},
        seconds=time.perf_counter() - t_start)

    # timing: both bench rows eager and replayed, pools dealt outside
    dem = demand[JJ_B]
    timing["jubjub_add_double"] = {
        "B": JJ_B,
        "eager": rt_timed(lambda: _jubjub_add_double(ctx, px, py),
                          "point_ops_per_s", 2 * JJ_B, FUSED_REPS,
                          lambda: top_up(pre, dem, 2)),
        "replay": rt_timed(
            lambda: fused.run_fused(ctx, _jubjub_add_double, px, py),
            "point_ops_per_s", 2 * JJ_B, FUSED_REPS,
            lambda: top_up(pre, dem, 2)),
        "build_ms": rows[f"add_double_B{JJ_B}"]["build_ms"]}
    # the ladder is about 268,000 launches a call: one timed eager call,
    # and the profiler traces the device alone
    timing["jubjub_scalar_mul16"] = {
        "B": JJ_B,
        "eager": rt_timed(lambda: _eager_ladder(ctx, sp, JJ_SCALAR),
                          "muls_per_s", JJ_B, 1,
                          lambda: top_up(pre, dem, 32), cpu=False),
        "replay": rt_timed(lambda: jubjub_mul_jit(ctx, sp, JJ_SCALAR),
                           "muls_per_s", JJ_B, FUSED_REPS,
                           lambda: top_up(pre, dem, 32), cpu=False),
        "first_call_ms": ladder_s * 1e3}
    for row in ("jubjub_add_double", "jubjub_scalar_mul16"):
        e, r = timing[row]["eager"], timing[row]["replay"]
        timing[row]["replay_speedup"] = e["ms_per_call"] / r["ms_per_call"]
    timing["wrapper_launches_per_replay"] = per_replay
    del keep, bad, sp, q, el
    torch.cuda.empty_cache()
    timing["seconds"] = time.perf_counter() - t_start
    return launches, timing


def ptxas_core(log):
    """Registers and spill bytes of the kernels on csrc/band_gemm.cuh, of
    the sampler and of rows 7 and 12, from ptxas' report in the build log:
    {"<kernel> lanes=<64 MB>" (rows 13 and 14: "<kernel> rounds=<r>
    pair=<0|1>"; the sampler: "rand_limbs_kernel"; row 7:
    "mul_add_packed4_kernel"; row 12: "fp_matmul_cios_kernel split=<S>"):
    "<registers> registers, <stores>/<loads> spill bytes"}."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN4hb32(\d+)(\w+)'", ln)
        if m:                                 # rows 7 and 12 (namespace hb32)
            spills = "spills not reported"
            kern, rest = m.group(2)[:int(m.group(1))], m.group(2)
            split = re.match(r"ILi(\d+)E", rest[len(kern):])
            name = (f"{kern} split={split.group(1)}"
                    if kern == "fp_matmul_cios_kernel" and split else
                    kern if kern == "mul_add_packed4_kernel" else None)
            continue
        m = re.search(r"Compiling entry function '_ZN2hb(\d+)(\w+)'", ln)
        if m:                                 # hb::<name><MB>: mangled
            spills = "spills not reported"
            kern, rest = m.group(2)[:int(m.group(1))], m.group(2)
            mb = re.match(r"ILi(\d)E", rest[len(kern):])
            f37 = re.search(r"Fold37ILi(\d)ELb(\d)E", rest)
            r73 = re.search(r"Redc73ILb(\d)E", rest)
            if kern == "mxu_fused2_kernel" and f37:
                name = f"{kern} rounds={f37.group(1)} pair={f37.group(2)}"
                continue
            if kern == "mxu_fused_kernel" and r73:
                name = f"{kern} pair={r73.group(1)}"
                continue
            name = f"{kern} lanes={64 * int(mb.group(1))}" if mb and kern in (
                "band_matmul_kernel", "open_direct_kernel",
                "open_fused_k1_kernel", "open_fused_k2_kernel",
                K3_KERNEL, "randousha_check_kernel",
                "randousha_extract_pc_kernel", "randousha_deal_kernel",
                "randousha_extract_kernel") \
                else (kern if kern == "rand_limbs_kernel" else None)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spills = f"{m.group(1)}/{m.group(2)} spill bytes"
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name] = f"{m.group(1)} registers, {spills}"
            name = None
    return out


def kernels_line(times, err, launches, launches_triples, launches_robust,
                 launches_programs, launches_ntl, launches_pc,
                 launches_runtime, launches_apps, launches_fused,
                 int_mm_ms):
    """The rows of the `kernels` JSON line, one per kernel: its source, the
    TPU kernel it replaces, launches on its path, times and bound."""
    meta = {
        "open_direct": ("honeybadgermpc_tpu_torch/csrc/open_direct.cu",
                        "honeybadgermpc_tpu/ops/fused_open_direct.py:202",
                        f"n={N} k={K} B={SEG}"),
        "rand_limbs": ("honeybadgermpc_tpu_torch/csrc/rand_limbs.cu",
                       "honeybadgermpc_tpu/ops/pallas_field.py:452",
                       f"numel={SEG * T}"),
        "band_matmul": ("honeybadgermpc_tpu_torch/csrc/band_matmul.cu",
                        "honeybadgermpc_tpu/ops/band_matmul.py:76",
                        f"B={SEG} k={K} m={N}"),
        "randousha_deal": (
            "honeybadgermpc_tpu_torch/csrc/randousha_deal.cu",
            "honeybadgermpc_tpu/ops/fused_randousha.py:293",
            f"n={N} degree t={T} (k={K}) sp={KT}"),
        "randousha_extract": (
            "honeybadgermpc_tpu_torch/csrc/randousha_extract.cu",
            "honeybadgermpc_tpu/ops/fused_randousha.py:367",
            f"n={N} n_out={N_OUT} (+1 check column) sp={KT}"),
        "mul_add_packed4": (
            "honeybadgermpc_tpu_torch/csrc/packed_arith.cu",
            "honeybadgermpc_tpu/ops/pallas_field.py:244",
            f"[{PL},{N},{N_OUTP},{KT}]"),
        "sub_bcast_packed4": (
            "honeybadgermpc_tpu_torch/csrc/packed_arith.cu",
            "honeybadgermpc_tpu/ops/pallas_field.py:308",
            f"[{PL},{N_OUTP},{KT}] - [{PL},{N},{N_OUTP},{KT}]"),
        "mont_mul": (
            "honeybadgermpc_tpu_torch/csrc/mont_mul.cu",
            "honeybadgermpc_tpu/ops/pallas_field.py:127",
            f"[{L},2048,{N + 1}] (a Gao EEA step)"),
        "fp_matmul_cios": (
            "honeybadgermpc_tpu_torch/csrc/fp_matmul_cios.cu",
            "honeybadgermpc_tpu/ops/pallas_field.py:529",
            f"B={N} k={K} n={N - K + 1}"),
        "mxu_fused2": (
            "honeybadgermpc_tpu_torch/csrc/mxu_fused2.cu",
            "honeybadgermpc_tpu/ops/mxu_matmul.py:453",
            f"B={N * C} k={K} n={N - K + 1}"),
        "mxu_fused": (
            "honeybadgermpc_tpu_torch/csrc/mxu_fused.cu",
            "honeybadgermpc_tpu/ops/mxu_matmul.py:224",
            f"B={CODING_B} k=512 n=4"),
        "mxu_redc": (
            "honeybadgermpc_tpu_torch/csrc/mxu_redc.cu",
            "honeybadgermpc_tpu/ops/mxu_matmul.py:547",
            f"M=2048*{N} (B=2048 k={N} n={N})"),
        "open_fused_k1": (
            "honeybadgermpc_tpu_torch/csrc/open_fused.cu",
            "honeybadgermpc_tpu/ops/fused_open.py:419",
            f"n={N} k={K} C={C_T}"),
        "open_fused_k2": (
            "honeybadgermpc_tpu_torch/csrc/open_fused.cu",
            "honeybadgermpc_tpu/ops/fused_open.py:442",
            f"n={N} k={K} C={C_T}"),
        "open_fused_k3": (
            "honeybadgermpc_tpu_torch/csrc/open_fused.cu",
            "honeybadgermpc_tpu/ops/fused_open.py:470",
            f"n={N} k={K} C={C_T} (one decode)"),
        "mul_add_packed": (
            "honeybadgermpc_tpu_torch/csrc/packed_arith.cu",
            "honeybadgermpc_tpu/ops/pallas_field.py:194",
            f"[{PL},{N * N_OUT * KT}]"),
        "randousha_extract_pc": (
            "honeybadgermpc_tpu_torch/csrc/randousha_extract.cu",
            "honeybadgermpc_tpu/ops/fused_randousha.py:367",
            f"n={N} (all {N} columns) ncheckp={NCHECKP} sp={KT}, degree t"),
        "randousha_check": (
            "honeybadgermpc_tpu_torch/csrc/open_fused.cu",
            "honeybadgermpc_tpu/ops/fused_randousha.py:432",
            f"n={N} k={K} ncheckp={NCHECKP} sp={KT}"),
        "sub_bcast_packed": (
            "honeybadgermpc_tpu_torch/csrc/packed_arith.cu",
            "honeybadgermpc_tpu/ops/pallas_field.py:347",
            f"[{PL},{N_OUT * KT}] - [{PL},{N},{N_OUT * KT}]"),
    }
    # extra shapes timed beside a kernel's main one
    extra = {"randousha_deal": ("randousha_deal_2t", f"k={2 * T + 1}"),
             "mont_mul": ("mont_mul_folded_band", f"[{L},{2 * T},{N}]"),
             "mxu_fused2": (f"mxu_fused2_n{N}", f"B={N * C} k={K} n={N}"),
             "randousha_extract_pc": ("randousha_extract_pc_2t",
                                      "degree 2t"),
             "randousha_check": (f"randousha_check_k{2 * T + 1}",
                                 f"k={2 * T + 1}")}
    for s in (1, 2, 3):
        extra[f"open_fused_k{s}"] = (f"open_fused_k{s}_k{2 * T + 1}",
                                     f"k={2 * T + 1} C={C_2T}")
    extra_streamed = {"mxu_fused2": ("mxu_fused2_streamed",
                                     f"B={CODING_B} k=438 n=4 (k-streamed)")}
    robust_path = ("mont_mul", "fp_matmul_cios", "mxu_fused2", "mxu_redc")
    program_path = ("open_fused_k1", "open_fused_k2", "open_fused_k3",
                    "mul_add_packed", "sub_bcast_packed")
    per_column_path = ("randousha_extract_pc", "randousha_check")
    kernels = []
    for name, (source, replaces, shape) in meta.items():
        ms, plain_ms, (bound_ms, bound_by) = times[name]
        # launches: from the run of the path the kernel belongs to (the
        # open path for the first three, the triple call for the next four,
        # the robust open for the last four); the open kernel serves all
        if name == "mxu_fused":      # the NTL path (phase 17) reaches it
            count = launches_ntl[name]
        elif name in per_column_path:
            count = launches_pc[name]
        elif name in program_path:
            count = launches_programs[name]
        elif name in robust_path:
            count = launches_robust[name]
        elif launches[name] > 0:
            count = launches[name]
        else:
            count = launches_triples[name]
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": count,
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": shape, "share_of_bound": bound_ms / ms,
            "launches_runtime": launches_runtime[name],
            "launches_apps": launches_apps[name],
            "launches_fused": launches_fused[name]}
        if name == "randousha_deal":
            row["launches_per_column_call"] = launches_pc[name]
        if name in ("open_direct", "mont_mul"):
            row["launches_triple_call"] = launches_triples[name]
            row["launches_programs"] = launches_programs[name]
        if name == "open_direct":
            row["launches_robust_open"] = launches_robust[name]
            ms2, plain2, (bound2, by2) = times["open_direct_faulty"]
            row["faulty_segment"] = {
                "ms": ms2, "plain_ms": plain2, "bound_ms": bound2,
                "bound_by": by2,
                "shape": f"n={N} k={K} B={SEG}, {T} faulty parties"}
            # the large-k route: the same function, another kernel
            ms3, plain3, (bound3, by3) = times["open_direct_mma"]
            n_l, t_l = LARGE_K
            row["large_k_route"] = {
                "name": "open_direct_mma", "route": "cuda",
                "source": source, "replaces": replaces,
                "launches": launches["open_direct_mma"],
                "max_abs_err": err["open_direct_mma"], "ms": ms3,
                "plain_ms": plain3, "bound_ms": bound3, "bound_by": by3,
                "library_ms": None,
                "shape": f"n={n_l} k={t_l + 1} B={(t_l + 1) * 64} "
                         f"(k > 81: field_core.cuh's mma.sync core)"}
        if name == "mxu_redc":      # its dot, outside the kernel
            row["dot_int_mm_ms"] = int_mm_ms
        if name in robust_path:
            row["launches_ntl"] = launches_ntl[name]
        if name in extra_streamed:
            key, shape3 = extra_streamed[name]
            ms3, plain3, (bound3, by3) = times[key]
            row["streamed_shape"] = {"ms": ms3, "plain_ms": plain3,
                                     "bound_ms": bound3, "bound_by": by3,
                                     "shape": shape3}
        if name == "rand_limbs":
            row["elements_per_wave"] = fk.rand_wave()
        if name in ("band_matmul", "open_direct", "open_fused_k1",
                    "open_fused_k2", "open_fused_k3", "randousha_check",
                    "randousha_extract_pc", "randousha_deal",
                    "randousha_extract", "mxu_fused2", "mxu_fused"):
            row["core"] = "honeybadgermpc_tpu_torch/csrc/band_gemm.cuh"
        if name == "band_matmul":
            row["eager_shapes"] = []
            for k in EAGER_BAND_K:
                ms2, plain2, (bound2, by2) = times[f"band_matmul_eager_k{k}"]
                row["eager_shapes"].append({
                    "ms": ms2, "plain_ms": plain2, "bound_ms": bound2,
                    "bound_by": by2, "shape": f"B={N * KT} k={k} m={N}"})
        if name in extra:
            key, shape2 = extra[name]
            ms2, plain2, (bound2, by2) = times[key]
            row["second_shape"] = {"ms": ms2, "plain_ms": plain2,
                                   "bound_ms": bound2, "bound_by": by2,
                                   "shape": shape2}
        kernels.append(row)
    return kernels


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nseg", type=int, default=64,
                    help="segments of 16896 sharings held on the card")
    ap.add_argument("--reps", type=int, default=10,
                    help="timed repeats of opening every segment, and "
                         "timed triple calls")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on "
                         "the GPU only")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    say("device", kind=kind, count=torch.cuda.device_count(), card=card,
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.lib()
    _build.native()
    say("build", ok=True, seconds=round(time.perf_counter() - t0, 3),
        nvcc_seconds=_build.build_seconds,
        native_seconds=_build.native_build_seconds,
        ptxas=[ln.strip() for ln in _build.build_log().splitlines()
               if "registers" in ln],
        ptxas_band_core=ptxas_core(_build.build_log()))

    err, times = phase_kernels(dev)
    launches, rates = phase_main(dev, args.nseg, args.reps)
    say("timing", card=card, **rates)
    torch.cuda.empty_cache()

    err2, times2 = phase_kernels_offline(dev)
    err.update(err2)
    times.update(times2)
    # phase 13 runs here: late in a long process the profiler's trace drops
    # launches, and K1-K3 are timed from it
    err4, times4 = phase_kernels_programs(dev)
    err.update(err4)
    times.update(times4)
    torch.cuda.empty_cache()
    launches_triples, trip = phase_triples(dev, args.reps)
    say("triple_timing", card=card, **trip)
    torch.cuda.empty_cache()
    # phases 18-19 run here, beside the other fused-pipeline phases: late in
    # a long process the profiler's trace drops launches
    err6, times6 = phase_kernels_per_column(dev)
    err.update(err6)
    times.update(times6)
    launches_pc, pc_rates = phase_per_column(dev, args.reps)
    say("per_column_timing", card=card, **pc_rates)
    torch.cuda.empty_cache()

    err3, times3, int_mm_ms = phase_kernels_robust(dev)
    err.update(err3)
    times.update(times3)
    launches_robust, robust = phase_robust_open(dev)
    say("robust_timing", card=card, **robust)
    torch.cuda.empty_cache()

    launches_programs, programs = phase_programs(dev, args.reps)
    say("program_timing", card=card, **programs)
    phase_program_fault(dev)
    torch.cuda.empty_cache()

    err5, times5 = phase_kernels_coding(dev)
    err.update(err5)
    times.update(times5)
    torch.cuda.empty_cache()
    launches_ntl, ntl_rates = phase_ntl(dev)
    say("ntl_timing", card=card, **ntl_rates)
    torch.cuda.empty_cache()

    launches_rt, rt_timing = phase_runtime(dev, min(args.reps, RT_REPS))
    launches_models, models_timing = phase_models(dev)
    say("runtime_timing", card=card, **rt_timing, **models_timing)
    launches_runtime = {k: launches_rt[k] + launches_models[k]
                        for k in launches_rt}
    launches_apps, apps_timing = phase_apps(dev, trip["triples_per_s"])
    say("apps_timing", card=card, **apps_timing)
    launches_fused, fused_timing = phase_fused(dev)
    say("fused_timing", card=card, **fused_timing)

    kernels = kernels_line(times, err, launches, launches_triples,
                           launches_robust, launches_programs, launches_ntl,
                           launches_pc, launches_runtime, launches_apps,
                           launches_fused,
                           int_mm_ms)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
