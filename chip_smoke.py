#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (fhe_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the port's main path -- the batched, bootstrapped STD128 GINX gate
-- through its public entry points on the first CUDA device, once through
each of the three accumulators (`ntt_impl` None, "mega", "fused"):

1. device: card name and power limit, torch, nvcc, triton;
2. build: compiles every kernel from fhe_tpu_torch/csrc/ (nvcc, sm_90a);
3. kernels against their plain PyTorch versions on the card, byte-equal:
   the NTT kernels at every N of csrc/ntt_shapes.h (2^3 to 2^8 the
   small-N kernels of csrc/ntt_small.cu: [ntt-small]) with 1, 3 and
   P x SMs + 1 rows (P rows a block: the last block has masked rows), a
   prime below 2^30 (lazy butterflies) and one in (2^30, 2^31) (canonical),
   natural and bit-reversed output and the round trip (at N = 2^16 the
   split kernels: two 2^15 halves after the first stage); the limb-stacked
   ones at N = 2^14 with 1, 3, 11 and 64 limbs, at N = 2^15 with 1, 3, 8,
   58 and 64 and at N = 2^16 with 1, 3, 58 and 64; N = 4, N = 2^17, the
   first N not built, and 65 limbs refused with a ValueError; the
   blind rotations at batch 1, 8 and an odd
   4097, which the wrappers run two ciphertexts to a block with one masked
   lane;
4. main path, once per accumulator: STD128 keygen (once), AND and XOR on
   4096 independent random bit pairs, one single-gate AND, CMUX at batch
   4096 and the batch API's ASYNC AND, decrypted against the truth tables,
   with the kernels' launch counters reset just before each accumulator's
   run and read just after; the three accumulators' outputs must be
   identical;
5. [acc], the DM/AP and LMKCDEY accumulators (PyTorch ops around kernels 1
   and 2): STD128_AP with method AP and STD128_LMKCDEY, each keyed from
   SEED, AND and NAND on 4096 independent random bit pairs, a single-gate
   AND and CMUX at batch 4096 (batch 1024 for a method whose batch-4096
   gate takes over 5 s), decrypted against the truth tables (0 wrong, but
   for LMKCDEY's own failures: `check_gate`), with the
   launch counters reset before and read after each method's run: kernels
   3-5 launch 0 times and kernels 1-2 exactly as often as the DM steps, or
   the LMKCDEY schedule's branches, need; kernels 1-2 byte-equal to their
   plain versions at every shape these gates launch them at; gates/s,
   single-gate latency and the share of the gate in kernels 1-2; TOY with
   method AP and TOY_LMKCDEY on the card byte-identical to the CPU, and an
   N = 2048 set (STD256Q_LMKCDEY) at batch 64;
6. [rns], GINX on the 2-limb RNS ring (the sets with Q >= 2^31: PyTorch ops
   around the limb-stacked NTT kernels): STD192 keyed at full width, AND,
   NAND, XOR and CMUX on 4096 independent random bit pairs, a single-gate
   AND and the batch API's ASYNC AND against the truth tables (0 wrong),
   with the launch counters reset before and read after: n + 1 launches
   of each limb-stacked kernel a gate and none of kernels 1-5; the
   limb-stacked kernels byte-equal to their plain versions at every shape
   these gates launch them at, and timed there; gates/s, single-gate
   latency and the kernels' share of the gate; one AND at batch 64 on each
   of the other eight RNS sets (0 wrong, launches counted, kernels checked
   at their shapes), and on STD128Q_3/_4 the mod switch Q -> q_ks on the
   card against Python integers;
7. [func], functional bootstrapping and public-key mode on the main path's
   STD128 key (no second keygen for the first): once per accumulator, on
   4096 ciphertexts unless named, eval_func of random m in Z_4 with an
   arbitrary LUT (2 bootstraps at ct_mod 2q = 2N), a negacyclic one (1 at
   q) and a periodic one (2 at q), eval_floor at 2q and eval_sign at 2q
   (its last bootstrap at ct_mod q/2), a single eval_func and the batch
   API's ASYNC eval_func: 0 wrong against their plaintext models; then the
   noise-limited calls, eval_floor at 8q (p = 8), eval_sign at 16q (5
   bootstraps) and at 8q on 64, eval_decomp at 4q = q^2/(2 beta), whose
   wrong outputs are counted and which must equal the plain pipeline (the
   plain rotation on the card) byte for byte, the floor's wrong outputs
   lying where its middle phase leaves [q/4, 3q/4); the launch counters
   reset before and read after each accumulator's run (per bootstrap one
   launch of kernel 3 or 4, or n of kernel 5, and one each of kernels 1
   and 2; no other); the three accumulators' outputs must be identical;
   kernels 3-5 byte-equal to their plain versions at every LWE modulus the
   phase rotates at (2N, N, N/2); EvalFunc and EvalSign ciphertexts/s at
   batch 4096 and the single EvalFunc's latency per accumulator, and the
   rotation kernels timed at ct_mod 2N beside q; then key_gen_pair, a
   bootstrap key on its secret keys, encrypt_pk of 4096 random bits
   (decrypted under the dimension-N key, and with the ksk switch to
   (n, q)) and an AND of the switched ciphertexts with secret-key ones,
   against the truth table;
8. [radix], the encrypted integers (tfhe/shortint.py, radix.py, fhevm.py)
   at TOY_RADIX's full width (N = q = 8192, n = 64, dG2 = 10), keyed by
   `FheContext.create("TOY_RADIX", rng=SEED)` on the card, where kernels
   3-5 run the wide step (csrc/cggi_step_wide.cuh): the three kernels
   byte-equal to their plain versions at batch 1, 8 and SMs + 1, q_lwe = q
   and 2q; euint8 add, sub, mul, lt, eq, and, xor, not, select, min, shl
   by 3, neg, is_zero, add_scalar and cast to euint16 on 256 random pairs,
   div and rem on 16 (one by zero), the fhEVM token transfer (ok = ge(from,
   amt), from' = select(ok, sub(from, amt), from), to' = select(ok,
   add(to, amt), to)) on 64 euint64 accounts, a single euint8 add and sub,
   public_key_gen and encrypt_public of 64 euint8 added to secret-key
   ones: 0 wrong against Python integers, with the launch counters reset
   before and read after each op (per bootstrap one launch of the wide
   kernel 3, or 4, or n of the wide kernel 5, and one of each NTT kernel;
   no other); the euint8 add and lt identical through all three
   `ntt_impl`; euint8 add/sub/mul/lt per second at 256, euint64 transfers
   per second at 64, the single ops' latency, one apply_lut over 4096 limb
   ciphertexts as bootstraps/s, and the wide kernels at [4096, 2, 8192] x
   64 steps beside their bound and the key's L2 traffic (80 MiB a
   ciphertext), their plain versions at batch 64;
9. [ckks], CKKS with HYBRID key switching (pke/ckks.py, pke/rlwe.py:
   PyTorch int64 ops around the limb-stacked NTT kernels) at bench.py's
   config 3 (N = 2^14, Q 8 limbs, P 3, dnum = 3), keyed from SEED on the
   card: keygen, relin_key_gen, prepare_evk, rotation keys for r = 1 and 5
   and the conjugation key, encrypt of N/2 slots drawn normal x 0.5; one
   mul_rescale(ct, ct) with the launch counters reset before and read
   after (the limb-stacked kernels only, launches printed by shape),
   decrypted within 1e-2 of z^2 (bench.py:256); mul + relinearize +
   rescale byte-equal to it; rotate by 1 and 5, conjugate (of a complex
   z + i z2) and mul_plain + rescale within fhe_tpu's tests/test_ckks.py
   bound (1e-3 at N = 256) times N / 256, the growth of a fresh
   ciphertext's slot error, add of two ciphertexts within the sum of their
   own errors; the same seed through the port on the CPU gives the same
   mul_rescale, rotate, conjugate, add and mul_plain ciphertexts byte for
   byte; every row of a batch-32 mul_rescale byte-equal to the single
   mul_rescale of its ciphertext and decrypted within 1e-2 of its z_i^2;
   mul_rescale timed at batch 1 and 32 (CUDA events), split by a
   torch.profiler trace into kernels 1-2, the other kernels (the int64
   glue) and the time no kernel runs; kernels 1-2 at every shape it
   launches them at byte-equal to their plain versions, their device time
   from the trace beside their bound;
10. [bfv], BFV (pke/bfv.py: PyTorch int64 ops around the limb-stacked NTT
   kernels, 7 launches a relinearized product) at bench.py's config 4 (N =
   2^15, Q 3 limbs, P 1, R 5, dnum = 3, t = 65537), keyed from SEED on the
   card: one mul(ct, ct, evk) (HPS, HYBRID key) of m in [0, 100) with the
   launch counters reset before and read after (the limb-stacked kernels
   only, launches printed by shape), decrypted to m^2 mod t exactly, and
   the BEHZ product too; the packed encoding's kernels at [1, N] with q = t;
   add, mul_plain, rotate by 1 with a HYBRID and with a BV key and
   dot_product over 4 ciphertexts exact against numpy; the same seed
   through the port on the CPU gives the same HPS and BEHZ ciphertexts;
   mul timed at batch 1 (CUDA events, median of 11; BEHZ too) and split by
   a torch.profiler trace, beside the C++ reference's 3.021 ms on an M1
   Max CPU (BASELINE.md:24, not a target); kernels 1-2 at its shapes
   byte-equal to their plain versions, beside their bound;
11. [bgv], BGV (pke/bgv.py) at N = 2^15, t = 65537, Q 4 limbs, dnum = 3:
   mul + relinearize (launches counted), mod_reduce twice, add of a fresh
   ciphertext and the twice-reduced product (4 and 2 limbs, two pt_scale),
   rotate by 1 and mul_plain after a mod_reduce, each exact against numpy
   and byte-equal to the CPU port from the same seed; mul + relinearize
   timed and split as [bfv]'s;
12. [mp], multiparty threshold CKKS/BGV (pke/multiparty.py) at bench.py's
   config 5 (N = 2^12, Q 4 limbs, P 2, dnum = 2, scale 2^29, 5 parties;
   its seeds): multiparty_keygen and the encryption of z, decrypted by the
   protocol form (decrypt_lead, 4 decrypt_main, fuse) and by
   threshold_decrypt_pipeline (launches counted), each within bench.py's
   5 MP_SD sqrt(5N) / scale; the pipeline byte-equal to the fusion of the
   shares on the same flood deviates, whose sample standard deviation must
   be within 2 % of 2^20; a joint relinearization key and a joint rotation
   key from all 5 parties, mul + relinearize + rescale and rotate under
   them decrypted by the pipeline (within the flood's bound) and at flood
   0 (within [ckks]'s z^2 and rotate bounds); IntBoot and IntMPBoot (2
   parties, N = 2^12, 7 limbs, scale 2^26) within fhe_tpu's test bound x
   N/256; a BGV 5-party threshold decrypt on the [bgv] ring, exact; the
   shares and the fusion at flood 0 byte-equal to the CPU port's from the
   same seed; the pipeline timed at batch 1 and split by a torch.profiler
   trace, beside the C++ reference's ~50 ms on an EPYC 7763 core
   (BASELINE.md:14, not a target); kernels 1-2 at every shape the phase
   launched them at byte-equal to their plain versions, beside their
   bound;
13. [adv], advanced SHE (pke/advanced.py, math/approx.py) at bench config
   3: eval_sum over all 8192 slots (13 rotations) and eval_logistic on
   [-5, 5] at degree 16 (launches counted; byte-equal to the CPU port's
   from the same seed), eval_inner_product, eval_linear_wsum of 4,
   eval_merge of 4, eval_linear_transform with a banded 8192 x 8192 matrix
   (diagonals 0, +1, -1: 2 rotation keys) and compress to one tower, each
   decrypted within fhe_tpu's test bound x N/256; eval_logistic and
   eval_inner_product timed (CUDA events, median of 5) and split by a
   trace; kernels 1-2 at every shape byte-equal and beside their bound;
14. [pre], proxy re-encryption (pke/pre.py): CKKS at bench config 3, a
   HYBRID key, re_encrypt re-randomized under Bob's public key (launches
   counted), Bob's decryption within fhe_tpu's 1e-2 x N/256, Alice's key
   no longer decrypting, byte-equal to the CPU port's; BGV on the [bgv]
   ring with a HYBRID and a BV (14-bit digits) key, exact; re_encrypt
   timed and split; kernels 1-2 at every shape byte-equal;
15. [boot], CKKS bootstrapping (pke/bootstrap.py) at a 128-bit full-slot
   set: N = 2^16, all 32,768 slots, Q 46 limbs at composite degree 2
   (scale 2^52, level blocks tracking the scales), P 12, dnum = 4,
   `stdparams.validate` at 128-bit classic; a dense ternary secret with a
   weight-64 SPARSE_ENCAPSULATED helper, r = 3, level budget (3, 3): setup,
   keygen (host clock) and the card's peak memory; a level-0 ciphertext of
   uniform(-0.4, 0.4) bootstrapped with the launch counters reset before
   and read after (the limb-stacked kernels only), decrypted within
   fhe_tpu's 1e-3, its levels, and one mul_rescale of it against z^2;
   one warm eval_bootstrap timed (CUDA events) under a torch.profiler
   trace that splits it, with the share of it spent encoding plaintexts
   on the host; kernels 1-2 at every shape it
   launches them at byte-equal to their plain versions, beside their
   bound; then at N = 2^11 with the same chain shape, from one seed on the
   CPU (in a child process started after the build, beside the card's
   phases) and on the card, byte-equal: the encapsulated budget-(3, 3)
   bootstrap, the sparse one (128 slots) and the iterative one (8 bits;
   its gain over the first at least 4x);
16. [fbt], CKKS functional bootstrapping (pke/fbt.py) on [boot]'s set,
   dense secret and keys, keyed for the rotations [boot] lacks: the sparse
   FBT of 2048 digits in Z_4 (1024 slots, d = 32; setup's K widened, see
   FBT_RANGE_H) at an r computed from the depth, the schemelet's exact
   product card against CPU at N = 2^16, multi-value bootstrapping of x^2
   and 3x + 1 from one precompute (cold) and eval_fbt of 3x + 2 (warm:
   launches counted, timed with CUDA events under a profiler trace, the
   host-encode share), each 0 wrong of 2048; kernels 1-2 at its shapes not
   checked above, and the single-modulus kernels at N = 2^16, against
   their plain versions; at N = 2^11 ([boot]'s small ring and CPU child)
   the dense FBT (2048 digits), the sparse one at d = 8 and the
   multiprecision sign (p_in 16, p_digit 4), card against CPU byte for
   byte and 0 wrong;
17. [ss], CKKS <-> FHEW scheme switching (pke/schemeswitch.py), in a
   process of its own on the card started beside [boot] and [fbt] (its
   output printed after them), with the main path's STD128 context, secret
   and key made again from SEED (their digest checked against the main
   path's): at bench config 3,
   eval_ckks_to_fhew of 8192 slots to STD128's (n, q) (its extraction
   exact; the switch's wrong outputs within the Poisson bound of its own
   noise, whose std must match the parameters'), and the compare of 8192
   strictly unequal pairs at p = 8 (EvalSign from q_ks = 16 q: every wrong
   sign past a margin of EvalSign's ladder, the first 128 wrong rows and
   the first 64 byte-equal through the plain rotation, the whole EvalSign through
   kernel 4 equal to kernel 3's); eval_fhew_to_ckks of [main]'s 4096 AND
   outputs at N = 2^14 on a chain as deep as STD128's sine (SS_F2C_CONFIG:
   rounding exactly, each slot within FHEW_CKKS_TOL of the sine of its
   input's exact phase); each timed (CUDA events) with its host-encode share
   and its launches counted; min over 4 with its argmin, max over 2,
   compare and the _alt forms at N = 2^11 with TOY_RADIX (the wide
   kernels), within fhe_tpu's test bounds; kernels 1-2 at the phase's new
   shapes against their plain versions;
18. [td], the RLWE trapdoor (lattice/trapdoor.py) at N = 1024, q = STD128's
   Q, base 2 (k = 27): trapdoor_gen, then gauss_samp and
   gauss_samp_corrected on 4 syndromes each, every preimage verified on
   the card, a changed one refused; kernels 1-2's launches a sampler call;
   the card byte-equal to the CPU port from the same seed; the corrected
   preimages' max |x| and std against fhe_tpu's bounds in s;
19. [arb], the Bluestein and arbitrary-cyclotomic transforms
   (math/ntt_arb.py) at fhe_tpu's test lengths m = 7, 12, 15, 24 (the
   small-N kernels, L = 32 to 128) against a naive DFT and a schoolbook
   product mod (Phi_m, q), and at the prime m = 1733 (L = 2^13,
   limb-stacked) the round trips and the product against the exact
   convolution mod (Phi_m, q); the card byte-equal to the CPU;
20. [thr], threshold decryption (tfhe/threshold.py) of [main]'s 4096 AND
   outputs: additive 3-of-3 with proofs (each verified, a tampered partial
   refused), Shamir 2-of-3 on 4096 extended outputs under the key's ring
   secret, each subset 0 wrong; every share, partial, proof and combine
   byte-equal to the CPU port's on the ciphertexts copied to the host;
21. [zkp], an 8-bit ripple-carry adder of STD128 gates at batch 1 recorded
   by a WitnessBuilder (tfhe/zkp.py): the sum right, the witness verified, a
   tampered gate and a wrong root refused, every sampled gate replayed on
   the card to its committed bytes; [radix] adds get_proof /
   verify_proof of its euint64 balances against the CPU port's;
22. [pack], STD128's bootstrap and switching keys packed and unpacked
   (tfhe/packed.py): a batch-4096 AND through the unpacked key identical to
   the AND through the key, the LWE batch round trip in both layouts; then
   the small-N kernels timed at [arb]'s shapes (cold L2) beside their bound;
23. [ser], serialization (utils/serial.py, serial_ref.py, serial_ref_pke.py)
   on fhe_tpu's wire format: [main]'s 4096 AND outputs and its LWE secret
   through dumps / loads (binary and JSON) onto the card, equal, each
   archive byte-identical to the CPU port's (the secret made again from
   SEED on the CPU); tests/vectors/pke_*.bin byte for byte through
   dump_binary(load_binary(...)); the reference's serial_lwe_ct{0,1}
   archives loaded onto the card and decrypted to the manifest's bits; an
   euint8 ciphertext of a TOY_RADIX context keyed on the card through
   FheContext.serialize_ciphertext and back, byte-identical to the CPU
   port's archive, 0 wrong;
24. [srv], the port's HTTP server (server.py) in a thread on 127.0.0.1, an
   ephemeral port, its contexts on the card: /health (the card), /context
   STD128, /keygen from a seed, /encrypt of 2 x 4096 random bits,
   /v1/eval/and, /gate XOR, /not and /decrypt of each: 0 wrong, one launch
   of kernel 3 a gate request (counters reset before and read after each),
   every returned archive byte-identical to the port's BinFheContext called
   directly from the same seeds; each request's wall time and the gate's
   device time (CUDA events, utils/profiling);
25. [capi], the lux_fhe_* / ckks_* C API (native/capi.cpp, built with g++
   and loaded with ctypes into this process, which it joins; where g++ or
   this interpreter's Python.h is missing a printed line says so and the
   phase does not run): lux_fhe_has_gpu 1; on STD128 keygen, encrypt,
   AND, OR, XOR, NOT, MUX and bootstrap at batch 1 on every input pair
   (kernel 3 once a gate), the marshal / unmarshal round trip, the
   threshold keygen and decrypt; ckks_context_new(14, 208, 2^26) with a
   keypair from a seed (capi_impl.ckks_keygen: the ABI's keygen takes
   none): encrypt, add, mult and rotate of 8192 slots within 1e-3 x N/256
   of numpy, each ciphertext's archive byte-identical to the CPU port's
   from the same seed, kernels 1-2 at
   its new shapes against their plain versions and timed; the C client
   (native/client.cpp) encrypting 4096 bit pairs under the ABI's secret,
   the ABI's AND on the card, the C client decrypting: 0 wrong;
26. timings with CUDA events: gates/s at batch 4096 and single-gate latency
   per accumulator, and each kernel against its plain version at the main
   path's shapes, beside its bound (the least time the card could take);
   the NTT kernels, and their plain versions, with a cold L2 (each call
   after writing a 256 MB buffer, so that it reads its input from device
   memory: `profile_ntt.time_cold_ms`), also at the single gate's shapes;
   the blind-rotation kernels' resident blocks per SM at batch 4096.

The build lines give each kernel's registers and spills (`-Xptxas -v`); a
spill in any NTT kernel, or in a blind-rotation kernel at STD128's shape,
fails the run (the wide kernels' spills are reported only).

It exits non-zero, and prints no result, when there is no CUDA device or
any phase fails.  Its last three lines are a JSON object of the kernels,
the card's `nvidia-smi` name and power limit, then
{"ok": true, "device": {...}}.  Keys and inputs are made from SEED.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
BATCH = 4096
IMPLS = (None, "mega", "fused")
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "ntt_forward": ("fhe_tpu_torch/csrc/ntt.cuh", "fhe_tpu/math/ntt_pallas.py:64"),
    "ntt_inverse": ("fhe_tpu_torch/csrc/ntt.cuh", "fhe_tpu/math/ntt_pallas.py:79"),
    "blind_rotate": ("fhe_tpu_torch/csrc/blind_rotate.cuh", "fhe_tpu/tfhe/boot_mxu.py:230"),
    "blind_rotate_mega": ("fhe_tpu_torch/csrc/blind_rotate.cuh",
                          "fhe_tpu/tfhe/boot_pallas.py:235"),
    "rotate_step_br": ("fhe_tpu_torch/csrc/blind_rotate.cuh",
                       "fhe_tpu/tfhe/boot_pallas.py:153"),
    "ntt_forward_limbs": ("fhe_tpu_torch/csrc/ntt.cuh", "fhe_tpu/math/ntt_pallas.py:64"),
    "ntt_inverse_limbs": ("fhe_tpu_torch/csrc/ntt.cuh", "fhe_tpu/math/ntt_pallas.py:79"),
    "blind_rotate_wide": ("fhe_tpu_torch/csrc/blind_rotate.cuh", "fhe_tpu/tfhe/boot_mxu.py:230"),
    "blind_rotate_mega_wide": ("fhe_tpu_torch/csrc/blind_rotate.cuh",
                               "fhe_tpu/tfhe/boot_pallas.py:235"),
    "rotate_step_br_wide": ("fhe_tpu_torch/csrc/blind_rotate.cuh",
                            "fhe_tpu/tfhe/boot_pallas.py:153"),
    "ntt_forward_small": ("fhe_tpu_torch/csrc/ntt_small.cu", "fhe_tpu/math/ntt_pallas.py:64"),
    "ntt_inverse_small": ("fhe_tpu_torch/csrc/ntt_small.cu", "fhe_tpu/math/ntt_pallas.py:79"),
}
# kernels 1-2 over stacked limbs: the RNS path's only kernels, on no other path
LIMB_KERNELS = ("ntt_forward_limbs", "ntt_inverse_limbs")
# kernels 1-2 at N = 2^3..2^8 (csrc/ntt_small.cu): the trapdoor's and the
# Bluestein transforms' small rings, on no gate's path
SMALL_KERNELS = ("ntt_forward_small", "ntt_inverse_small")
# the accumulator kernel each ntt_impl runs, and its launches per gate
ACC_KERNEL = {None: "blind_rotate", "mega": "blind_rotate_mega", "fused": "rotate_step_br"}
# the same at a ring of N >= kernels.blind_rotate.wide_n(): the wide step
WIDE_KERNEL = {None: "blind_rotate_wide", "mega": "blind_rotate_mega_wide",
               "fused": "rotate_step_br_wide"}
# the [acc] phase: (set, method) at full width; the batch for a method whose
# batch-4096 gate takes longer than SLOW_GATE_MS
ACC_SETS = (("STD128_AP", "AP"), ("STD128_LMKCDEY", None))
ACC_SMALL_BATCH = 1024
SLOW_GATE_MS = 5000.0
# LMKCDEY's own decryption failures: the rate a gate's input phase, as the
# accumulator sees it, is past the q/8 margin (about 1e-4 on bootstrapped
# inputs at STD128_LMKCDEY: PERF.md §6), and the chance of a fault-free
# run having more such outputs than check_gate allows
LMK_PAST_RATE = 1e-4
LMK_PAST_TAIL = 1e-3
# the [rns] phase: the set at full width and batch BATCH, and the other RNS
# sets at RNS_SMALL_BATCH; on FAULTY_SWITCH a 64-bit product v q_ks wraps
RNS_SET = "STD192"
RNS_OTHERS = ("STD192_3", "STD192_4", "STD192Q", "STD192Q_3", "STD192Q_4", "STD128Q_3",
              "STD128Q_4", "TOY_RNS")
RNS_SMALL_BATCH = 64
FAULTY_SWITCH = ("STD128Q_3", "STD128Q_4")
# the [func] phase: f: Z_4 -> Z_4 of each LUT kind (f(m + 2) = -f(m), f(m + 2)
# = f(m), neither; (m^2 + 1) mod 4 is periodic), and the number of eval_sign
# inputs at 8q
FUNC_LUTS = {"arbitrary": lambda m, p: (m + 1) % p, "negacyclic": lambda m, p: m ** 3 % p,
             "periodic": lambda m, p: (m * m + 1) % p}
SIGN_8Q_BATCH = 64
# the [radix] phase: the set at full width, the euint8 pairs, the divisions'
# pairs, the euint64 accounts, and the plain rotations' batch
RADIX_SET = "TOY_RADIX"
RADIX_PAIRS = 256
RADIX_DIV_PAIRS = 16
RADIX_ACCOUNTS = 64
RADIX_PLAIN_BATCH = 64
# the [ckks] phase: bench.py's config 3 (N = 2^14, 8 limbs of Q, 3 of P),
# the rotations keyed besides r = 1, and the batch of its second metric
CKKS_CONFIG = dict(N=1 << 14, num_levels=7, scale_bits=26, dnum=3)
CKKS_ROTS = (1, 5)
CKKS_BATCH = 32
# the [bfv] phase: bench.py's config 4 (N = 2^15, Q 3 limbs, dnum = 3: P 1,
# R 5), and the C++ reference's BFVrns MultRelin on an M1 Max CPU
# (BASELINE.md:24), printed beside the port's mul, not a target; the [bgv]
# phase's ring (N = 2^15, Q 4 limbs, dnum = 3: P 2)
BFV_CONFIG = dict(N=1 << 15, num_limbs=3, plain_mod=65537, mod_bits=28, dnum=3)
BFV_REFERENCE_CPU_MS = 3.021
BGV_CONFIG = dict(N=1 << 15, num_levels=3, plain_mod=65537, mod_bits=28, dnum=3)
# the [mp] phase: bench.py's config 5 (N = 2^12, Q 4 limbs, P 2, dnum = 2,
# scale 2^29, 5 parties; bench.py:312-345), the C++ reference's 3-of-5
# combine on an EPYC 7763 core (BASELINE.md:14), printed beside the
# pipeline, not a target; the interactive bootstraps' ring
# (tests/test_multiparty.py:139,160 at N = 2^12)
MP_CONFIG = dict(N=1 << 12, num_levels=3, scale_bits=29, dnum=2)
MP_PARTIES = 5
MP_REFERENCE_CPU_MS = 50.0
MP_BOOT_CONFIG = dict(N=1 << 12, num_levels=6, scale_bits=26, dnum=2)
# the [adv] phase (bench config 3, CKKS_CONFIG): EvalLogistic's interval
# and degree (tests/test_advanced_ext.py:84), the degree lowered only if
# it needs more levels than the chain has
ADV_LOGISTIC = (-5.0, 5.0, 16)
# the [boot] phase: the 128-bit full-slot bootstrapping set (N = 2^16, Q 46
# limbs at composite degree 2, P 12, dnum = 4; its level blocks tracking
# the FLEXIBLEAUTO scales: pke/params.py track_scale), a dense secret with
# a SPARSE_ENCAPSULATED helper of weight BOOT_H, r = 3 double angles, level
# budget (3, 3); fhe_tpu's bound for this mode (tests/test_bootstrap.py:102);
# the card-against-CPU ring (the same chain shape at N = 2^11) and the
# sparse bootstrap's slots there (d = N / (2 slots) = 8, fhe_tpu's test's:
# setup's sine range K = 36 sqrt(d) holds up to d = 8; at 8 slots, d = 128,
# the partial sum's d I leaves it and the bootstrap decrypts wrong, in
# fhe_tpu's composition too: ROADMAP queue 3); the CPU child's threads and
# how long a phase waits for it
BOOT_CONFIG = dict(N=1 << 16, num_levels=22, scale_bits=52, composite_degree=2, first_bits=60,
                   dnum=4, track_scale=True)
BOOT_H = 64
BOOT_R = 3
BOOT_BUDGET = (3, 3)
BOOT_TOL = 1e-3
BOOT_SMALL_N = 1 << 11
BOOT_SPARSE_SLOTS = 128
BOOT_CPU_THREADS = 4
BOOT_CPU_WAIT_S = 900
# the [fbt] phase: [boot]'s set, secret and keys; the sparse FBT's slots at
# N = 2^16 (2048 digits, d = 32); the weight whose K (setup's sparse rule,
# ((h + 1)/2 + 4) sqrt(d) = 385) covers d |I| for the weight-BOOT_H helper's
# overflow integers up to |I| = 12 (at BOOT_H's own K = 204 a coefficient
# fails from |I| = 7, probability ~0.005 each: ROADMAP queue 3); the LUTs'
# plaintext modulus and the exponential series' largest degree (one
# host-encoded plaintext a coefficient); the sparse FBT's d at N = 2^11
# (BOOT_SPARSE_SLOTS' d, where setup's K holds); the LUTs, f: Z_4 -> Z_4
FBT_SLOTS = 1024
FBT_RANGE_H = 128
FBT_P = 4
FBT_MAX_DEG = 128
BOOT_SPARSE_D = 8
FBT_LUTS = {"(3x + 2) mod 4": lambda x: (3 * x + 2) % 4, "x^2 mod 4": lambda x: (x * x) % 4,
            "(3x + 1) mod 4": lambda x: (3 * x + 1) % 4}
# the [ss] phase: the FHEW -> CKKS chain's shape at N = 2^14 (its depth is
# computed from STD128's sine): at bench config 3's 2^26 scale the
# rescale's floor division (DropLastElementAndScale) leaves the lowest-
# frequency slots off by ~N^1.5 |s(zeta)| / (2 pi scale) a rescale, ~0.016
# at slot 0, which FHEW -> CKKS's sine amplifies past its 0.3 bound
# (ROADMAP queue 3), so the chain is the bootstrapping set's shape: 2^52
# at composite degree 2;
# the min/max ring (tests/test_schemeswitch.py's chain at N = 2^11)
SS_F2C_CONFIG = dict(N=1 << 14, scale_bits=52, composite_degree=2, first_bits=60, dnum=3,
                     track_scale=True)
# FHEW -> CKKS against sin(2 pi phi / q) of each input: the sine fit's 1e-7,
# times ~4 a double angle (3 of them) and the 2 pi post-scale, is 4e-5
FHEW_CKKS_TOL = 1e-3
SS_SMALL_N = 1 << 11
# the [td] phase: STD128's ring (N = 1024, Q = 134215681 = 1 mod 2048, the
# main path's RGSW key's), base 2 (k = 27), fhe_tpu's sigma; syndromes a
# sampler; the [arb] phase: fhe_tpu's test lengths (tests/test_arbntt.py,
# padded convolutions of L = 32 to 128: the small-N kernels) and a prime
# index whose convolution pads to 2^13 (1733 + 3465 - 2 = 5196); [zkp]'s
# adder width
TD_CONFIG = dict(N=1024, q=134215681, base=2, sigma=3.19)
TD_SYNDROMES = 4
ARB_MS = (7, 12, 15, 24)
ARB_BIG_M = 1733
ZKP_BITS = 8
# the [srv] phase's key seed (its bits and encryptions: the next three);
# the [capi] phase's ckks_* context (log N, log Q, scale: bench config 3's
# ring and scale, 7 levels at the ABI's dnum = 2), its keypair's seed and
# its decryption bound (PERF.md §2: fhe_tpu's 1e-3 at N = 256, times N / 256)
SRV_SEED = SEED + 30
# the reference's archives that [ser] reads, beside this script
VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "vectors")
CAPI_CKKS = (14, 208, float(1 << 26))
CAPI_CKKS_SEED = SEED + 47
CAPI_CKKS_TOL = 1e-3 * (1 << 14) / 256
HBM_BYTES_PER_S = 3.35e12       # NVIDIA H100 SXM data sheet
IMUL_PER_CLOCK_PER_SM = 64      # CUDA C++ Programming Guide throughput table, cc 9.0


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def device_report(card: str) -> None:
    from fhe_tpu_torch.kernels import _build
    print(f"[device] {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} {torch.cuda.get_device_name(0)}")
    nv = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True,
                        check=True, timeout=60)
    print(f"[device] nvcc: {nv.stdout.strip().splitlines()[-1]}")
    spec = importlib.util.find_spec("triton")
    print(f"[device] triton importable: {spec is not None}")


def kernel_reports(log: str) -> list[tuple[str, int, int]]:
    """(kernel, registers, spill-store bytes) per compiled kernel in the
    ptxas report, named by their template arguments: blind rotations
    (log2 N, dG2, C[, natural]), NTTs (log2 N, lazy[, out_br])."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            args = ", ".join(re.findall(r"L[ib](\d+)E", mangled))
            kind = ("wide_scan_kernel" if "wide_scan_kernel" in mangled else
                    "wide_step_kernel" if "wide_step_kernel" in mangled else
                    "scan_kernel" if "scan_kernel" in mangled else
                    "step_kernel" if "step_kernel" in mangled else
                    "ntt_forward_limbs_kernel" if "forward_limbs_kernel" in mangled else
                    "ntt_inverse_limbs_kernel" if "inverse_limbs_kernel" in mangled else
                    "ntt_forward_half_kernel" if "forward_half_kernel" in mangled else
                    "ntt_inverse_half_kernel" if "inverse_half_kernel" in mangled else
                    "ntt_inverse_stage_kernel" if "inverse_stage_kernel" in mangled else
                    "ntt_forward_small_kernel" if "forward_small_kernel" in mangled else
                    "ntt_inverse_small_kernel" if "inverse_small_kernel" in mangled else
                    "ntt_forward_kernel" if "forward_kernel" in mangled else
                    "ntt_inverse_kernel")
            name, spill = f"{kind}<{args}>" if args else kind, 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def build() -> None:
    from fhe_tpu_torch.kernels import _build
    lib = _build.library()
    print(f"[build] {'built' if lib.built else 'loaded cached'} {lib.path.name} "
          f"in {lib.seconds:.2f} s ({len(_build.units())} units, one nvcc each)")
    reports = kernel_reports(lib.log)
    for name, regs, spill in reports:
        print(f"[build] {name}: {regs} registers, {spill} bytes spill stores")
    spilled = [name for name, _, spill in reports if name.startswith(
        ("scan_kernel<10, 4,", "step_kernel<10, 4,", "ntt_")) and spill]
    if lib.built and spilled:
        fail(f"NTT kernels or kernels at STD128's shape spill: {spilled}")


class Errors:
    """Largest |kernel - plain| seen per kernel in this run."""

    def __init__(self):
        self.max = {name: 0 for name in KERNELS}

    def compare(self, name: str, got: torch.Tensor, want: torch.Tensor, what: str,
                show: bool = True) -> None:
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{what}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
        self.max[name] = max(self.max[name], err)
        if show:
            print(f"[kernels] {what}: max |kernel - plain| = {err}")
        if err != 0:
            fail(f"{what}: kernel disagrees with its plain version")


def _residues(rng, high, shape, dev):
    return torch.from_numpy(rng.integers(0, high, size=shape)).to(dev, torch.int32)


def check_limb_kernels_wide(dev, errors: Errors, N: int, limb_counts: tuple) -> None:
    """The limb-stacked kernels at N (one row a block) with each count of
    limbs, rows 1, 3 and SMs + 1."""
    from fhe_tpu_torch.kernels import ntt as kntt
    from fhe_tpu_torch.lattice import rns
    from fhe_tpu_torch.math import primes
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)      # on the card: fast at 64 limbs
    rows_all = (1, 3, kntt.rows_per_block(N) * torch.cuda.get_device_properties(
        dev).multi_processor_count + 1)
    for L in limb_counts:
        plan = rns.make_rns_plan(N, primes.ntt_primes(L, N, 1 << 30), dev)
        for rows in rows_all:
            x = (torch.randint(0, 1 << 62, (rows, L, N), generator=gen, device=dev) %
                 plan.q).to(torch.int32)
            f = rns.ntt_forward(plan, x)
            at = f"[{rows}, {L}, {N}]"
            errors.compare("ntt_forward_limbs", f, rns.forward_plain(plan, x),
                           f"ntt_forward_limbs {at}", show=False)
            i = rns.ntt_inverse(plan, f)
            errors.compare("ntt_inverse_limbs", i, rns.inverse_plain(plan, f),
                           f"ntt_inverse_limbs {at}", show=False)
            errors.compare("ntt_inverse_limbs", i, x, f"limb round trip {at}", show=False)
        print(f"[kernels] limb-stacked ntt N={N} with {L} limbs, rows {rows_all}: forward, "
              f"inverse, round trip byte-equal to the plain versions")


def check_ntt_kernels(dev, errors: Errors) -> None:
    """Kernels 1 and 2 at every instantiated N, rows 1, 3 and P x SMs + 1,
    q on both sides of 2^30; the first N not built (2 x the largest)
    refused before any launch."""
    from fhe_tpu_torch import kernels
    from fhe_tpu_torch.kernels import ntt as kntt
    from fhe_tpu_torch.math import ntt, primes
    rng = np.random.default_rng(SEED + 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for N in kntt.sizes():
        rows_all = (1, 3, kntt.rows_per_block(N) * sms + 1)
        small = N in kntt.small_sizes()
        fwd, inv = ("ntt_forward_small", "ntt_inverse_small") if small else (
            "ntt_forward", "ntt_inverse")
        for q in (primes.last_prime(27, 2 * N), primes.last_prime(31, 2 * N)):
            plan = ntt.make_plan(N, q, dev)
            for rows in rows_all:
                at = f"[{rows}, {N}] q={q}"
                x = _residues(rng, q, (rows, N), dev)
                f = ntt.ntt_forward(plan, x)
                errors.compare(fwd, f, ntt.forward_butterfly(plan, x), f"{fwd} {at}", show=False)
                errors.compare(fwd, ntt.ntt_forward(plan, x, out_br=True),
                               ntt.forward_butterfly(plan, x, out_br=True),
                               f"{fwd} out_br {at}", show=False)
                i = ntt.ntt_inverse(plan, f)
                errors.compare(inv, i, ntt.inverse_butterfly(plan, f), f"{inv} {at}", show=False)
                errors.compare(inv, i, x, f"ntt round trip {at}", show=False)
            arith = ("canonical (the small-N kernels)" if small else
                     "lazy" if q < kntt.LAZY_Q else "canonical")
            print(f"[kernels]{' [ntt-small]' if small else ''} ntt N={N} q={q} ({arith}), rows "
                  f"{rows_all}: forward, forward out_br, inverse, round trip byte-equal to the "
                  f"plain versions")
    before = kernels.launch_counts()
    for what, call in (("make_plan", lambda: ntt.make_plan(4, 17, dev)),
                       ("check_n", lambda: kntt.check_n(4))):
        try:
            call()
        except ValueError as e:
            print(f"[kernels] [ntt-small] N=4 {what}: ValueError: {e}")
        else:
            fail(f"N = 4 was not refused by {what}")
    if kernels.launch_counts() != before:
        fail("N = 4 launched a kernel")
    # CKKS bench config 3's Q u P (11 limbs), BFV bench config 4's Q u R (8),
    # the bootstrapping set's Q u P (58) and kMaxLimbs
    check_limb_kernels_wide(dev, errors, 1 << 14, (1, 3, 11, kntt.max_limbs()))
    check_limb_kernels_wide(dev, errors, 1 << 15, (1, 3, 8, 58, kntt.max_limbs()))
    check_limb_kernels_wide(dev, errors, 1 << 16, (1, 3, 58, kntt.max_limbs()))
    N = 2 * max(kntt.sizes())
    plan = ntt.make_plan(N, primes.last_prime(27, 2 * N), dev)
    before = kernels.launch_counts()
    for what, fn in (("forward", ntt.ntt_forward), ("inverse", ntt.ntt_inverse)):
        try:
            fn(plan, torch.zeros(1, N, dtype=torch.int32, device=dev))
        except ValueError as e:
            print(f"[kernels] ntt {what} N={N}: ValueError: {e}")
        else:
            fail(f"ntt {what} at N = {N} was not refused")
    if kernels.launch_counts() != before:
        fail(f"ntt at N = {N} launched a kernel")
    from fhe_tpu_torch.lattice import rns
    L = kntt.max_limbs() + 1
    plan = rns.make_rns_plan(1024, primes.ntt_primes(L, 1024, 1 << 30), dev)
    for what, fn in (("forward", rns.ntt_forward), ("inverse", rns.ntt_inverse)):
        try:
            fn(plan, torch.zeros(1, L, 1024, dtype=torch.int32, device=dev))
        except ValueError as e:
            print(f"[kernels] limb-stacked ntt {what} with {L} limbs: ValueError: {e}")
        else:
            fail(f"limb-stacked ntt {what} with {L} limbs was not refused")
    if kernels.launch_counts() != before:
        fail(f"limb-stacked ntt with {L} limbs launched a kernel")


def check_kernels(dev, errors: Errors) -> None:
    from fhe_tpu_torch.tfhe import boot, boot_pallas, make_params, rgsw
    check_ntt_kernels(dev, errors)
    rng = np.random.default_rng(SEED + 1)
    for name, steps, B in [("STD128", 16, 8), ("STD128", 16, 1), ("STD128", 16, 4097),
                           ("TOY", 64, 8)]:
        p = make_params(name)
        acc = _residues(rng, p.Q, (B, 2, p.N), dev)
        bsk = _residues(rng, p.Q, (steps, 2, p.digits_g2, 2, p.N), dev)
        a = _residues(rng, p.q, (B, steps), dev)
        what = f"{name} B={B} steps={steps} random key"
        errors.compare("blind_rotate", boot.blind_rotate(p, rgsw.BootstrapKey(bsk, None), acc, a),
                       boot.blind_rotate_plain(p, bsk, acc, a), f"blind_rotate {what}")
        want = boot_pallas.blind_rotate_mega_plain(p, bsk, acc, a)
        errors.compare("blind_rotate_mega", boot_pallas.blind_rotate_mega(p, bsk, acc, a), want,
                       f"blind_rotate_mega {what}")
        errors.compare("rotate_step_br", boot_pallas.blind_rotate_fused(p, bsk, acc, a), want,
                       f"rotate_step_br x {steps} launches (blind_rotate_fused) {what}")
        errors.compare("rotate_step_br", boot_pallas.rotate_step_br(p, bsk[0], acc, a[:, 0]),
                       boot_pallas.rotate_step_br_plain(p, bsk[0], acc, a[:, 0]),
                       f"rotate_step_br one step {name} B={B}")
    torch.cuda.synchronize()


def run_path(ctx, sk, key, bits, cts, impl):
    """One accumulator's run of the main path; returns its output
    ciphertexts and the launches of each kernel in it."""
    from fhe_tpu_torch import kernels
    from fhe_tpu_torch.parallel import BatchFlags, eval_bin_gate_batch
    m1, m2, sel = bits
    ct1, ct2, cs, one1, one2 = cts
    ctx = dataclasses.replace(ctx, ntt_impl=impl)
    tag = f"[main] ntt_impl={impl}"

    def decrypt_check(what, out, want, shape=(BATCH,)):
        if out.a.shape != shape + (ctx.params.n,) or out.modulus != ctx.params.q:
            fail(f"{what}: output ciphertext shape {tuple(out.a.shape)} mod {out.modulus}")
        got = ctx.decrypt(sk, out).cpu().numpy()
        wrong = int((got != want).sum())
        print(f"{tag} {what}: {wrong} wrong of {got.size} (ones in output: {int(got.sum())})")
        if wrong:
            fail(f"{what} with ntt_impl={impl} does not decrypt to its truth table")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs = {"AND": ctx.eval_bin_gate(key, "AND", ct1, ct2),
            "XOR": ctx.eval_bin_gate(key, "XOR", ct1, ct2),
            "single AND": ctx.eval_bin_gate(key, "AND", one1, one2),
            "CMUX": ctx.eval_cmux(key, ct1, ct2, cs)}
    fut, res = eval_bin_gate_batch(ctx, key, "AND", ct1, ct2, BatchFlags.ASYNC)
    if not res.success or res.processed != BATCH:
        fail(f"eval_bin_gate_batch with ntt_impl={impl}: {res}")
    outs["batch API AND"] = fut.result()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    first_s = time.perf_counter() - t0
    gates = 7                       # AND, XOR, single AND, 3 NANDs of the CMUX, batch API
    print(f"{tag} {gates} gates (first calls) in {first_s:.3f} s; launches: {launches}")
    decrypt_check(f"AND batch {BATCH}", outs["AND"], m1 & m2)
    decrypt_check(f"XOR batch {BATCH}", outs["XOR"], m1 ^ m2)
    decrypt_check("single AND", outs["single AND"], (m1 & m2)[:1], shape=(1,))
    decrypt_check(f"CMUX batch {BATCH}", outs["CMUX"], np.where(sel == 1, m2, m1))
    decrypt_check(f"eval_bin_gate_batch ASYNC AND batch {BATCH}", outs["batch API AND"], m1 & m2)
    per_gate = ctx.params.n if impl == "fused" else 1
    for name in KERNELS:
        want = gates * per_gate if name == ACC_KERNEL[impl] else (
            0 if name in (*ACC_KERNEL.values(), *WIDE_KERNEL.values(), *LIMB_KERNELS,
                          *SMALL_KERNELS) else None)
        if want is None and launches[name] <= 0:
            fail(f"kernel {name} was not launched by the main path with ntt_impl={impl}")
        if want is not None and launches[name] != want:
            fail(f"kernel {name}: {launches[name]} launches with ntt_impl={impl}, "
                 f"expected {want}")
    return outs, launches


def std128_inputs(dev):
    """[main]'s STD128 context, secret, bootstrap key, bits and their
    ciphertexts, from SEED."""
    from fhe_tpu_torch import BinFheContext
    ctx = BinFheContext.generate("STD128", device=dev)
    rng = np.random.default_rng(SEED)
    sk = ctx.key_gen(rng)
    key = ctx.bt_key_gen(sk, rng)
    bits = tuple(rng.integers(0, 2, size=BATCH) for _ in range(3))
    cts = tuple(ctx.encrypt(sk, m, rng) for m in bits)
    cts += (ctx.encrypt(sk, bits[0][:1], rng), ctx.encrypt(sk, bits[1][:1], rng))
    return ctx, sk, key, bits, cts


def digest(*tensors) -> str:
    """SHA-256 of the tensors' bytes (the [ss] process checks that it holds
    the main path's key and AND outputs)."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def main_path(dev):
    """STD128 keygen, then each accumulator's run; the outputs must agree."""
    t0 = time.perf_counter()
    ctx, sk, key, bits, cts = std128_inputs(dev)
    torch.cuda.synchronize()
    print(f"[main] STD128 keygen (sk, ksk {tuple(key.ksk.a.shape)}, bsk "
          f"{tuple(key.bsk.shape)}) and the inputs' encryption on {dev}: "
          f"{time.perf_counter() - t0:.3f} s")
    launches, first = {}, None
    for impl in IMPLS:
        outs, launches[impl] = run_path(ctx, sk, key, bits, cts, impl)
        if first is None:
            first = outs
            continue
        for what, out in outs.items():
            if not (torch.equal(out.a, first[what].a) and torch.equal(out.b, first[what].b)):
                fail(f"{what}: ntt_impl={impl} output differs from ntt_impl=None")
        print(f"[main] ntt_impl={impl}: all {len(outs)} outputs identical to ntt_impl=None")
    print(f"[main] peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    path_launches = {name: launches[None][name] for name in ("ntt_forward", "ntt_inverse")}
    path_launches.update({name: launches[impl][name] for impl, name in ACC_KERNEL.items()})
    return ctx, sk, key, cts, first["AND"], path_launches, digest(
        key.bsk, key.ksk.a, key.ksk.b, first["AND"].a, first["AND"].b)


def comb_mask(ct1, ct2) -> np.ndarray:
    """The mask a two-input gate other than XOR blind-rotates by: ct1 + ct2."""
    return ((ct1.a.to(torch.int64) + ct2.a) % ct1.modulus).cpu().numpy()


def gate_ntt_launches(p, key, a: np.ndarray) -> collections.Counter:
    """(kernel, rows) -> launches of kernels 1 and 2 in one DM or LMKCDEY
    gate on the combined mask a [B, n]: the test vector's forward and
    extract_lwe's inverse, and per DM step, or per LMKCDEY automorphism or
    external-product branch the schedule runs, one inverse (of [B, N] or
    [B, 2, N]) and one forward (of the [B, dGa, N] or [B, dG2, N] digits)."""
    from fhe_tpu_torch.tfhe import acc
    B = a.shape[0]
    out = collections.Counter({("ntt_forward", B): 1, ("ntt_inverse", 2 * B): 1})
    if isinstance(key, acc.DmKey):
        auto, ext = 0, p.n * p.digits_r
    else:
        kinds, p1, _, _ = acc.lmk_schedule(p, a)
        auto, ext = (int(run.sum()) for run in acc.lmk_branches(kinds, p1))
    out[("ntt_inverse", B)] += auto
    out[("ntt_forward", B * (p.digits_g - 1))] += auto
    out[("ntt_inverse", 2 * B)] += ext
    out[("ntt_forward", B * p.digits_g2)] += ext
    return out


def input_margin(p, sk, ct1, ct2, bits1, bits2) -> np.ndarray:
    """Per element, |e| / (q/8): the phase error of a gate's input sum
    ct1 + ct2 against bits1 + bits2, with the mask the accumulator rotates
    by: LMKCDEY rounds each exponent (q - a_i) up to odd (rgsw-acc-lmkcdey.cpp
    EvalAcc; with a Gaussian secret this adds sum_i s_i over about n/2
    coefficients), GINX and AP take a as it is.  A gate can decrypt wrong
    only where this is >= 1."""
    from fhe_tpu_torch.tfhe import Method
    q = p.q
    a = (ct1.a.to(torch.int64) + ct2.a) % q
    if p.method == Method.LMKCDEY:
        a = (q - (((q - a) % q) | 1)) % q                   # q = 2N
    b = (ct1.b.to(torch.int64) + ct2.b) % q
    phase = (b - (a * sk.s.to(a.device, torch.int64)).sum(-1)) % q
    nominal = torch.from_numpy((bits1 + bits2) * (q // 4)).to(phase.device)
    err = (phase - nominal + q // 2) % q - q // 2
    return err.abs().cpu().numpy() / (q / 8)


def poisson_limit(mean: float, tail: float) -> int:
    """The least k with P(X > k) < tail for X ~ Poisson(mean)."""
    k, term = 0, math.exp(-mean)
    cdf = term
    while 1 - cdf >= tail:
        k += 1
        term *= mean / k
        cdf += term
    return k


def check_gate(what: str, ctx, sk, out, truth, ct1, ct2, bits1, bits2) -> np.ndarray:
    """A gate's output against its truth table: 0 wrong for GINX and AP.
    An LMKCDEY output may be wrong only where its input phase, as the
    accumulator sees it, is past the q/8 margin (`input_margin`): the
    reference's own decryption failure (fhe_tpu gives the same ciphertext:
    tests/test_torch_acc.py::test_std128_lmkcdey_cmux_failure_is_the_reference_s).
    Such inputs may number at most `poisson_limit` of LMK_PAST_RATE a gate.
    Returns where the inputs are past."""
    from fhe_tpu_torch.tfhe import Method
    p = ctx.params
    if out.a.shape != truth.shape + (p.n,) or out.modulus != p.q:
        fail(f"{what}: output ciphertext shape {tuple(out.a.shape)} mod {out.modulus}")
    got = ctx.decrypt(sk, out).cpu().numpy()
    margin = input_margin(p, sk, ct1, ct2, bits1, bits2)
    wrong = got != truth
    past = margin >= 1
    print(f"{what}: {int(wrong.sum())} wrong of {got.size} (ones in output: {int(got.sum())}); "
          f"{int(past.sum())} inputs past the q/8 margin (largest {margin.max():.3f} q/8)"
          + (f", at {np.nonzero(past)[0][:8].tolist()}" if past.any() else ""))
    if p.method != Method.LMKCDEY:
        past = np.zeros_like(past)
    if (wrong & ~past).any():
        fail(f"{what} does not decrypt to its truth table"
             + (" inside the noise margin" if p.method == Method.LMKCDEY else ""))
    limit = poisson_limit(LMK_PAST_RATE * got.size, LMK_PAST_TAIL)
    if past.sum() > limit:
        fail(f"{what}: {int(past.sum())} inputs past the q/8 margin, more than the {limit} "
             f"that a rate of {LMK_PAST_RATE} a gate allows")
    return past


def check_acc_launches(what: str, launches: dict, expected: collections.Counter) -> None:
    """Kernels 3-5 and the limb-stacked kernels not launched; kernels 1-2
    exactly as often as expected."""
    for name in (*ACC_KERNEL.values(), *WIDE_KERNEL.values(), *LIMB_KERNELS, *SMALL_KERNELS):
        if launches[name]:
            fail(f"{what}: kernel {name} launched {launches[name]} times")
    for name in ("ntt_forward", "ntt_inverse"):
        want = sum(n for (kernel, _), n in expected.items() if kernel == name)
        if launches[name] != want:
            fail(f"{what}: {launches[name]} {name} launches, expected {want}")
    print(f"[acc] {what}: launches {launches}, as expected")


def path_ntts(tag: str, dev, p, per_gate: collections.Counter, errors: Errors,
              card: str | None = None) -> tuple[float, int, dict]:
    """Kernels 1 and 2 (on a 2-limb RNS set, the limb-stacked ones) at every
    (kernel, rows) shape a DM, LMKCDEY or RNS gate launches them at,
    byte-equal to their plain versions on random residues.  With card, each
    is also timed (10 launches back to back), beside its plain version's
    time and its bound; returns (kernel ms, launches) a gate, 0.0 ms
    untimed, and (kernel, rows) -> (ms, plain ms, bound ms, bound by)."""
    from fhe_tpu_torch.lattice import rns
    from fhe_tpu_torch.math import ntt
    gen = np.random.default_rng(SEED + 4)
    if p.moduli_rns:
        plan = rns.make_rns_plan(p.N, p.moduli_rns, dev)
        ops = {"ntt_forward_limbs": (rns.ntt_forward, rns.forward_plain),
               "ntt_inverse_limbs": (rns.ntt_inverse, rns.inverse_plain)}
        make = lambda rows: torch.stack([_residues(gen, q, (rows, p.N), dev)
                                         for q in p.moduli_rns], dim=1)
        limbs, logN = plan.L, plan.plans[0].logN
    else:
        plan = ntt.make_plan(p.N, p.Q, dev)
        ops = {"ntt_forward": (ntt.ntt_forward, ntt.forward_butterfly),
               "ntt_inverse": (ntt.ntt_inverse, ntt.inverse_butterfly)}
        make = lambda rows: _residues(gen, p.Q, (rows, p.N), dev)
        limbs, logN = 1, plan.logN
    kern_ms, kern_launches, timed = 0.0, 0, {}
    for (kernel, rows), n in sorted(per_gate.items()):
        if not n:
            continue
        x = make(rows)
        fn, plain = ops[kernel]
        shape = list(x.shape)
        errors.compare(kernel, fn(plan, x), plain(plan, x), f"{tag} {kernel} {shape}")
        kern_launches += n
        if card is None:
            continue
        ms = time_ms(lambda: [fn(plan, x) for _ in range(10)], reps=3) / 10
        p_ms = time_ms(lambda: plain(plan, x), reps=3)
        butterflies = p.N // 2 * logN
        muls = 3 * (butterflies + (p.N if "inverse" in kernel else 0)) * rows * limbs
        b_ms, b_by = bound(_nbytes(x, x, plan.fwd_w, plan.fwd_ws), muls, int_multiply_peak(dev))
        print(f"{tag} {kernel} {shape}: {ms:.4f} ms a launch (10 back to back), "
              f"plain {p_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}, at {b_ms / ms:.3f} of it; "
              f"{n} launches a gate  ({card})")
        kern_ms += n * ms
        timed[(kernel, rows)] = (ms, p_ms, b_ms, b_by)
    return kern_ms, kern_launches, timed


def acc_method(dev, name: str, method, errors: Errors, card: str) -> None:
    """One accumulator's [acc] run at full width: keygen, the counted gates
    against their truth tables, kernels 1-2 against their plain versions at
    the gate's shapes, then gates/s, single-gate latency and the share of
    kernels 1-2."""
    from fhe_tpu_torch import BinFheContext, kernels
    from fhe_tpu_torch.tfhe import Gate, acc, boot, lwe
    t0 = time.perf_counter()
    ctx = BinFheContext.generate(name, method=method, device=dev)
    p = ctx.params
    tag = f"[acc] {name} ({p.method.value})"
    rng = np.random.default_rng(SEED)
    sk = ctx.key_gen(rng)
    key = ctx.bt_key_gen(sk, rng)
    torch.cuda.synchronize()
    shapes = {k: tuple(v.shape) for k, v in vars(key).items() if isinstance(v, torch.Tensor)}
    print(f"{tag} keygen (ksk {tuple(key.ksk.a.shape)}, {shapes}) on {dev}: "
          f"{time.perf_counter() - t0:.3f} s (host clock)")
    m1, m2, sel = (rng.integers(0, 2, size=BATCH) for _ in range(3))
    ct1, ct2, cs = (ctx.encrypt(sk, m, rng) for m in (m1, m2, sel))
    one1, one2 = ctx.encrypt(sk, m1[:1], rng), ctx.encrypt(sk, m2[:1], rng)

    batch = BATCH
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    and_ms, and_out = timed_once(lambda: ctx.eval_bin_gate(key, Gate.AND, ct1, ct2))
    if and_ms > SLOW_GATE_MS:
        batch = ACC_SMALL_BATCH
        print(f"{tag}: AND at batch {BATCH} took {and_ms:.3f} ms, over {SLOW_GATE_MS:.0f} ms: "
              f"batch {batch} from here, counted from the start")
        m1, m2, sel = m1[:batch], m2[:batch], sel[:batch]
        ct1, ct2, cs = (dataclasses.replace(c, a=c.a[:batch], b=c.b[:batch])
                        for c in (ct1, ct2, cs))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        and_out = ctx.eval_bin_gate(key, Gate.AND, ct1, ct2)
    outs = {f"AND batch {batch}": and_out,
            f"NAND batch {batch}": ctx.eval_bin_gate(key, Gate.NAND, ct1, ct2),
            "single AND": ctx.eval_bin_gate(key, Gate.AND, one1, one2),
            f"CMUX batch {batch}": ctx.eval_cmux(key, ct1, ct2, cs)}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    # the CMUX's three NANDs: (ct1, NOT sel), (ct2, sel), then the two
    # outputs; the first two are made again, after the counted run, for
    # the inputs of the third
    ncs = ctx.eval_not(cs)
    nand1 = ctx.eval_bin_gate(key, Gate.NAND, ct1, ncs)
    nand2 = ctx.eval_bin_gate(key, Gate.NAND, ct2, cs)
    d1, d2 = (ctx.decrypt(sk, c).cpu().numpy() for c in (nand1, nand2))
    cmux = outs[f"CMUX batch {batch}"]
    past = [check_gate(f"{tag} {what}", ctx, sk, out, truth, *inputs)
            for what, out, inputs, truth in [
                (f"AND batch {batch}", outs[f"AND batch {batch}"], (ct1, ct2, m1, m2), m1 & m2),
                (f"NAND batch {batch}", outs[f"NAND batch {batch}"], (ct1, ct2, m1, m2),
                 1 - (m1 & m2)),
                ("single AND", outs["single AND"], (one1, one2, m1[:1], m2[:1]), (m1 & m2)[:1]),
                ("CMUX's NAND(ct1, NOT sel)", nand1, (ct1, ncs, m1, 1 - sel),
                 1 - (m1 & (1 - sel))),
                ("CMUX's NAND(ct2, sel)", nand2, (ct2, cs, m2, sel), 1 - (m2 & sel)),
                ("CMUX's NAND of those two", cmux, (nand1, nand2, d1, d2), 1 - (d1 & d2))]]
    wrong = ctx.decrypt(sk, cmux).cpu().numpy() != np.where(sel == 1, m2, m1)
    print(f"{tag} CMUX batch {batch}: {int(wrong.sum())} wrong of {batch} against sel ? m2 : m1"
          + (f", at {np.nonzero(wrong)[0][:8].tolist()}" if wrong.any() else ""))
    if (wrong & ~(past[3] | past[4] | past[5])).any():
        fail(f"{tag} CMUX is wrong where none of its NANDs' inputs is past the margin")
    masks = [comb_mask(ct1, ct2)] * 2 + [comb_mask(one1, one2), comb_mask(ct1, ncs),
                                         comb_mask(ct2, cs), comb_mask(nand1, nand2)]
    per_gate = [gate_ntt_launches(p, key, a) for a in masks]
    check_acc_launches(f"{name} ({p.method.value}), 6 gates", launches,
                       sum(per_gate, collections.Counter()))
    if isinstance(key, acc.LmkcdeyKey):
        t0 = time.perf_counter()
        kinds, _, _, T = acc.lmk_schedule(p, masks[0])
        sched_ms = (time.perf_counter() - t0) * 1e3
        ops, ext = (kinds > 0).sum(axis=1), (kinds == 2).sum(axis=1)
        print(f"{tag} schedule of the AND at batch {batch}: T = {T} slots; per ciphertext "
              f"{ops.min()}-{ops.max()} ops, {ext.min()}-{ext.max()} external products; "
              f"lmk_schedule {sched_ms:.3f} ms on the host (host clock)")

    batch_ms = time_ms(lambda: ctx.eval_bin_gate(key, Gate.AND, ct1, ct2), reps=3)
    single_ms = time_ms(lambda: ctx.eval_bin_gate(key, Gate.AND, one1, one2), reps=5)
    comb = lwe.add(ct1, ct2)
    tv = boot.make_gate_test_vector(p, comb.b, boot.gate_constants(p, Gate.AND))
    rot_ms = time_ms(lambda: boot.run_accumulator(p, key, tv, comb.a), reps=3)
    path_ntts(tag, dev, p, per_gate[2], errors)             # the single gate's shapes
    kern_ms, kern_launches, _ = path_ntts(tag, dev, p, per_gate[0], errors, card)
    print(f"{tag} AND batch {batch}: {batch_ms:.3f} ms = {batch / batch_ms * 1e3:.1f} gates/s  "
          f"({card})")
    print(f"{tag} single-gate AND latency: {single_ms:.3f} ms  ({card})")
    print(f"{tag} AND batch {batch}: accumulator alone {rot_ms:.3f} ms; kernels 1-2 "
          f"{kern_ms:.3f} ms ({kern_launches} launches) = {kern_ms / batch_ms:.3f} of the gate, "
          f"{kern_ms / rot_ms:.3f} of the accumulator; PyTorch glue of the accumulator "
          f"{rot_ms - kern_ms:.3f} ms; rest of the gate {batch_ms - rot_ms:.3f} ms  ({card})")


def acc_card_vs_cpu(dev) -> None:
    """TOY with method AP and TOY_LMKCDEY: keys from one seed, AND on 64
    random bit pairs on the card and on the CPU; the outputs must be
    byte-identical and decrypt to the truth table."""
    from fhe_tpu_torch import BinFheContext
    m1, m2 = np.random.default_rng(SEED + 3).integers(0, 2, size=(2, 64))
    for name, method in (("TOY", "AP"), ("TOY_LMKCDEY", None)):
        outs = []
        for d in (torch.device("cpu"), dev):
            ctx = BinFheContext.generate(name, method=method, device=d)
            rng = np.random.default_rng(SEED)
            sk = ctx.key_gen(rng)
            key = ctx.bt_key_gen(sk, rng)
            out = ctx.eval_bin_gate(key, "AND", ctx.encrypt(sk, m1, rng), ctx.encrypt(sk, m2, rng))
            if not np.array_equal(ctx.decrypt(sk, out).cpu().numpy(), m1 & m2):
                fail(f"{name} ({ctx.params.method.value}) AND on {d} is wrong")
            outs.append(out.to("cpu"))
        if not (torch.equal(outs[0].a, outs[1].a) and torch.equal(outs[0].b, outs[1].b)):
            fail(f"{name} ({ctx.params.method.value}) AND: card output differs from the CPU's")
        print(f"[acc] {name} ({ctx.params.method.value}) AND batch 64: 0 wrong; the card's "
              f"output ciphertexts byte-identical to the CPU's")


def acc_n2048(dev, errors: Errors) -> None:
    """One AND at batch 64 on STD256Q_LMKCDEY (N = 2048, q = 2N): kernels
    1-2 at N = 2048 on the LMKCDEY path, launches counted, and each of its
    shapes against the plain versions."""
    from fhe_tpu_torch import BinFheContext, kernels
    ctx = BinFheContext.generate("STD256Q_LMKCDEY", device=dev)
    rng = np.random.default_rng(SEED)
    sk = ctx.key_gen(rng)
    key = ctx.bt_key_gen(sk, rng)
    m1, m2 = rng.integers(0, 2, size=(2, 64))
    ct1, ct2 = ctx.encrypt(sk, m1, rng), ctx.encrypt(sk, m2, rng)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    ms, out = timed_once(lambda: ctx.eval_bin_gate(key, "AND", ct1, ct2))
    launches = kernels.launch_counts()
    wrong = int((ctx.decrypt(sk, out).cpu().numpy() != (m1 & m2)).sum())
    print(f"[acc] STD256Q_LMKCDEY (N = {ctx.params.N}) AND batch 64: {wrong} wrong, {ms:.3f} ms")
    if wrong:
        fail("STD256Q_LMKCDEY AND does not decrypt to its truth table")
    expected = gate_ntt_launches(ctx.params, key, comb_mask(ct1, ct2))
    check_acc_launches("STD256Q_LMKCDEY, 1 gate", launches, expected)
    path_ntts("[acc] STD256Q_LMKCDEY", dev, ctx.params, expected, errors)


def acc_phase(dev, errors: Errors, card: str) -> None:
    for name, method in ACC_SETS:
        acc_method(dev, name, method, errors, card)
        torch.cuda.empty_cache()
    acc_card_vs_cpu(dev)
    acc_n2048(dev, errors)
    torch.cuda.empty_cache()


def rns_gate_ntts(p, B: int) -> collections.Counter:
    """(kernel, rows) -> launches of the limb-stacked kernels in one RNS gate
    at batch B: the test vector's forward and n digit forwards, n step
    inverses and extraction's inverse."""
    return collections.Counter({("ntt_forward_limbs", B): 1,
                                ("ntt_forward_limbs", B * p.digits_g2): p.n,
                                ("ntt_inverse_limbs", 2 * B): p.n + 1})


def check_rns_launches(what: str, launches: dict, gates: int, p) -> None:
    """n + 1 launches of each limb-stacked kernel a gate, none of the others."""
    for name, count in launches.items():
        want = gates * (p.n + 1) if name in LIMB_KERNELS else 0
        if count != want:
            fail(f"{what}: {count} {name} launches, expected {want}")
    print(f"[rns] {what}: launches {launches}, as expected")


def rns_main(dev, errors: Errors, card: str) -> tuple[dict, dict]:
    """STD192 at full width: keygen, the counted gates against their truth
    tables, the limb-stacked kernels at the gate's shapes against their
    plain versions and timed, gates/s, latency and the kernels' share.
    Returns the counted run's launches and the kernels' times at the
    batch gate's digit forward and step inverse."""
    from fhe_tpu_torch import BinFheContext, kernels
    from fhe_tpu_torch.parallel import BatchFlags, eval_bin_gate_batch
    t0 = time.perf_counter()
    ctx = BinFheContext.generate(RNS_SET, device=dev)
    p = ctx.params
    tag = f"[rns] {RNS_SET}"
    rng = np.random.default_rng(SEED)
    sk = ctx.key_gen(rng)
    key = ctx.bt_key_gen(sk, rng)
    torch.cuda.synchronize()
    print(f"{tag} (N = {p.N}, n = {p.n}, Q = {p.moduli_rns[0]} x {p.moduli_rns[1]}, dG2 = "
          f"{p.digits_g2}) keygen (ksk {tuple(key.ksk.a.shape)}, bsk {tuple(key.bsk.shape)}) on "
          f"{dev}: {time.perf_counter() - t0:.3f} s (host clock)")
    m1, m2, sel = (rng.integers(0, 2, size=BATCH) for _ in range(3))
    ct1, ct2, cs = (ctx.encrypt(sk, m, rng) for m in (m1, m2, sel))
    one1, one2 = ctx.encrypt(sk, m1[:1], rng), ctx.encrypt(sk, m2[:1], rng)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs = {f"AND batch {BATCH}": ctx.eval_bin_gate(key, "AND", ct1, ct2),
            f"NAND batch {BATCH}": ctx.eval_bin_gate(key, "NAND", ct1, ct2),
            f"XOR batch {BATCH}": ctx.eval_bin_gate(key, "XOR", ct1, ct2),
            "single AND": ctx.eval_bin_gate(key, "AND", one1, one2),
            f"CMUX batch {BATCH}": ctx.eval_cmux(key, ct1, ct2, cs)}
    fut, res = eval_bin_gate_batch(ctx, key, "AND", ct1, ct2, BatchFlags.ASYNC)
    if not res.success or res.processed != BATCH:
        fail(f"{RNS_SET} eval_bin_gate_batch: {res}")
    outs[f"batch API ASYNC AND batch {BATCH}"] = fut.result()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"{tag} 8 gates (first calls) in {time.perf_counter() - t0:.3f} s (host clock)")
    truths = [m1 & m2, 1 - (m1 & m2), m1 ^ m2, (m1 & m2)[:1], np.where(sel == 1, m2, m1), m1 & m2]
    for (what, out), truth in zip(outs.items(), truths):
        if out.a.shape != truth.shape + (p.n,) or out.modulus != p.q:
            fail(f"{tag} {what}: output ciphertext shape {tuple(out.a.shape)} mod {out.modulus}")
        wrong = int((ctx.decrypt(sk, out).cpu().numpy() != truth).sum())
        print(f"{tag} {what}: {wrong} wrong of {truth.size}")
        if wrong:
            fail(f"{tag} {what} does not decrypt to its truth table")
    check_rns_launches(f"{RNS_SET}, 8 gates", launches, 8, p)

    batch_ms = time_ms(lambda: ctx.eval_bin_gate(key, "AND", ct1, ct2), reps=3)
    single_ms = time_ms(lambda: ctx.eval_bin_gate(key, "AND", one1, one2), reps=5)
    path_ntts(tag, dev, p, rns_gate_ntts(p, 1), errors)          # the single gate's shapes
    kern_ms, kern_launches, timed = path_ntts(tag, dev, p, rns_gate_ntts(p, BATCH), errors, card)
    print(f"{tag} AND batch {BATCH}: {batch_ms:.3f} ms = {BATCH / batch_ms * 1e3:.1f} gates/s  "
          f"({card})")
    print(f"{tag} single-gate AND latency: {single_ms:.3f} ms  ({card})")
    print(f"{tag} AND batch {BATCH}: limb-stacked kernels {kern_ms:.3f} ms ({kern_launches} "
          f"launches) = {kern_ms / batch_ms:.3f} of the gate; the rest (PyTorch ops, key "
          f"switch) {batch_ms - kern_ms:.3f} ms, {(batch_ms - kern_ms) / p.n:.3f} ms a step  "
          f"({card})")
    main_shapes = {"ntt_forward_limbs": BATCH * p.digits_g2, "ntt_inverse_limbs": 2 * BATCH}
    return launches, {name: timed[(name, rows)] for name, rows in main_shapes.items()}


def check_switch(dev, p) -> None:
    """rgsw_rns.switch_to_qks on the card against Python integers, on the
    edges and 4094 random v in [0, Q); also counts how many a uint64
    product v q_ks, which wraps where Q q_ks passes 2^64, would switch
    wrong."""
    from fhe_tpu_torch.tfhe import rgsw_rns
    gen = np.random.default_rng(SEED + 5)
    v = [0, p.Q // 2, p.Q - 1] + [int(x) for x in gen.integers(0, p.Q, size=4093)]
    got = rgsw_rns.switch_to_qks(p, torch.tensor(v, dtype=torch.int64, device=dev)).tolist()
    want = [(x * p.q_ks + p.Q // 2) // p.Q % p.q_ks for x in v]
    wrong = sum(g != w for g, w in zip(got, want))
    u = np.array(v, dtype=np.uint64)
    with np.errstate(over="ignore"):
        wrapped = ((u * np.uint64(p.q_ks) + np.uint64(p.Q // 2)) // np.uint64(p.Q)
                   % np.uint64(p.q_ks)).tolist()
    print(f"[rns] {p.name} mod switch Q -> q_ks (Q q_ks has {(p.Q * p.q_ks).bit_length()} bits) "
          f"on the card: {wrong} of {len(v)} differ from Python integers; a wrapping uint64 "
          f"product gets {sum(g != w for g, w in zip(wrapped, want))} wrong")
    if wrong:
        fail(f"{p.name}: the mod switch Q -> q_ks is not exact")


def rns_others(dev, errors: Errors) -> None:
    """One AND at batch 64 on each other RNS set: 0 wrong, n + 1 launches of
    each limb-stacked kernel, the kernels byte-equal at the gate's shapes."""
    from fhe_tpu_torch import BinFheContext, kernels
    for name in RNS_OTHERS:
        t0 = time.perf_counter()
        ctx = BinFheContext.generate(name, device=dev)
        p = ctx.params
        rng = np.random.default_rng(SEED)
        sk = ctx.key_gen(rng)
        key = ctx.bt_key_gen(sk, rng)
        m1, m2 = rng.integers(0, 2, size=(2, RNS_SMALL_BATCH))
        ct1, ct2 = ctx.encrypt(sk, m1, rng), ctx.encrypt(sk, m2, rng)
        torch.cuda.synchronize()
        key_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        ms, out = timed_once(lambda: ctx.eval_bin_gate(key, "AND", ct1, ct2))
        launches = kernels.launch_counts()
        wrong = int((ctx.decrypt(sk, out).cpu().numpy() != (m1 & m2)).sum())
        print(f"[rns] {name} (N = {p.N}, n = {p.n}, Q = {p.moduli_rns[0]} x {p.moduli_rns[1]}, "
              f"Bg = 2^{p.base_g.bit_length() - 1}, dG2 = {p.digits_g2}): keygen {key_s:.3f} s; "
              f"AND batch {RNS_SMALL_BATCH}: {wrong} wrong, {ms:.3f} ms")
        if wrong:
            fail(f"{name} AND does not decrypt to its truth table")
        check_rns_launches(f"{name}, 1 gate", launches, 1, p)
        path_ntts(f"[rns] {name}", dev, p, rns_gate_ntts(p, RNS_SMALL_BATCH), errors)
        if name in FAULTY_SWITCH:
            check_switch(dev, p)
        del key
        torch.cuda.empty_cache()


def rns_phase(dev, errors: Errors, card: str) -> tuple[dict, dict]:
    t0 = time.perf_counter()
    launches, times = rns_main(dev, errors, card)
    torch.cuda.empty_cache()
    rns_others(dev, errors)
    print(f"[rns] the phase took {time.perf_counter() - t0:.3f} s (host clock)")
    return launches, times


def decomp_digits(m: np.ndarray, P: int, mod: int, q: int, p: int, beta: int = 128) -> list:
    """A plaintext rendering of eval_decomp's loop on the noise-free phase
    m mod/P: each digit is the phase mod q decrypted at p (set_modulus),
    the floor clears it, and the mod switch scales by 2 beta / q; the last
    is the remainder decrypted at p."""
    v = m.astype(np.int64) * (mod // P)
    digits = []
    while mod > q:
        digits.append(v % q * p // q % p)
        v = v - v % q
        new = mod * 2 * beta // q
        v, mod = v * new // mod, new
    digits.append(v * p // mod % p)
    return digits


def check_func_kernels(dev, p, errors: Errors) -> None:
    """Kernels 3-5 byte-equal to their plain versions with the mask mod
    each LWE modulus the [func] phase rotates at (2N, N, N/2), at STD128's
    shape, batch 1, 8 and 4097, random keys of 16 steps."""
    from fhe_tpu_torch.tfhe import boot, boot_pallas, rgsw
    rng = np.random.default_rng(SEED + 7)
    for q_lwe in (2 * p.N, p.N, p.N // 2):
        for B in (1, 8, 4097):
            acc = _residues(rng, p.Q, (B, 2, p.N), dev)
            bsk = _residues(rng, p.Q, (16, 2, p.digits_g2, 2, p.N), dev)
            a = _residues(rng, q_lwe, (B, 16), dev)
            what = f"STD128 B={B} steps=16 q_lwe={q_lwe} random key"
            errors.compare("blind_rotate",
                           boot.blind_rotate(p, rgsw.BootstrapKey(bsk, None), acc, a, q_lwe),
                           boot.blind_rotate_plain(p, bsk, acc, a, q_lwe), f"blind_rotate {what}")
            want = boot_pallas.blind_rotate_mega_plain(p, bsk, acc, a, q_lwe)
            errors.compare("blind_rotate_mega",
                           boot_pallas.blind_rotate_mega(p, bsk, acc, a, q_lwe), want,
                           f"blind_rotate_mega {what}")
            errors.compare("rotate_step_br", boot_pallas.blind_rotate_fused(p, bsk, acc, a, q_lwe),
                           want, f"rotate_step_br x 16 launches (blind_rotate_fused) {what}")
    torch.cuda.synchronize()


def func_cells(ctx, key, inp: dict) -> list:
    """The [func] phase's calls: (what, call, plaintext model of each output,
    output modulus, decryption p, bootstraps, noise-limited).  A call
    returns one ciphertext or a list (eval_decomp's digits).  Noise-limited
    calls run where STD128's bootstrap noise, scaled to the ciphertext's
    modulus, is comparable to the beta = q/8 margin of EvalFloor's middle
    step (PERF.md §6; ROADMAP.md queue 3): there some outputs are wrong in
    fhe_tpu too, and the card is held to the plain pipeline instead of 0
    wrong."""
    from fhe_tpu_torch.parallel import BatchFlags, eval_func_batch
    q, B = ctx.params.q, BATCH
    luts = {kind: ctx.generate_lut(f, 4) for kind, f in FUNC_LUTS.items()}
    m4, m2, m8, ms, m16 = inp["m4"], inp["m2"], inp["m8"], inp["msign"], inp["m16"]

    def batch_api():
        fut, res = eval_func_batch(ctx, key, inp["ct4"], luts["arbitrary"], BatchFlags.ASYNC)
        if not res.success or res.processed != B:
            fail(f"eval_func_batch with ntt_impl={ctx.ntt_impl}: {res}")
        return fut.result()

    return [
        *[(f"eval_func {kind} batch {B}", lambda lut=lut: ctx.eval_func(key, inp["ct4"], lut),
           [FUNC_LUTS[kind](m4, 4)], q, 4, {"negacyclic": 1}.get(kind, 2), False)
          for kind, lut in luts.items()],
        (f"eval_floor 2q batch {B}", lambda: ctx.eval_floor(key, inp["floor2"]), [m2], 2 * q, 2,
         2, False),
        (f"eval_sign 2q batch {B}", lambda: ctx.eval_sign(key, inp["sign2"]), [ms[:B] >= 4], q, 2,
         3, False),
        ("single eval_func arbitrary", lambda: ctx.eval_func(key, inp["one"], luts["arbitrary"]),
         [FUNC_LUTS["arbitrary"](m4[:1], 4)], q, 4, 2, False),
        (f"eval_func_batch ASYNC arbitrary batch {B}", batch_api,
         [FUNC_LUTS["arbitrary"](m4, 4)], q, 4, 2, False),
        (f"eval_floor 8q batch {B}", lambda: ctx.eval_floor(key, inp["floor8"]), [m8], 8 * q, 8,
         2, True),
        (f"eval_sign 16q batch {B}", lambda: ctx.eval_sign(key, inp["sign16"]), [ms[:B] >= 4], q,
         2, 5, True),
        (f"eval_sign 8q batch {SIGN_8Q_BATCH}", lambda: ctx.eval_sign(key, inp["sign8"]),
         [ms[B:] >= 4], q, 2, 5, True),
        (f"eval_decomp 4q batch {B}", lambda: ctx.eval_decomp(key, inp["decomp"]),
         decomp_digits(m16, 16, 4 * q, q, 4), q, 4, 2, True),
    ]


def func_run(ctx, sk, key, inp: dict, impl) -> tuple[dict, dict]:
    """One accumulator's counted run of the [func] phase: launches per
    bootstrap exact, every output against its plaintext model (0 wrong
    where the call is not noise-limited).  Returns the outputs by name and
    the launches."""
    from fhe_tpu_torch import kernels
    n = ctx.params.n
    ctx = dataclasses.replace(ctx, ntt_impl=impl)
    tag = f"[func] ntt_impl={impl}"
    cells = func_cells(ctx, key, inp)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    results = [call() for _, call, *_ in cells]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    boots = sum(cell[5] for cell in cells)
    print(f"{tag} {boots} bootstraps (first calls) in {time.perf_counter() - t0:.3f} s (host "
          f"clock); launches: {launches}")
    outs = {}
    for (what, _, wants, mod, pt, _, limited), out in zip(cells, results):
        digits = out if isinstance(out, list) else [out]
        if len(digits) != len(wants):
            fail(f"{tag} {what}: {len(digits)} outputs, expected {len(wants)}")
        for i, (ct, want) in enumerate(zip(digits, wants)):
            name = what if len(wants) == 1 else f"{what} digit {i}"
            if ct.a.shape != want.shape + (n,) or ct.modulus != mod:
                fail(f"{tag} {name}: output ciphertext shape {tuple(ct.a.shape)} mod {ct.modulus}")
            wrong = ctx.decrypt(sk, ct, pt).cpu().numpy() != want
            print(f"{tag} {name}: {int(wrong.sum())} wrong of {want.size} (decrypted at p = {pt})"
                  + (f", at {np.nonzero(wrong)[0][:8].tolist()}; noise-limited: held to the plain "
                     f"pipeline" if limited else ""))
            if wrong.any() and not limited:
                fail(f"{tag} {name} does not decrypt to its plaintext model")
            outs[name] = ct
    per_boot = {ACC_KERNEL[impl]: n if impl == "fused" else 1, "ntt_forward": 1, "ntt_inverse": 1}
    for name, count in launches.items():
        if count != boots * per_boot.get(name, 0):
            fail(f"{tag}: {count} {name} launches, expected {boots * per_boot.get(name, 0)}")
    print(f"{tag}: launches as expected ({per_boot} a bootstrap, none of the others)")
    return outs, launches


@contextlib.contextmanager
def plain_rotation():
    """Within the block, the default accumulator rotates with the plain
    PyTorch version on the card instead of kernel 3."""
    from fhe_tpu_torch.tfhe import boot
    kernel = boot.blind_rotate
    boot.blind_rotate = lambda params, key, acc, a, a_modulus=None: boot.blind_rotate_plain(
        params, key.bsk, acc, a, a_modulus)
    try:
        yield
    finally:
        boot.blind_rotate = kernel


def check_noise_limited(ctx, sk, key, inp: dict, outs: dict, card: str) -> None:
    """The noise-limited calls through the plain pipeline (the plain
    rotation in place of kernel 3) must give the kernels' ciphertexts byte
    for byte, so every wrong output is the algorithm's on STD128.  EvalFloor
    at 8q is then taken apart: its middle phase x = (ct + beta - first
    bootstrap) mod q must lie in [q/4, 3q/4), the range its second LUT
    f2(x) = x assumes, and there the output's error is the second
    bootstrap's output noise e3 alone, so an output may be wrong only
    where x leaves that range or |e3| reaches the q/2 decryption margin."""
    from fhe_tpu_torch.tfhe import funcboot
    p = ctx.params
    q, beta = p.q, funcboot.BETA
    t0 = time.perf_counter()
    with plain_rotation():
        for what, call, wants, *_, limited in func_cells(ctx, key, inp):
            if not limited:
                continue
            got = call()
            for i, ct in enumerate(got if isinstance(got, list) else [got]):
                name = what if len(wants) == 1 else f"{what} digit {i}"
                if not (torch.equal(ct.a, outs[name].a) and torch.equal(ct.b, outs[name].b)):
                    fail(f"[func] {name}: the kernels' output differs from the plain pipeline's")
                print(f"[func] {name}: the plain pipeline gives the kernels' ciphertexts")
    print(f"[func] noise-limited calls through the plain rotation: {time.perf_counter() - t0:.3f} s"
          f" (host clock)")
    s = sk.s.to(inp["floor8"].a.device, torch.int64)

    def error(ct, value):
        """Signed phase of ct minus value, in (-modulus/2, modulus/2]."""
        mod = ct.modulus
        ph = (ct.b.to(torch.int64) - (ct.a.to(torch.int64) * s).sum(-1)) % mod
        return (ph - value + mod // 2) % mod - mod // 2

    ct1 = funcboot.add_const(inp["floor8"], beta)
    x1 = error(ct1, 0) % q
    ct2 = funcboot.bootstrap_func(p, key, funcboot.set_modulus(ct1, q),
                                  funcboot._f0_table(q, 8 * q), 8 * q)
    e2 = error(ct2, torch.where(x1 < q // 2, 8 * q - q // 4, q // 4))
    mid = funcboot.sub(ct1, ct2)
    x = error(mid, 0) % q
    xs, mod = np.arange(q), 8 * q                # eval_floor's second LUT
    f2 = np.where(xs < q // 4, (mod - q // 2 - xs) % mod,
                  np.where(xs < 3 * (q // 4), xs, (mod + q // 2 - xs) % mod))
    ct3 = funcboot.bootstrap_func(p, key, funcboot.set_modulus(mid, q), f2, mod)
    e3 = error(ct3, torch.from_numpy(f2).to(x.device)[x])
    whole = outs[f"eval_floor 8q batch {BATCH}"]
    parts = funcboot.sub(mid, ct3)
    if not (torch.equal(parts.a, whole.a) and torch.equal(parts.b, whole.b)):
        fail("[func] eval_floor 8q taken apart does not give eval_floor's output")
    past = ((x < q // 4) | (x >= 3 * q // 4)).cpu().numpy()
    big = (e3.abs() >= q // 2 - 1).cpu().numpy()
    wrong = ctx.decrypt(sk, whole, 8).cpu().numpy() != inp["m8"]
    sigma = [float(e.double().std()) for e in (e2, e3)]
    print(f"[func] eval_floor 8q taken apart: its bootstraps' output noise std {sigma[0]:.3f} and "
          f"{sigma[1]:.3f}, largest {int(e2.abs().max())} and {int(e3.abs().max())}, in units of "
          f"8q = {8 * q} (beta = {beta}; P(N(0, std) < -beta) = "
          f"{0.5 * math.erfc(beta / sigma[0] / math.sqrt(2)):.4f}); middle phase past [q/4, 3q/4) "
          f"on {int(past.sum())} of {BATCH}, |e3| >= q/2 on {int(big.sum())}; wrong outputs "
          f"{int(wrong.sum())}: {int((wrong & past).sum())} past, {int((wrong & big & ~past).sum())}"
          f" by e3 alone, {int((wrong & ~past & ~big).sum())} unexplained  ({card})")
    if (wrong & ~past & ~big).any():
        fail("[func] eval_floor 8q is wrong where neither its middle phase nor e3 explains it")


def public_key_check(dev) -> None:
    """key_gen_pair, a bootstrap key on its secret keys, encrypt_pk of
    BATCH random bits decrypted under sk_n and, switched to (n, q) with the
    ksk, ANDed with secret-key ciphertexts against the truth table."""
    from fhe_tpu_torch import BinFheContext, kernels
    from fhe_tpu_torch.tfhe import lwe
    ctx = BinFheContext.generate("STD128", device=dev)
    p = ctx.params
    rng = np.random.default_rng(SEED + 8)
    t0 = time.perf_counter()
    sk, sk_n, pk = ctx.key_gen_pair(rng)
    key = ctx.bt_key_gen(sk, rng, sk_n=sk_n)
    torch.cuda.synchronize()
    print(f"[func] STD128 key_gen_pair (pk A {tuple(pk.A.shape)}) and bt_key_gen on its keys: "
          f"{time.perf_counter() - t0:.3f} s (host clock)")
    m1, m2 = rng.integers(0, 2, size=(2, BATCH))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ct_n = ctx.encrypt_pk(pk, m1, rng)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    ct1 = ctx.encrypt_pk(pk, m1, rng, ksk=key.ksk)
    ct2 = ctx.encrypt(sk, m2, rng)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = ctx.eval_bin_gate(key, "AND", ct1, ct2)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    checks = [(f"encrypt_pk batch {BATCH} (dimension N, mod Q) under sk_n", ct_n, sk_n, m1,
               (p.N, p.Q)),
              (f"encrypt_pk batch {BATCH} switched to (n, q)", ct1, sk, m1, (p.n, p.q)),
              (f"AND(public-key ct, secret-key ct) batch {BATCH}", out, sk, m1 & m2, (p.n, p.q))]
    for what, ct, key_s, want, (dim, mod) in checks:
        if ct.a.shape != (BATCH, dim) or ct.modulus != mod:
            fail(f"[func] {what}: output ciphertext shape {tuple(ct.a.shape)} mod {ct.modulus}")
        wrong = int((ctx.decrypt(key_s, ct).cpu().numpy() != want).sum())
        print(f"[func] {what}: {wrong} wrong of {BATCH}")
        if wrong:
            fail(f"[func] {what} does not decrypt to its truth table")
    noise = int(lwe.noise(p, sk_n, ct_n, m1).abs().max().item())
    print(f"[func] encrypt_pk batch {BATCH}: {enc_s * 1e3:.3f} ms with its host draws (host "
          f"clock); largest |noise| {noise} (decryption margin Q/8 = {p.Q // 8})")
    want = {"blind_rotate": 1, "ntt_forward": 1, "ntt_inverse": 1}
    if any(count != want.get(name, 0) for name, count in launches.items()):
        fail(f"[func] public-key AND launches {launches}, expected {want}")


def func_phase(dev, ctx, sk, key, errors: Errors, card: str) -> dict:
    """The [func] phase; returns the launches of its counted run per
    accumulator."""
    from fhe_tpu_torch.tfhe import boot, boot_pallas
    t_phase = time.perf_counter()
    p = ctx.params
    q = p.q
    check_func_kernels(dev, p, errors)
    rng = np.random.default_rng(SEED + 6)
    inp = {"m4": rng.integers(0, 4, size=BATCH)}
    inp["ct4"] = ctx.encrypt(sk, inp["m4"], rng)
    inp["one"] = ctx.encrypt(sk, inp["m4"][:1], rng)
    inp["m8"] = rng.integers(0, 8, size=BATCH)
    inp["floor8"] = ctx.encrypt(sk, inp["m8"], rng, p=8, modulus=8 * q)
    inp["msign"] = rng.integers(0, 8, size=BATCH + SIGN_8Q_BATCH)
    inp["sign16"] = ctx.encrypt(sk, inp["msign"][:BATCH], rng, p=8, modulus=16 * q)
    inp["sign8"] = ctx.encrypt(sk, inp["msign"][BATCH:], rng, p=8, modulus=8 * q)
    inp["m16"] = rng.integers(0, 16, size=BATCH)
    inp["decomp"] = ctx.encrypt(sk, inp["m16"], rng, p=16, modulus=4 * q)
    inp["m2"] = rng.integers(0, 2, size=BATCH)
    inp["floor2"] = ctx.encrypt(sk, inp["m2"], rng, p=2, modulus=2 * q)
    inp["sign2"] = ctx.encrypt(sk, inp["msign"][:BATCH], rng, p=8, modulus=2 * q)
    launches, first = {}, None
    for impl in IMPLS:
        outs, launches[impl] = func_run(ctx, sk, key, inp, impl)
        if first is None:
            first = outs
            continue
        for what, out in outs.items():
            if not (torch.equal(out.a, first[what].a) and torch.equal(out.b, first[what].b)):
                fail(f"[func] {what}: ntt_impl={impl} output differs from ntt_impl=None")
        print(f"[func] ntt_impl={impl}: all {len(outs)} outputs identical to ntt_impl=None")
    check_noise_limited(ctx, sk, key, inp, first, card)
    ct4, one, ct_sign16 = inp["ct4"], inp["one"], inp["sign16"]

    lut = ctx.generate_lut(FUNC_LUTS["arbitrary"], 4)
    for impl in IMPLS:
        c = dataclasses.replace(ctx, ntt_impl=impl)
        func_ms = time_ms(lambda: c.eval_func(key, ct4, lut), reps=3)
        sign_ms = time_ms(lambda: c.eval_sign(key, ct_sign16), reps=3)
        single_ms = time_ms(lambda: c.eval_func(key, one, lut), reps=5)
        print(f"[func] ntt_impl={impl} STD128 EvalFunc (arbitrary LUT, 2 bootstraps) batch "
              f"{BATCH}: {func_ms:.3f} ms = {BATCH / func_ms * 1e3:.1f} ciphertexts/s  ({card})")
        print(f"[func] ntt_impl={impl} STD128 EvalSign at 16q (5 bootstraps) batch {BATCH}: "
              f"{sign_ms:.3f} ms = {BATCH / sign_ms * 1e3:.1f} ciphertexts/s  ({card})")
        print(f"[func] ntt_impl={impl} STD128 single EvalFunc (arbitrary LUT) latency: "
              f"{single_ms:.3f} ms  ({card})")

    # the rotation kernels at ct_mod 2N (every index reachable) beside q
    gen = np.random.default_rng(SEED + 9)
    acc = _residues(gen, p.Q, (BATCH, 2, p.N), dev)
    masks = {q_lwe: _residues(gen, q_lwe, (BATCH, p.n), dev) for q_lwe in (2 * p.N, q)}
    rotations = {"blind_rotate": lambda a, q_lwe: boot.blind_rotate(p, key, acc, a, q_lwe),
                 "blind_rotate_mega": lambda a, q_lwe: boot_pallas.blind_rotate_mega(
                     p, key.bsk_br, acc, a, q_lwe),
                 "rotate_step_br": lambda a, q_lwe: boot_pallas.blind_rotate_fused(
                     p, key.bsk_br, acc, a, q_lwe)}
    for name, rot in rotations.items():
        times = {q_lwe: [] for q_lwe in masks}
        for q_lwe in (2 * p.N, q, 2 * p.N, q):
            times[q_lwe].append(time_ms(lambda: rot(masks[q_lwe], q_lwe), reps=3))
        print(f"[func] {name} [{BATCH}, 2, {p.N}] x {p.n} steps (n launches for rotate_step_br), "
              f"STD128 key, medians of 3 in two turns: "
              f"{' / '.join(f'{t:.3f}' for t in times[2 * p.N])} ms at q_lwe = 2N, "
              f"{' / '.join(f'{t:.3f}' for t in times[q])} ms at q_lwe = q  ({card})")
    public_key_check(dev)
    print(f"[func] the phase took {time.perf_counter() - t_phase:.3f} s (host clock)")
    return launches


def check_wide_kernels(dev, p, errors: Errors) -> None:
    """Kernels 3-5 on the wide step at TOY_RADIX's (8192, 10) against their
    plain versions: batch 1, 8 and SMs + 1 (a last wave of one block),
    the mask mod q (a gate, a periodic LUT) and 2q (an arbitrary LUT);
    random keys of 4 steps."""
    from fhe_tpu_torch.tfhe import boot, boot_pallas, rgsw
    rng = np.random.default_rng(SEED + 10)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    steps = 4
    for B in (1, 8, sms + 1):
        acc = _residues(rng, p.Q, (B, 2, p.N), dev)
        bsk = _residues(rng, p.Q, (steps, 2, p.digits_g2, 2, p.N), dev)
        bsk_br = boot_pallas.bsk_to_br(p, bsk)
        for q_lwe in (p.q, 2 * p.q):
            a = _residues(rng, q_lwe, (B, steps), dev)
            at = f"TOY_RADIX B={B} steps={steps} q_lwe={q_lwe} random key"
            errors.compare("blind_rotate_wide",
                           boot.blind_rotate(p, rgsw.BootstrapKey(bsk, None), acc, a, q_lwe),
                           boot.blind_rotate_plain(p, bsk, acc, a, q_lwe), f"blind_rotate {at}",
                           show=False)
            want = boot_pallas.blind_rotate_mega_plain(p, bsk_br, acc, a, q_lwe)
            errors.compare("blind_rotate_mega_wide",
                           boot_pallas.blind_rotate_mega(p, bsk_br, acc, a, q_lwe), want,
                           f"blind_rotate_mega {at}", show=False)
            errors.compare("rotate_step_br_wide",
                           boot_pallas.blind_rotate_fused(p, bsk_br, acc, a, q_lwe), want,
                           f"rotate_step_br x {steps} launches {at}", show=False)
    print(f"[radix] kernels 3, 4 and 5 at (N, dG2) = ({p.N}, {p.digits_g2}), batch 1, 8 and "
          f"{sms + 1}, q_lwe = q and 2q: byte-equal to their plain versions")


@contextlib.contextmanager
def counted_bootstraps():
    """Counts funcboot.bootstrap_func's calls (one blind rotation each) and
    keeps their input ciphertexts."""
    from fhe_tpu_torch.tfhe import funcboot
    inputs = []
    inner = funcboot.bootstrap_func

    def counted(params, key, ct, *args, **kwargs):
        inputs.append(ct)
        return inner(params, key, ct, *args, **kwargs)
    funcboot.bootstrap_func = counted
    try:
        yield inputs
    finally:
        funcboot.bootstrap_func = inner


def past_margin_rows(fc, inputs) -> set:
    """The rows (axis 0 of a radix op's batch) on which some bootstrap's
    input phase lies past its slot's lower margin.  Every radix LUT input
    has its message m at m q/p + beta + e (beta added by eval_func, q/p =
    512 at TOY_RADIX) and is read right for e in [-beta, q/p - beta); from
    the phase alone, e_hat = the phase's offset from the nearest m q/p +
    beta, in [-q/(2p), q/(2p)), equals e while |e| < q/(2p), so e_hat <
    -beta marks an input read into the slot below."""
    from fhe_tpu_torch.tfhe import funcboot, lwe
    rows = set()
    for ct in inputs:
        slot = fc.params.q // ct.pt_mod
        phase = lwe.noise(fc.params, fc.sk, ct, np.zeros(ct.batch_shape, np.int64), p=1)
        e_hat = (phase.to(torch.int64) - funcboot.BETA + slot // 2) % slot - slot // 2
        past = (e_hat < -funcboot.BETA).reshape(ct.batch_shape[0], -1).any(dim=1)
        rows.update(torch.nonzero(past).flatten().tolist())
    return rows


def decrypted(fc, out) -> np.ndarray:
    """An EncryptedInt's values, or an encrypted bool's, as Python ints."""
    from fhe_tpu_torch.tfhe import lwe
    if isinstance(out, lwe.LweCiphertext):
        return fc.decrypt_bool(out).astype(object)
    return np.asarray(fc.decrypt(out), dtype=object)


def radix_rows(x, rows: list):
    """The given rows (axis 0) of an EncryptedInt or an LweCiphertext."""
    from fhe_tpu_torch.tfhe import lwe, radix
    from fhe_tpu_torch.tfhe.fhevm import EncryptedInt
    idx = torch.tensor(rows, dtype=torch.int64)
    ct = x.value.ct if isinstance(x, EncryptedInt) else x
    sub = lwe.LweCiphertext(a=ct.a[idx.to(ct.a.device)], b=ct.b[idx.to(ct.b.device)],
                            modulus=ct.modulus, pt_mod=ct.pt_mod)
    if isinstance(x, EncryptedInt):
        return EncryptedInt(radix.RadixInt(ct=sub, rp=x.value.rp, max_limb=x.value.max_limb),
                            x.fhe_type)
    return sub


def radix_run(tag: str, fc, what: str, op, inputs: tuple, want, totals: collections.Counter,
              plain_check: bool = True):
    """One counted op, op(fc, *inputs): launches reset before and read
    after, its CUDA-event time, launches of exactly one rotation kernel (or
    n of kernel 5) and one of each NTT kernel a bootstrap, and its output
    against Python integers.  TOY_RADIX's noise makes some LUT reads wrong
    in fhe_tpu too (ROADMAP queue 3: a packed pair x = a + 4b carries 4
    times b's noise): an output may be wrong only on a row where some
    bootstrap's input phase is past its slot's margin
    (`past_margin_rows`), and with plain_check the first wrong row, run
    again through the plain rotation on the card, must give the same
    bytes.  Adds the launches to totals; returns (ms, out, the rows past
    a margin)."""
    from fhe_tpu_torch import kernels
    from fhe_tpu_torch.tfhe.fhevm import EncryptedInt
    impl = fc.ntt_impl
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with counted_bootstraps() as boot_inputs:
        ms, out = timed_once(lambda: op(fc, *inputs))
    launches = kernels.launch_counts()
    got = decrypted(fc, out)
    want = np.asarray(want, dtype=object)
    if got.shape != want.shape:
        fail(f"{tag} {what}: output of shape {got.shape}, expected {want.shape}")
    wrong = np.nonzero(got != want)[0].tolist()
    past = past_margin_rows(fc, boot_inputs)
    boots = len(boot_inputs)
    print(f"{tag} {what}: {len(wrong)} wrong of {want.size}"
          + (f" (rows {wrong[:12]}{' ...' if len(wrong) > 12 else ''})" if wrong else "")
          + f"; {len(past)} rows with a bootstrap input past its margin; {boots} bootstraps, "
          f"{ms:.3f} ms  (CUDA events, first call)")
    unexplained = [r for r in wrong if r not in past]
    if unexplained:
        fail(f"{tag} {what}: rows {unexplained[:8]} are wrong with every bootstrap input inside "
             f"its margin")
    if wrong and plain_check:
        with plain_rotation():
            again = op(fc, *[radix_rows(x, wrong[:1]) for x in inputs])
        ct, ct_again = (radix_rows(o.value.ct if isinstance(o, EncryptedInt) else o, rows)
                        for o, rows in ((out, wrong[:1]), (again, [0])))
        if not (torch.equal(ct.a, ct_again.a) and torch.equal(ct.b, ct_again.b)):
            fail(f"{tag} {what}: row {wrong[0]} differs from the plain pipeline's")
        print(f"{tag} {what}: row {wrong[0]} through the plain rotation: the same bytes")
    per_boot = {WIDE_KERNEL[impl]: fc.params.n if impl == "fused" else 1, "ntt_forward": 1,
                "ntt_inverse": 1}
    for name, count in launches.items():
        if count != boots * per_boot.get(name, 0):
            fail(f"{tag} {what}: {count} {name} launches, expected {boots * per_boot.get(name, 0)}")
    totals.update(launches)
    return ms, out, past


def radix_phase(dev, errors: Errors, card: str) -> tuple[dict, dict]:
    """The [radix] phase: TOY_RADIX keyed at full width on the card;
    returns the wide kernels' launches in its counted runs and their times
    (for the kernels line)."""
    from fhe_tpu_torch.tfhe import funcboot, lwe, shortint
    from fhe_tpu_torch.tfhe.fhevm import FheContext, FheType
    t_phase = time.perf_counter()
    tag = "[radix]"
    t0 = time.perf_counter()
    fc = FheContext.create(RADIX_SET, rng=SEED, device=dev)
    torch.cuda.synchronize()
    p = fc.params
    print(f"{tag} {RADIX_SET} (N = {p.N}, n = {p.n}, q = {p.q}, Q = {p.Q}, dG2 = "
          f"{p.digits_g2}) keygen (ksk {tuple(fc.key.ksk.a.shape)}, bsk {tuple(fc.key.bsk.shape)})"
          f" on {dev}: {time.perf_counter() - t0:.3f} s (host clock)")
    check_wide_kernels(dev, p, errors)
    totals = collections.Counter()
    rng = np.random.default_rng(SEED + 11)
    E8, E16, E64 = FheType.EUINT8, FheType.EUINT16, FheType.EUINT64
    a, b = rng.integers(0, 256, size=(2, RADIX_PAIRS)).astype(object)
    b[:32] = a[:32]                                  # equal pairs for eq
    b[32:64:4] = 0                                   # zeros for is_zero
    sel = rng.integers(0, 2, size=RADIX_PAIRS)
    xa, xb = fc.encrypt(a, E8, rng), fc.encrypt(b, E8, rng)
    cond = fc.ctx.encrypt(fc.sk, sel, rng, p=16)
    # op -> (call on (fc, *inputs), inputs, Python integers, plain check)
    ops = {"add": (lambda f, x, y: f.add(x, y), (xa, xb), (a + b) % 256),
           "sub": (lambda f, x, y: f.sub(x, y), (xa, xb), (a - b) % 256),
           "mul": (lambda f, x, y: f.mul(x, y), (xa, xb), (a * b) % 256),
           "lt": (lambda f, x, y: f.lt(x, y), (xa, xb), (a < b).astype(int)),
           "eq": (lambda f, x, y: f.eq(x, y), (xa, xb), (a == b).astype(int)),
           "and_": (lambda f, x, y: f.and_(x, y), (xa, xb), a & b),
           "xor": (lambda f, x, y: f.xor(x, y), (xa, xb), a ^ b),
           "not_": (lambda f, x: f.not_(x), (xa,), 255 - a),
           "select": (lambda f, c, x, y: f.select(c, x, y), (cond, xa, xb),
                      np.where(sel == 1, a, b)),
           "min": (lambda f, x, y: f.min(x, y), (xa, xb), np.minimum(a, b)),
           "shl 3": (lambda f, x: f.shl(x, 3), (xa,), (a * 8) % 256),
           "neg": (lambda f, x: f.neg(x), (xa,), (-a) % 256),
           "is_zero": (lambda f, y: f.is_zero(y), (xb,), (b == 0).astype(int)),
           "add_scalar 77": (lambda f, x: f.add_scalar(x, 77), (xa,), (a + 77) % 256),
           "cast to euint16": (lambda f, x: f.cast(x, E16), (xa,), a)}
    ms, outs = {}, {}
    for what, (op, inputs, want) in ops.items():
        ms[what], outs[what], _ = radix_run(tag, fc, f"euint8 {what} on {RADIX_PAIRS} pairs", op,
                                            inputs, want, totals)
    d = RADIX_DIV_PAIRS
    ad, bd = a[:d], b[:d].copy()
    bd[0] = 0                                        # by zero: q all ones, r = a
    xad, xbd = fc.encrypt(ad, E8, rng), fc.encrypt(bd, E8, rng)
    qd = np.array([255 if y == 0 else x // y for x, y in zip(ad, bd)], dtype=object)
    rd = np.array([x if y == 0 else x % y for x, y in zip(ad, bd)], dtype=object)
    # (the plain rotation would take minutes for a division's 512 bootstraps)
    ms["div"], _, _ = radix_run(tag, fc, f"euint8 div on {d} pairs (one by zero)",
                                lambda f, x, y: f.div(x, y), (xad, xbd), qd, totals,
                                plain_check=False)
    ms["rem"], _, _ = radix_run(tag, fc, f"euint8 rem on {d} pairs", lambda f, x, y: f.rem(x, y),
                                (xad, xbd), rd, totals, plain_check=False)

    # the confidential transfer of fhEVM token contracts, euint64 (32 limbs:
    # Kogge-Stone carries)
    k = RADIX_ACCOUNTS
    frm = np.array([int(v) for v in rng.integers(0, 2**62, size=k)], dtype=object) * 3
    amt = np.array([int(v) for v in rng.integers(0, 2**62, size=k)], dtype=object) * 2
    amt[::3] = frm[::3]                              # exactly the balance
    to = np.array([int(v) for v in rng.integers(0, 2**63, size=k)], dtype=object)
    xf, xm, xt = (fc.encrypt(v, E64, rng) for v in (frm, amt, to))
    ok = frm >= amt
    radix_run(tag, fc, f"euint64 ge on {k} accounts", lambda f, x, y: f.ge(x, y), (xf, xm),
              ok.astype(int), totals)
    state = {}

    def transfer(f, x_from, x_amt, x_to):
        state["ok"] = f.ge(x_from, x_amt)
        state["to"] = f.select(state["ok"], f.add(x_to, x_amt), x_to)
        return f.select(state["ok"], f.sub(x_from, x_amt), x_from)
    # (its ge is checked against the plain rotation above; the whole
    # transfer's some 230 bootstraps would take minutes there)
    ms["transfer"], _, past = radix_run(
        tag, fc, f"euint64 transfer on {k} accounts (from')", transfer, (xf, xm, xt),
        np.where(ok, frm - amt, frm), totals, plain_check=False)
    for what, out, want in (("ok = ge(from, amt)", state["ok"], ok.astype(int)),
                            ("to'", state["to"], np.where(ok, (to + amt) % 2**64, to))):
        wrong = np.nonzero(decrypted(fc, out) != np.asarray(want, dtype=object))[0].tolist()
        print(f"{tag} euint64 transfer {what}: {len(wrong)} wrong of {k} ({int(ok.sum())} "
              f"transfers go through)")
        if any(r not in past for r in wrong):
            fail(f"{tag} euint64 transfer {what}: a row is wrong with every bootstrap input "
                 f"inside its margin")
    # the proof (tfhe/zkp.py's commitment) of the euint64 balances: the card's
    # against the CPU port's on the same ciphertext copied to the host
    proof = fc.get_proof(xf)
    on_host = dataclasses.replace(xf, value=dataclasses.replace(xf.value, ct=xf.value.ct.to("cpu")))
    changed = bytes([proof[0] ^ 1]) + proof[1:]
    if proof != fc.get_proof(on_host) or not fc.verify_proof(xf, proof) or \
            fc.verify_proof(xf, changed):
        fail(f"{tag} get_proof / verify_proof of the euint64 balances")
    print(f"{tag} get_proof of the euint64 balances ({k} x 32 limbs): {proof.hex()[:16]}..., "
          f"byte-equal to the CPU port's on the host copy; verify_proof accepts it and rejects "
          f"it with one bit changed")

    x1, y1 = fc.encrypt(a[:1], E8, rng), fc.encrypt(b[:1], E8, rng)
    radix_run(tag, fc, "single euint8 add (batch 1)", lambda f, x, y: f.add(x, y), (x1, y1),
              (a[:1] + b[:1]) % 256, totals)
    single_add = time_ms(lambda: fc.add(x1, y1), reps=5)
    radix_run(tag, fc, "single euint8 sub (batch 1)", lambda f, x, y: f.sub(x, y), (x1, y1),
              (a[:1] - b[:1]) % 256, totals)
    single_sub = time_ms(lambda: fc.sub(x1, y1), reps=3)

    # public-key encryption: the dimension-N key, then the ksk switch to (n, q)
    t0 = time.perf_counter()
    pk = fc.public_key_gen(rng)
    torch.cuda.synchronize()
    pk_s = time.perf_counter() - t0
    m = rng.integers(0, 256, size=64).astype(object)
    t0 = time.perf_counter()
    xp = fc.encrypt_public(m, E8, rng)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    xs64 = fc.encrypt(a[:64], E8, rng)
    radix_run(tag, fc, "encrypt_public of 64 euint8", lambda f, x: x, (xp,), m, totals)
    radix_run(tag, fc, "add(public-key euint8, secret-key euint8) on 64",
              lambda f, x, y: f.add(x, y), (xp, xs64), (m + a[:64]) % 256, totals)
    print(f"{tag} public_key_gen (A {tuple(pk.A.shape)}): {pk_s:.3f} s; encrypt_public of 64 "
          f"euint8 (256 limbs): {enc_s * 1e3:.3f} ms (host clock, with its host draws)")

    # every ntt_impl gives the same ciphertexts
    for impl in IMPLS[1:]:
        c = FheContext(**{**vars(fc), "ctx": dataclasses.replace(fc.ctx, ntt_impl=impl)})
        for what in ("add", "lt"):
            op, inputs, want = ops[what]
            _, out, _ = radix_run(f"{tag} ntt_impl={impl}", c, f"euint8 {what} on {RADIX_PAIRS} "
                                  f"pairs", op, inputs, want, totals, plain_check=False)
            ref = outs[what].value.ct if what == "add" else outs[what]
            got = out.value.ct if what == "add" else out
            if not (torch.equal(got.a, ref.a) and torch.equal(got.b, ref.b)):
                fail(f"{tag} euint8 {what}: ntt_impl={impl} output differs from ntt_impl=None")
        print(f"{tag} ntt_impl={impl}: euint8 add and lt identical to ntt_impl=None")
    print(f"{tag} launches of the counted runs: {dict(totals)}")
    for name in WIDE_KERNEL.values():
        if totals[name] <= 0:
            fail(f"{tag} kernel {name} was not launched")
    for name in (*ACC_KERNEL.values(), *LIMB_KERNELS):
        if totals[name]:
            fail(f"{tag} kernel {name} launched {totals[name]} times at TOY_RADIX")

    # times (CUDA events)
    print(f"{tag} euint8 at {RADIX_PAIRS} pairs, ops/s: " + ", ".join(
        f"{w} {RADIX_PAIRS / ms[w] * 1e3:.1f}" for w in ("add", "sub", "mul", "lt")) +
        f"; euint64 transfers/s at {k}: {k / ms['transfer'] * 1e3:.2f}; single euint8 add "
        f"latency {single_add:.3f} ms (lazy: no bootstrap), single euint8 sub {single_sub:.3f} ms"
        f"  ({card})")
    sp = shortint.ShortIntParams(2, 2)
    vals = rng.integers(0, 16, size=BATCH)
    limbs = shortint.encrypt(p, sp, fc.sk, vals, rng)
    carry = shortint.luts(p, sp)["carry"]
    lut = lambda: shortint.apply_lut(p, fc.key, limbs, carry, sp)
    lut_ms = time_ms(lut, reps=2)
    out = lut()
    wrong = int((shortint.decrypt(p, sp, fc.sk, out) != vals // 4).sum())
    noise = lwe.noise(p, fc.sk, out, vals // 4, p=sp.p).to(torch.float64)
    sigma = float(noise.std())
    # a packed pair a + 4b carries sqrt(1 + 4^2) times one output's noise,
    # and is read wrong past -beta
    packed = 0.5 * math.erfc(funcboot.BETA / (math.sqrt(17) * sigma) / math.sqrt(2))
    print(f"{tag} apply_lut (carry, 2 bootstraps at 2q) over {BATCH} limb ciphertexts: "
          f"{lut_ms:.3f} ms = {2 * BATCH / lut_ms * 1e3:.1f} bootstraps/s, {wrong} wrong; its "
          f"output noise std {sigma:.3f}, largest |e| {int(noise.abs().max())} (slot q/p = "
          f"{p.q // sp.p}, margin beta = {funcboot.BETA}): a packed pair of such outputs is read "
          f"wrong with probability {packed:.4f}  ({card})")
    if wrong:
        fail(f"{tag} apply_lut over fresh limbs does not decrypt right")

    result = time_wide_kernels(dev, fc, errors, card)
    print(f"{tag} the phase took {time.perf_counter() - t_phase:.3f} s (host clock)")
    return {name: totals[name] for name in WIDE_KERNEL.values()}, result


def time_wide_kernels(dev, fc, errors: Errors, card: str) -> dict:
    """Kernels 3-5 on the wide step at [BATCH, 2, 8192] x 64 steps (kernel
    5: a launch, over its n launches) on the TOY_RADIX key, beside their
    bound and the key's L2 traffic; their plain versions timed (and the
    kernels held to them) at batch RADIX_PLAIN_BATCH."""
    from fhe_tpu_torch.tfhe import boot, boot_pallas
    p, key = fc.params, fc.key
    gen = np.random.default_rng(SEED + 12)
    int_peak = int_multiply_peak(dev)
    acc = _residues(gen, p.Q, (BATCH, 2, p.N), dev)
    msk = _residues(gen, p.q, (BATCH, p.n), dev)
    small = RADIX_PLAIN_BATCH
    xs, ms_ = acc[:small].contiguous(), msk[:small].contiguous()
    pows = boot._psi_powers_mont_words(p.N, p.Q, dev)
    tables = 4 * 4 * p.N                            # the four NTT tables
    rot_bytes = _nbytes(acc, acc, key.bsk, msk, pows) + tables
    step_bytes = _nbytes(acc, acc, key.bsk[0], msk[:, 0], pows) + tables
    muls = step_multiplies(p) * BATCH
    key_bytes = key.bsk.numel() * 4                 # read by every ciphertext (C = 1)
    bsk_br = key.bsk_br
    p_ms, want_nat = timed_once(lambda: boot.blind_rotate_plain(p, key.bsk, xs, ms_))
    p_ms_br, want_br = timed_once(lambda: boot_pallas.blind_rotate_mega_plain(p, bsk_br, xs, ms_))
    p_ms_step, _ = timed_once(lambda: boot_pallas.rotate_step_br_plain(p, bsk_br[0], xs,
                                                                       ms_[:, 0]))
    # name -> (kernel call, plain ms, plain output, launches a call, bytes, multiplies)
    cases = {
        "blind_rotate_wide": (lambda x, m: boot.blind_rotate(p, key, x, m), p_ms, want_nat, 1,
                              rot_bytes, muls * p.n),
        "blind_rotate_mega_wide": (lambda x, m: boot_pallas.blind_rotate_mega(p, bsk_br, x, m),
                                   p_ms_br, want_br, 1, rot_bytes, muls * p.n),
        "rotate_step_br_wide": (lambda x, m: boot_pallas.blind_rotate_fused(p, bsk_br, x, m),
                                p_ms_step, want_br, p.n, step_bytes, muls),
    }
    result = {}
    for name, (kern, plain_ms, want, launches, nbytes, nmuls) in cases.items():
        errors.compare(name, kern(xs, ms_), want,
                       f"{name} [{small}, 2, {p.N}] x {p.n} steps ({launches} launch{'es' * (launches > 1)}), "
                       f"TOY_RADIX key")
        small_ms = time_ms(lambda: kern(xs, ms_), reps=3)
        k_ms = time_ms(lambda: kern(acc, msk), reps=3) / launches
        b_ms, b_by = bound(nbytes, nmuls, int_peak)
        what = (f"[{BATCH}, 2, {p.N}] x {p.n} steps" if launches == 1 else
                f"[{BATCH}, 2, {p.N}] x 1 step (over {launches} launches)")
        print(f"[time] {name} {what}, TOY_RADIX key: kernel {k_ms:.3f} ms, plain {plain_ms:.3f} ms "
              f"at batch {small} ({'one step' if launches > 1 else 'all steps'}); all {p.n} steps "
              f"at batch {small}: kernel {small_ms:.3f} ms; bound {b_ms:.3f} ms by {b_by} "
              f"({nbytes} bytes, {nmuls} multiplies), kernel at {b_ms / k_ms:.3f} of its bound; "
              f"the key read from L2 by every ciphertext: {key_bytes / 2**20:.0f} MiB, "
              f"{key_bytes * BATCH / launches / 2**30:.1f} GiB a launch at batch {BATCH}  ({card})")
        result[name] = (k_ms, plain_ms, b_ms, b_by)
    return result


@contextlib.contextmanager
def limb_launch_shapes():
    """Records (kernel, [rows, L, N]) of every limb-stacked NTT launch in the
    block, through the wrappers that rns.ntt_forward / ntt_inverse call."""
    from fhe_tpu_torch.kernels import ntt as kntt
    seen = collections.Counter()
    originals = {"ntt_forward_limbs": kntt.forward_limbs, "ntt_inverse_limbs": kntt.inverse_limbs}

    def recorder(name, fn):
        def call(plan, x):
            seen[(name, tuple(x.shape), plan.moduli)] += 1
            return fn(plan, x)
        return call
    kntt.forward_limbs = recorder("ntt_forward_limbs", originals["ntt_forward_limbs"])
    kntt.inverse_limbs = recorder("ntt_inverse_limbs", originals["ntt_inverse_limbs"])
    try:
        yield seen
    finally:
        kntt.forward_limbs = originals["ntt_forward_limbs"]
        kntt.inverse_limbs = originals["ntt_inverse_limbs"]


@contextlib.contextmanager
def single_launch_shapes():
    """Counts the single-modulus NTT launches in the block by (kernel,
    [rows, N], q), as limb_launch_shapes does the limb-stacked ones."""
    from fhe_tpu_torch.kernels import ntt as kntt
    seen = collections.Counter()
    originals = (kntt.forward, kntt.inverse)

    def recorder(kind, fn):
        def call(plan, x, *args, **kwargs):
            small = "_small" if plan.N in kntt.small_sizes() else ""
            seen[(f"ntt_{kind}{small}", tuple(x.shape), plan.q)] += 1
            return fn(plan, x, *args, **kwargs)
        return call
    kntt.forward, kntt.inverse = recorder("forward", originals[0]), recorder("inverse", originals[1])
    try:
        yield seen
    finally:
        kntt.forward, kntt.inverse = originals


def ckks_values_close(what: str, got: np.ndarray, want: np.ndarray, tol: float,
                      tag: str = "[ckks]") -> None:
    err = float(np.abs(got - want).max())
    print(f"{tag} {what}: max |decrypted - expected| = {err:.3e} (tolerance {tol:.4g})")
    if not err < tol:
        fail(f"{tag} {what}: error {err} is not below {tol}")


def ckks_same(what: str, a, b, tag: str = "[ckks]") -> None:
    if a.moduli != b.moduli or a.scale != b.scale or not (
            torch.equal(a.c0.data.cpu(), b.c0.data.cpu()) and
            torch.equal(a.c1.data.cpu(), b.c1.data.cpu())):
        fail(f"{tag} {what}: the ciphertexts differ")
    print(f"{tag} {what}: byte-equal ({len(a.moduli)} limbs, scale {a.scale!r})")


def ckks_keys(ctx, seed: int):
    """keygen, the relinearization key, its prepared form, z and its
    encryption, from seed: the draws the card and the CPU both make."""
    from fhe_tpu_torch.pke import rlwe
    rng = np.random.default_rng(seed)
    sk, pk = ctx.keygen(rng)
    evk = ctx.relin_key_gen(sk, rng)
    pevk = rlwe.prepare_evk(ctx.params, evk)
    z = rng.normal(size=ctx.params.N // 2) * 0.5                 # bench.py:249
    return rng, sk, pk, evk, pevk, z, ctx.encrypt(pk, z, rng)


def ckks_ops(ctx, rng, sk, pk, ct, z, w):
    """Rotation keys for CKKS_ROTS, the conjugation key, a second ciphertext
    (of z2) and one of the complex z + i z2, drawn from rng after
    ckks_keys' draws; then rotate, add, mul_plain + rescale of ct and
    conjugate of the complex one (a real input is its own conjugate):
    ({op: ciphertext}, ct2, z2)."""
    rot = ctx.rotation_key_gen(sk, CKKS_ROTS, rng)
    conj = ctx.conj_key_gen(sk, rng)
    z2 = rng.normal(size=ctx.params.N // 2) * 0.5
    ct2 = ctx.encrypt(pk, z2, rng)
    ct_c = ctx.encrypt(pk, z + 1j * z2, rng)
    out = {f"rotate by {r}": ctx.rotate(ct, r, rot) for r in CKKS_ROTS}
    out["conjugate"] = ctx.conjugate(ct_c, conj)
    out["add"] = ctx.add(ct, ct2)
    out["mul_plain then rescale"] = ctx.rescale(ctx.mul_plain(ct, w))
    return out, ct2, z2


# (kernel, shape, basis) of the limb-stacked launches limb_kernels_at has held
# to the plain versions and timed in this run
LIMB_SHAPES_CHECKED: set = set()
# (what, kernel, shape, bound ms, one launch) of the launches whose trace held
# no kernel (in [fbt], while the [ss] process traces beside it; [2, 3, N]
# forwards in any phase): timed again by retrace_untraced
UNTRACED: list = []


def limb_kernels_at(tag: str, call: str, dev, shapes: collections.Counter, dev_ms: dict,
                    errors: Errors, int_peak: float, card: str) -> None:
    """Kernels 1-2 at every (kernel, shape, basis) a call launched:
    byte-equal to their plain versions on random residues; their device
    time a launch in the call (dev_ms, from its trace; where the call was
    not traced, from a trace of the 10 launches below) and 10 launches
    back to back on these residues (with the host's issue), beside their
    bound."""
    from fhe_tpu_torch.lattice import rns
    gen = np.random.default_rng(SEED + 6)
    ops = {"ntt_forward_limbs": (rns.ntt_forward, rns.forward_plain),
           "ntt_inverse_limbs": (rns.ntt_inverse, rns.inverse_plain)}
    seen = {k: n for k, n in shapes.items() if k in LIMB_SHAPES_CHECKED}
    if seen:
        print(f"{tag} kernels 1-2 at {len(seen)} of the {call}'s {len(shapes)} shapes: checked "
              f"and timed above in this run ({sum(seen.values())} of its launches)")
    LIMB_SHAPES_CHECKED.update(shapes)
    for (kernel, shape, moduli), n in sorted(shapes.items()):
        if (kernel, shape, moduli) in seen:
            continue
        rows, L, N = shape
        plan = rns.make_rns_plan(N, moduli, dev)
        x = torch.stack([_residues(gen, q, (rows, N), dev) for q in moduli], dim=1)
        fn, plain = ops[kernel]
        errors.compare(kernel, fn(plan, x), plain(plan, x), f"{tag} {kernel} {list(shape)}",
                       show=False)
        ms = time_ms(lambda: [fn(plan, x) for _ in range(10)], reps=5) / 10
        p_ms = time_ms(lambda: plain(plan, x), reps=3)
        butterflies = N // 2 * (N.bit_length() - 1)
        muls = 3 * (butterflies + (N if "inverse" in kernel else 0)) * rows * L
        b_ms, b_by = bound(_nbytes(x, x, plan.fwd_w, plan.fwd_ws), muls, int_peak)
        d_ms, where = dev_ms.get((kernel, shape, moduli)), "the call's trace"
        if d_ms is None:
            one = functools.partial(fn, plan, x)
            d_ms = launch_ms(kernel_trace(one, 10), kernel, shape)
            where = "a trace of 10 launches"
            if d_ms is None:
                UNTRACED.append((f"{tag} {kernel} {list(shape)}", kernel, shape, b_ms, one))
        d_txt = (f"{d_ms:.4f} ms a launch on the device ({where}), at {b_ms / d_ms:.3f} of the "
                 f"bound" if d_ms else "device time not measured (no kernel in the trace; "
                 "timed again below)")
        print(f"{tag} {kernel} {list(shape)}: {d_txt}; {ms:.4f} ms a launch 10 back to back "
              f"(with the host's issue); plain {p_ms:.3f} ms; bound {b_ms:.4f} ms by {b_by}; "
              f"byte-equal to the plain version; {n} launches a {call}  ({card})")


def retrace_untraced(dev, card: str) -> None:
    """The device time of each launch in UNTRACED, from a new trace of 10
    launches (called where no other process traces the card); where that
    trace holds no kernel either, the CUDA-event time of one launch with a
    cold L2 (the card idle until the launch is enqueued)."""
    from fhe_tpu_torch.profile_ntt import FLUSH_WORDS, time_cold_ms
    flush = torch.empty(FLUSH_WORDS, dtype=torch.int32, device=dev) if UNTRACED else None
    for what, kernel, shape, b_ms, one in UNTRACED:
        ks = kernel_trace(one, 10)
        d_ms = launch_ms(ks, kernel, shape)
        where = "a new trace of 10 launches, no other process tracing"
        if d_ms is None:
            d_ms = time_cold_ms(one, 21, flush)
            held = sorted({(k["name"].split("(")[0][-48:], k["grid"]) for k in ks})[:4]
            where = (f"CUDA events, one launch, cold L2: none in a new trace either, which held "
                     f"{len(ks)} kernels: {held}")
        print(f"{what}: {d_ms:.4f} ms a launch on the device ({where}), at {b_ms / d_ms:.3f} of "
              f"the bound {b_ms:.4f} ms  ({card})")
    UNTRACED.clear()


def kernel_trace(fn, reps: int) -> list[dict]:
    """The device kernels of reps calls of fn() (warmed by the caller), from
    a torch.profiler (CUPTI) trace: name, grid and duration in us of each;
    [] where the trace holds none."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return trace_kernels(prof)


def trace_kernels(prof) -> list[dict]:
    """The device kernels of a finished torch.profiler trace (see
    kernel_trace)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/trace.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return [{"name": e.get("name", ""), "grid": tuple(e.get("args", {}).get("grid", ())),
             "us": float(e["dur"])} for e in events if e.get("cat") == "kernel" and "dur" in e]


def device_split(tag: str, what: str, fn, reps: int, wall_ms: float,
                 shapes: collections.Counter, card: str, ks: list | None = None) -> dict:
    """Prints one call of fn split, from kernel_trace (or the trace events
    ks of reps calls already taken), into kernels 1-2, the other kernels
    (the int64 glue) and the rest of its CUDA-event time wall_ms, where the
    card waits on the host; returns the limb kernels' median device ms a
    launch by (kernel, shape, basis) of `shapes`."""
    ks = kernel_trace(fn, reps) if ks is None else ks
    if not ks:
        print(f"{tag} {what}: {wall_ms:.3f} ms; the profiler trace holds no kernel: the device "
              f"split is not measured  ({card})")
        return {}
    limb = sum(k["us"] for k in ks if is_limb(k)) / reps / 1e3
    glue = sum(k["us"] for k in ks if not is_limb(k)) / reps / 1e3
    n_glue = sum(1 for k in ks if not is_limb(k)) / reps
    rest = wall_ms - limb - glue
    print(f"{tag} {what}: {wall_ms:.3f} ms (CUDA events); device time a call from a "
          f"torch.profiler trace of {reps} calls: kernels 1-2 {limb:.4f} ms ({limb / wall_ms:.3f})"
          f", the other {n_glue:g} kernels (the int64 glue) {glue:.4f} ms "
          f"({glue / wall_ms:.3f}), no kernel running {rest:.4f} ms ({rest / wall_ms:.3f})  "
          f"({card})")
    out = {}
    for kernel, shape, moduli in shapes:
        ms = launch_ms(ks, kernel, shape)
        if ms is not None:
            out[(kernel, shape, moduli)] = ms
    return out


def is_limb(k: dict) -> bool:
    """A trace event of kernels 1-2 over stacked limbs (at N = 2^16 the
    split kernels: csrc/ntt.cuh forward_half_kernel, inverse_half_kernel
    and inverse_stage_kernel)."""
    return any(stem in k["name"] for stem in ("_limbs_kernel", "_half_kernel", "stage_kernel"))


def launch_ms(ks: list, kernel: str, shape: tuple):
    """The median device ms of one launch of a limb-stacked wrapper at
    shape [rows, L, N] in the trace events ks (None where there is none):
    one kernel, found by its grid; at N = 2^16 the forward's half kernel,
    and the inverse's half kernel plus its stage kernel."""
    from fhe_tpu_torch.kernels import ntt as kntt
    rows, L, N = shape
    forward = kernel == "ntt_forward_limbs"
    if N == kntt.SPLIT_N:
        parts = [("forward_half_kernel" if forward else "inverse_half_kernel", (rows, L, 2))]
        if not forward:
            parts.append(("stage_kernel", (rows * L, N // 2 // 4 // 256, 1)))
    else:
        stem = ("forward" if forward else "inverse") + "_limbs_kernel"
        parts = [(stem, (-(-rows // kntt.rows_per_block(N)), L, 1))]
    total = 0.0
    for stem, grid in parts:
        us = [k["us"] for k in ks if stem in k["name"] and k["grid"] == grid]
        if not us:
            return None
        total += statistics.median(us) / 1e3
    return total


def ckks_phase(dev, errors: Errors, card: str) -> dict:
    """The [ckks] phase: CKKS bench config 3 keyed from SEED on the card;
    returns the launches of one counted mul_rescale."""
    from fhe_tpu_torch import kernels
    from fhe_tpu_torch.lattice.rns import RnsPoly
    from fhe_tpu_torch.pke import ckks
    t_phase = time.perf_counter()
    tag = "[ckks]"
    ctx = ckks.CkksContext.create(**CKKS_CONFIG, device=dev)
    p = ctx.params
    print(f"{tag} bench config 3: N = {p.N}, Q = {p.moduli} ({len(p.moduli)} limbs), P = "
          f"{p.special_mods}, dnum = {p.num_part_q}, {p.num_per_part} limbs a digit, scale "
          f"2^{p.scale_bits}")
    t0 = time.perf_counter()
    rng, sk, pk, evk, pevk, z, ct = ckks_keys(ctx, SEED)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    w = np.random.default_rng(SEED + 7).normal(size=p.N // 2)
    t0 = time.perf_counter()
    ops, ct2, z2 = ckks_ops(ctx, rng, sk, pk, ct, z, w)
    torch.cuda.synchronize()
    ops_s = time.perf_counter() - t0
    print(f"{tag} keygen + relin_key_gen + prepare_evk + encrypt on {dev}: {keygen_s:.3f} s; "
          f"rotation keys {CKKS_ROTS}, the conjugation key, a second encrypt and the ops: "
          f"{ops_s:.3f} s (host clock, with the host draws); evk {tuple(evk.b.shape)} x 2")

    # the counted run: one mul_rescale
    ctx.mul_rescale(ct, ct, pevk)                                  # warm
    out, launches, shapes = counted(tag, "mul_rescale", lambda: ctx.mul_rescale(ct, ct, pevk))

    ckks_values_close("mul_rescale(ct, ct) against z^2", ctx.decrypt(sk, out).real, z * z, 1e-2)
    ckks_same("mul + relinearize + rescale against mul_rescale",
              ctx.rescale(ctx.relinearize(ctx.mul(ct, ct), evk)), out)
    # fhe_tpu's tests/test_ckks.py bounds (N = 256) times N / 256: at a fixed
    # scale a fresh ciphertext's slot error grows with N (sqrt(N) in the
    # coefficients, sqrt(N) more in the embedding); add is exact on the
    # phases, so its error is at most the sum of its inputs'
    grow = p.N / 256
    fresh = [float(np.abs(ctx.decrypt(sk, c) - v).max()) for c, v in ((ct, z), (ct2, z2))]
    print(f"{tag} fresh ciphertexts' errors {fresh[0]:.3e}, {fresh[1]:.3e}")
    want = {f"rotate by {r}": (np.roll(z, -r), 1e-3 * grow) for r in CKKS_ROTS}
    want["conjugate"] = (np.conj(z + 1j * z2), 1e-3 * grow)
    want["add"] = (z + z2, sum(fresh) + 1e-9)
    want["mul_plain then rescale"] = (z * w, 1e-3 * grow)
    for op, got in ops.items():
        ckks_values_close(op, ctx.decrypt(sk, got), *want[op])

    t0 = time.perf_counter()
    cpu = ckks.CkksContext.create(**CKKS_CONFIG, device="cpu")
    cpu_rng, cpu_sk, cpu_pk, _, cpu_pevk, cpu_z, cpu_ct = ckks_keys(cpu, SEED)
    cpu_out = cpu.mul_rescale(cpu_ct, cpu_ct, cpu_pevk)
    cpu_ops, *_ = ckks_ops(cpu, cpu_rng, cpu_sk, cpu_pk, cpu_ct, cpu_z, w)
    cpu_s = time.perf_counter() - t0
    ckks_same(f"the card's mul_rescale against the CPU port's, same seed ({cpu_s:.1f} s on the "
              f"CPU with the ops below)", cpu_out, out)
    for op, got in ops.items():
        ckks_same(f"the card's {op} against the CPU port's", cpu_ops[op], got)

    # batch CKKS_BATCH: one ciphertext a row
    zs, cts = [z], [ct]
    for _ in range(CKKS_BATCH - 1):
        zs.append(rng.normal(size=p.N // 2) * 0.5)
        cts.append(ctx.encrypt(pk, zs[-1], rng))
    stack = lambda polys: RnsPoly(torch.stack([x.data for x in polys]), ct.c0.moduli,
                                  ct.c0.fmt)
    batch = ckks.Ciphertext(stack([c.c0 for c in cts]), stack([c.c1 for c in cts]), ct.scale)
    kernels.reset_launch_counts()
    with limb_launch_shapes() as batch_shapes:
        out_b = ctx.mul_rescale(batch, batch, pevk)
        torch.cuda.synchronize()
    batch_launches = kernels.launch_counts()
    row = lambda c, i: ckks.Ciphertext(RnsPoly(c.c0.data[i], c.c0.moduli, c.c0.fmt),
                                       RnsPoly(c.c1.data[i], c.c1.moduli, c.c1.fmt), c.scale)
    differ = []
    for i, c in enumerate(cts):
        single = ctx.mul_rescale(c, c, pevk)
        if not (torch.equal(single.c0.data, out_b.c0.data[i]) and
                torch.equal(single.c1.data, out_b.c1.data[i])):
            differ.append(i)
    if differ or out_b.scale != out.scale:
        fail(f"{tag} mul_rescale at batch {CKKS_BATCH}: rows {differ} differ from the single "
             f"mul_rescale of their ciphertext")
    print(f"{tag} every row of mul_rescale at batch {CKKS_BATCH} byte-equal to the single "
          f"mul_rescale of its ciphertext")
    ckks_values_close(f"every row of mul_rescale at batch {CKKS_BATCH} against its z_i^2",
                      np.stack([ctx.decrypt(sk, row(out_b, i)).real for i in range(CKKS_BATCH)]),
                      np.stack(zs) ** 2, 1e-2)

    # timings: CUDA events around the calls; the device split from a
    # torch.profiler trace of them
    int_peak = int_multiply_peak(dev)
    one_ms = time_ms(lambda: ctx.mul_rescale(ct, ct, pevk), reps=11)
    batch_ms = time_ms(lambda: ctx.mul_rescale(batch, batch, pevk), reps=5)
    dev_one = device_split(tag, "mul_rescale batch 1", lambda: ctx.mul_rescale(ct, ct, pevk),
                           11, one_ms, shapes, card)
    dev_b = device_split(tag, f"mul_rescale batch {CKKS_BATCH}",
                         lambda: ctx.mul_rescale(batch, batch, pevk), 5, batch_ms,
                         batch_shapes, card)
    limb_kernels_at(tag, "mul_rescale", dev, shapes, dev_one, errors, int_peak, card)
    limb_kernels_at(tag, "mul_rescale", dev, batch_shapes, dev_b, errors, int_peak, card)
    print(f"{tag} mul_rescale batch {CKKS_BATCH}: {batch_ms:.3f} ms = "
          f"{batch_ms / CKKS_BATCH:.4f} ms a ciphertext; launches {dict(batch_launches)}  "
          f"({card})")
    print(f"{tag} peak device memory so far: "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print(f"{tag} the phase took {time.perf_counter() - t_phase:.3f} s (host clock)")
    return {name: launches[name] for name in LIMB_KERNELS}


def pke_same(tag: str, what: str, a, b) -> None:
    """BFV or BGV ciphertexts a and b byte-equal, pt_scale too (BGV)."""
    comps = lambda c: [x for x in (c.c0, c.c1, c.c2) if x is not None]
    if (a.moduli != b.moduli or getattr(a, "pt_scale", 1) != getattr(b, "pt_scale", 1) or
            len(comps(a)) != len(comps(b)) or
            not all(torch.equal(x.data.cpu(), y.data.cpu()) for x, y in zip(comps(a), comps(b)))):
        fail(f"{tag} {what}: the ciphertexts differ")
    print(f"{tag} {what}: byte-equal ({len(a.moduli)} limbs)")


def pke_exact(tag: str, what: str, got, want) -> None:
    wrong = int((np.asarray(got) != np.asarray(want)).sum())
    print(f"{tag} {what}: {wrong} of {len(want)} slots wrong against numpy")
    if wrong:
        fail(f"{tag} {what}: {wrong} slots wrong")


def rotated_slots(m: np.ndarray, r: int) -> np.ndarray:
    """The packed slots after rotate(r): the automorphism 5^r moves the
    mod-t NTT's points, slot i taking slot j with 2j + 1 = (2i + 1) 5^r."""
    N = len(m)
    i = np.arange(N)
    return m[((2 * i + 1) * pow(5, r, 2 * N) % (2 * N) - 1) // 2]


def counted(tag: str, call: str, fn, limb_only: bool = True):
    """One call of fn with the launch counters reset before and read
    after: (its result, launches, (kernel, shape, basis) counts of the
    limb-stacked launches); with limb_only, fails unless it launched the
    limb-stacked kernels only, each at least once."""
    from fhe_tpu_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with limb_launch_shapes() as shapes:
        out = fn()
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if limb_only:
        others = {k: v for k, v in launches.items() if k not in LIMB_KERNELS and v}
        if others or not all(launches[k] for k in LIMB_KERNELS):
            fail(f"{tag} {call} launches {launches}: the limb-stacked kernels only, each at least "
                 f"once")
        print(f"{tag} {call} launches: {dict(launches)} (kernels 3-5 and the single-modulus NTTs:"
              f" 0)")
    else:
        print(f"{tag} {call} launches: { {k: v for k, v in launches.items() if v} }")
    for (kernel, shape, moduli), n in sorted(shapes.items()):
        print(f"{tag} {call}: {kernel} {list(shape)} x {n}")
    return out, launches, shapes


def bfv_keys(ctx, seed: int):
    """keygen, the relinearization key (HYBRID) and the encryption of m in
    [0, 100) (bench.py:299-300), from seed: the draws the card and the CPU
    both make."""
    rng = np.random.default_rng(seed)
    sk, pk = ctx.keygen(rng)
    evk = ctx.relin_key_gen(sk, rng)
    m = rng.integers(0, 100, size=ctx.params.N)
    return rng, sk, pk, evk, m, ctx.encrypt(pk, m, rng)


def slot_kernels(tag: str, dev, N: int, t: int, errors: Errors, int_peak: float,
                 card: str) -> None:
    """Kernels 1-2 at [1, N] with q = t, the packed encoding's NTTs:
    byte-equal to their plain versions, timed 10 back to back."""
    from fhe_tpu_torch.math import ntt
    plan = ntt.make_plan(N, t, dev)
    x = _residues(np.random.default_rng(SEED + 8), t, (1, N), dev)
    butterflies = N // 2 * plan.logN
    for name, kern, plain, muls in (
            ("ntt_inverse", ntt.ntt_inverse, ntt.inverse_butterfly, 3 * (butterflies + N)),
            ("ntt_forward", ntt.ntt_forward, ntt.forward_butterfly, 3 * butterflies)):
        errors.compare(name, kern(plan, x), plain(plan, x), f"{tag} {name} [1, {N}] q = t = {t}",
                       show=False)
        ms = time_ms(lambda: [kern(plan, x) for _ in range(10)], reps=5) / 10
        p_ms = time_ms(lambda: plain(plan, x), reps=3)
        b_ms, b_by = bound(_nbytes(x, x, plan.fwd_w, plan.fwd_ws), muls, int_peak)
        print(f"{tag} {name} [1, {N}] q = t: byte-equal to the plain version; {ms:.4f} ms a "
              f"launch 10 back to back (with the host's issue); plain {p_ms:.3f} ms; bound "
              f"{b_ms:.4f} ms by {b_by}; 1 launch {'an encode' if kern is ntt.ntt_inverse else 'a decode'}"
              f"  ({card})")


def bfv_phase(dev, errors: Errors, card: str) -> dict:
    """The [bfv] phase: BFV bench config 4 keyed from SEED on the card;
    returns the launches of one counted mul."""
    from fhe_tpu_torch import kernels
    from fhe_tpu_torch.pke import bfv, rlwe
    t_phase = time.perf_counter()
    tag = "[bfv]"
    ctx = bfv.BfvContext.create(**BFV_CONFIG, device=dev)
    p, t = ctx.params, ctx.t
    N = p.N
    print(f"{tag} bench config 4: N = {N}, Q = {p.moduli}, P = {p.special_mods}, R = "
          f"{bfv.aux_basis(p)}, t = {t}, dnum = {p.num_part_q}; HPS, HYBRID relinearization")
    t0 = time.perf_counter()
    rng, sk, pk, evk, m, ct = bfv_keys(ctx, SEED)
    pevk = rlwe.prepare_evk(p, evk)
    torch.cuda.synchronize()
    print(f"{tag} keygen + relin_key_gen + encrypt on {dev}: {time.perf_counter() - t0:.3f} s "
          f"(host clock, with the host draws); evk {tuple(evk.b.shape)} x 2")

    # the counted run: one mul(ct, ct, evk)
    ctx.mul(ct, ct, pevk)                                           # warm
    out, launches, shapes = counted(tag, "mul", lambda: ctx.mul(ct, ct, pevk))
    pke_exact(tag, "mul(ct, ct, evk), HPS, against m^2 mod t", ctx.decrypt(sk, out), m * m % t)
    behz = ctx.mul(ct, ct, pevk, technique="behz")
    pke_exact(tag, "mul(ct, ct, evk), BEHZ, against m^2 mod t", ctx.decrypt(sk, behz), m * m % t)
    kernels.reset_launch_counts()
    ctx.make_plaintext(m)
    enc = kernels.launch_counts()
    if (enc["ntt_inverse"], enc["ntt_forward_limbs"]) != (1, 1) or sum(enc.values()) != 2:
        fail(f"{tag} make_plaintext launches {enc}: the encode's inverse NTT and one forward")
    print(f"{tag} make_plaintext (packed encoding, x Delta, to EVAL) launches: {dict(enc)}")

    # the ops, from the same generator: rotation keys, more ciphertexts
    rot_h = ctx.rotation_key_gen(sk, [1], rng)
    rot_bv = ctx.rotation_key_gen(sk, [1], rng, method="bv")
    ms = [m] + [rng.integers(0, t, size=N) for _ in range(3)]
    cts = [ct] + [ctx.encrypt(pk, x, rng) for x in ms[1:]]
    ws = [rng.integers(0, t, size=N) for _ in range(4)]
    want = {"add": (ctx.add(cts[0], cts[1]), (ms[0] + ms[1]) % t),
            "mul_plain": (ctx.mul_plain(cts[1], ws[0]), ms[1] * ws[0] % t),
            "rotate by 1, HYBRID key": (ctx.rotate(cts[1], 1, rot_h), rotated_slots(ms[1], 1)),
            "rotate by 1, BV key": (ctx.rotate(cts[1], 1, rot_bv), rotated_slots(ms[1], 1)),
            "dot_product of 4": (ctx.dot_product(cts, ws),
                                 sum(x * w % t for x, w in zip(ms, ws)) % t)}
    for op, (got, values) in want.items():
        pke_exact(tag, op, ctx.decrypt(sk, got), values)

    t0 = time.perf_counter()
    cpu = bfv.BfvContext.create(**BFV_CONFIG, device="cpu")
    _, _, _, cpu_evk, _, cpu_ct = bfv_keys(cpu, SEED)
    cpu_out = cpu.mul(cpu_ct, cpu_ct, cpu_evk)
    cpu_behz = cpu.mul(cpu_ct, cpu_ct, cpu_evk, technique="behz")
    cpu_s = time.perf_counter() - t0
    pke_same(tag, f"the card's mul (HPS) against the CPU port's, same seed ({cpu_s:.1f} s on the "
             f"CPU with the keys)", cpu_out, out)
    pke_same(tag, "the card's mul (BEHZ) against the CPU port's", cpu_behz, behz)

    # timings: CUDA events around the calls; the device split from a
    # torch.profiler trace of them
    int_peak = int_multiply_peak(dev)
    one_ms = time_ms(lambda: ctx.mul(ct, ct, pevk), reps=11)
    behz_ms = time_ms(lambda: ctx.mul(ct, ct, pevk, technique="behz"), reps=11)
    dev_one = device_split(tag, "mul batch 1 (HPS)", lambda: ctx.mul(ct, ct, pevk), 11, one_ms,
                           shapes, card)
    limb_kernels_at(tag, "mul", dev, shapes, dev_one, errors, int_peak, card)
    slot_kernels(tag, dev, N, t, errors, int_peak, card)
    print(f"{tag} mul (HPS) batch 1: {one_ms:.3f} ms, BEHZ {behz_ms:.3f} ms (CUDA events, median "
          f"of 11); the C++ reference's BFVrns MultRelin on an M1 Max CPU: "
          f"{BFV_REFERENCE_CPU_MS} ms (BASELINE.md:24, not a target)  ({card})")
    print(f"{tag} the phase took {time.perf_counter() - t_phase:.3f} s (host clock)")
    return {name: launches[name] for name in LIMB_KERNELS}


def bgv_keys(ctx, seed: int):
    """keygen, the relinearization and rotation keys (noise x t) and the
    ciphertexts of m1, m2 in [0, t), from seed."""
    rng = np.random.default_rng(seed)
    sk, pk = ctx.keygen(rng)
    evk = ctx.relin_key_gen(sk, rng)
    rot = ctx.rotation_key_gen(sk, [1], rng)
    ms = rng.integers(0, ctx.t, size=(3, ctx.params.N))
    return sk, evk, rot, ms, [ctx.encrypt(pk, x, rng) for x in ms[:2]]


def bgv_ops(ctx, evk, rot, ms, cts) -> dict:
    """{op: (ciphertext, its slots)}: the product, mod_reduce twice, add of
    a fresh ciphertext to the twice-reduced product (4 and 2 limbs, other
    pt_scale), rotate and mul_plain."""
    t = ctx.t
    m1, m2, w = ms
    sq = m1 * m2 % t
    prod = ctx.mul(cts[0], cts[1], evk)
    red1 = ctx.mod_reduce(prod)
    red2 = ctx.mod_reduce(red1)
    return {"mul + relinearize": (prod, sq), "mod_reduce once": (red1, sq),
            "mod_reduce twice": (red2, sq),
            f"add at {len(cts[0].moduli)} and {len(red2.moduli)} limbs, pt_scale 1 and "
            f"{red2.pt_scale}": (ctx.add(cts[0], red2), (m1 + sq) % t),
            "rotate by 1": (ctx.rotate(cts[0], 1, rot), rotated_slots(m1, 1)),
            "mul_plain after a mod_reduce": (ctx.mul_plain(red1, w), sq * w % t)}


def bgv_phase(dev, errors: Errors, card: str) -> dict:
    """The [bgv] phase: BGV at N = 2^15 keyed from SEED on the card;
    returns the launches of one counted mul + relinearize."""
    from fhe_tpu_torch.pke import bgv
    t_phase = time.perf_counter()
    tag = "[bgv]"
    ctx = bgv.BgvContext.create(**BGV_CONFIG, device=dev)
    p = ctx.params
    print(f"{tag} N = {p.N}, Q = {p.moduli}, P = {p.special_mods}, t = {ctx.t}, dnum = "
          f"{p.num_part_q}")
    sk, evk, rot, ms, cts = bgv_keys(ctx, SEED + 12)
    ctx.mul(cts[0], cts[1], evk)                                    # warm
    _, launches, shapes = counted(tag, "mul + relinearize", lambda: ctx.mul(cts[0], cts[1], evk))
    ops = bgv_ops(ctx, evk, rot, ms, cts)
    for op, (got, values) in ops.items():
        pke_exact(tag, op, ctx.decrypt(sk, got), values)
    t0 = time.perf_counter()
    cpu = bgv.BgvContext.create(**BGV_CONFIG, device="cpu")
    cpu_ops = bgv_ops(cpu, *bgv_keys(cpu, SEED + 12)[1:])
    cpu_s = time.perf_counter() - t0
    for op, (got, _) in ops.items():
        pke_same(tag, f"the card's {op} against the CPU port's", cpu_ops[op][0], got)
    print(f"{tag} the CPU port's keys and ops, same seed: {cpu_s:.1f} s")
    mul_ms = time_ms(lambda: ctx.mul(cts[0], cts[1], evk), reps=11)
    int_peak = int_multiply_peak(dev)
    dev_ms = device_split(tag, "mul + relinearize batch 1", lambda: ctx.mul(cts[0], cts[1], evk),
                          11, mul_ms, shapes, card)
    limb_kernels_at(tag, "mul + relinearize", dev, shapes, dev_ms, errors, int_peak, card)
    print(f"{tag} the phase took {time.perf_counter() - t_phase:.3f} s (host clock)")
    return {name: launches[name] for name in LIMB_KERNELS}


def decode_phase(ctx, ph, scale: float) -> np.ndarray:
    """The real slots of a fused COEFF phase (a threshold decryption)."""
    from fhe_tpu_torch.lattice import rns
    from fhe_tpu_torch.pke import ckks
    m = ckks._center(rns.to_bigint(ph), rns.modulus_product(ph.moduli))
    return ckks.decode(m, ctx.params.N, scale).real


def protocol_decrypt(params, sks, ct, rng):
    """decrypt_lead, a decrypt_main a party, fuse: the fused COEFF phase."""
    from fhe_tpu_torch.pke import multiparty
    lead = multiparty.decrypt_lead(params, sks[0], ct.c0, ct.c1, rng)
    return multiparty.fuse([lead] + [multiparty.decrypt_main(params, sk, ct.c1, rng)
                                     for sk in sks[1:]])


def flood_bound(N: int, parties: int, scale: float) -> float:
    """bench.py:344-345: 5 sigma_slot, sigma_slot = MP_SD sqrt(parties N) / scale."""
    from fhe_tpu_torch.pke import multiparty
    return 5 * multiparty.MP_SD * math.sqrt(parties * N) / scale


def exact_decrypt(params, sks, ct):
    """The threshold decryption with every flood at 0: the fusion of the
    shares s_i c1 (+ c0), which is the decryption under the joint secret."""
    from fhe_tpu_torch.lattice import rns
    from fhe_tpu_torch.pke import multiparty
    mods = tuple(ct.moduli)
    s_stack = torch.stack([sk.eval_poly(mods).data for sk in sks])
    zero = torch.zeros(len(sks), params.N, dtype=torch.int64, device=ct.c0.data.device)
    return rns.RnsPoly(multiparty._pipeline(mods, 1, s_stack, ct.c0.data, ct.c1.data, zero), mods,
                       rns.COEFF)


def mp_keys(ctx, seed: int):
    """bench.py:328-331: the 5-party joint keys and the encryption of z
    (normal over the N/2 slots) from seed."""
    from fhe_tpu_torch.pke import multiparty
    rng = np.random.default_rng(seed)
    sks, pk = multiparty.multiparty_keygen(ctx.params, MP_PARTIES, rng, device=ctx.device)
    z = rng.normal(size=ctx.params.N // 2)
    return rng, sks, pk, z, ctx.encrypt(pk, z, rng)


def zero_flood_shares(ctx, sks, ct) -> list:
    """Each party's share with the flood at 0, and the pipeline's fusion at
    flood 0: the ring data the card and the CPU must agree on."""
    from fhe_tpu_torch.pke import multiparty
    mods = tuple(ct.moduli)
    zero = torch.zeros(ctx.params.N, dtype=torch.int64, device=ct.c0.data.device)
    out = [multiparty._share(mods, 1, i == 0, sk.eval_poly(mods).data, ct.c1.data, ct.c0.data,
                             zero) for i, sk in enumerate(sks)]
    return out + [exact_decrypt(ctx.params, sks, ct).data]


def joint_relin_key(params, sks, rng):
    """threshold-fhe.cpp's rounds for every party: MultiKeySwitchGen over the
    first party's a, MultiAddEvalKeys, MultiMultEvalKey, MultiAddEvalMultKeys."""
    from fhe_tpu_torch.pke import multiparty, rlwe
    mods = tuple(params.moduli)
    first = rlwe.evk_gen(params, sks[0].eval_poly(mods), sks[0], rng)
    joint = first
    for sk in sks[1:]:
        joint = multiparty.multi_add_eval_keys(joint, multiparty.multi_key_switch_gen(
            params, sk.eval_poly(mods), sk, first, rng))
    rlk = None
    for sk in sks:
        share = multiparty.multi_mult_eval_key(params, joint, sk, rng)
        rlk = share if rlk is None else multiparty.multi_add_eval_mult_keys(rlk, share)
    return rlk


def joint_rotation_key(params, sks, r: int, rng) -> dict:
    """MultiEvalAtIndexKeyGen over the first party's key, summed over the
    parties (MultiAddEvalAutomorphismKeys)."""
    from fhe_tpu_torch.lattice import rns
    from fhe_tpu_torch.pke import multiparty, rlwe
    mods = tuple(params.moduli)
    k = pow(5, r % (2 * params.N), 2 * params.N)
    first = {r: rlwe.evk_gen(params, rns.automorphism(sks[0].eval_poly(mods), k), sks[0], rng)}
    joint = first
    for sk in sks[1:]:
        joint = multiparty.multi_add_eval_automorphism_keys(
            joint, multiparty.multi_eval_automorphism_key_gen(params, sk, first, {r: k}, rng))
    return joint


def mp_joint(tag: str, ctx, sks, pk, rng) -> None:
    """A joint relinearization key and a joint rotation key from all
    parties; mul + relinearize + rescale and rotate by 1 under them,
    decrypted by the threshold pipeline (within the flood's 5 sigma_slot)
    and at flood 0 (the joint secret's decryption: within [ckks]'s z^2 and
    rotate bounds; the 2^20 flood alone is ~0.28 a slot here)."""
    from fhe_tpu_torch.pke import multiparty
    p = ctx.params
    t0 = time.perf_counter()
    rlk = joint_relin_key(p, sks, rng)
    rot = joint_rotation_key(p, sks, 1, rng)
    print(f"{tag} joint relinearization key ({len(sks)} parties: MultiKeySwitchGen, "
          f"MultiAddEvalKeys, MultiMultEvalKey, MultiAddEvalMultKeys) and joint rotation key "
          f"(index 1): {time.perf_counter() - t0:.3f} s (host clock, with the host draws)")
    z1, z2 = rng.normal(size=p.N // 2) * 0.5, rng.normal(size=p.N // 2) * 0.5
    ct1, ct2 = ctx.encrypt(pk, z1, rng), ctx.encrypt(pk, z2, rng)
    grow = p.N / 256
    for what, out, want, tol in (
            ("mul + relinearize + rescale under the joint key", ctx.rescale(ctx.mul(ct1, ct2, rlk)),
             z1 * z2, 1e-2),
            ("rotate by 1 under the joint key", ctx.rotate(ct1, 1, rot), np.roll(z1, -1),
             1e-3 * grow)):
        ph = multiparty.threshold_decrypt_pipeline(p, sks, out.c0, out.c1, rng)
        ckks_values_close(f"{what}, threshold_decrypt_pipeline", decode_phase(ctx, ph, out.scale),
                          want, flood_bound(p.N, len(sks), out.scale), tag)
        ckks_values_close(f"{what}, flood 0 (the joint secret)",
                          decode_phase(ctx, exact_decrypt(p, sks, out), out.scale), want, tol, tag)


def mp_boot(tag: str, dev) -> None:
    """IntBoot (2 parties) and IntMPBoot at N = 2^12 with the levels of
    tests/test_multiparty.py:139,160, decrypted by the 2-party threshold
    decrypt within fhe_tpu's 1.2 x N/256 (the flood: 2^20 at scale 2^26),
    and at flood 0 (the joint secret) within [ckks]'s fresh-ciphertext
    bound, 1e-3 x N/256."""
    from fhe_tpu_torch.pke import ckks, multiparty
    ctx = ckks.CkksContext.create(**MP_BOOT_CONFIG, device=dev)
    p = ctx.params
    rng = np.random.default_rng(SEED + 20)
    t0 = time.perf_counter()
    sks, pk = multiparty.multiparty_keygen(p, 2, rng, device=dev)
    z = rng.normal(size=p.N // 2) * 0.5
    ct = ctx.encrypt(pk, z, rng)
    low = multiparty.int_boot_adjust_scale(ctx, ct, extra_limbs=1)
    h1 = multiparty.int_boot_decrypt(p, sks[0], low.c0, low.c1)
    h2 = multiparty.int_boot_decrypt(p, sks[1], low.c1)
    boot = multiparty.int_boot_add(p, multiparty.int_boot_encrypt(p, pk, h2, low, rng), h1)
    low_mp = multiparty.int_boot_adjust_scale(ctx, ct)
    a = multiparty.int_mp_boot_random_gen(p, rng, device=dev)
    agg = multiparty.int_mp_boot_add([multiparty.int_mp_boot_decrypt(p, sk, low_mp, a, rng)
                                      for sk in sks])
    mp_boot_out = multiparty.int_mp_boot_encrypt(p, low_mp, agg, a)
    torch.cuda.synchronize()
    print(f"{tag} IntBoot and IntMPBoot at N = {p.N}, Q {len(p.moduli)} limbs, scale "
          f"2^{p.scale_bits}: keys, {len(low.moduli)}- and {len(low_mp.moduli)}-limb compressions, "
          f"shares and refreshes {time.perf_counter() - t0:.3f} s (host clock)")
    for what, out in (("IntBoot (2 parties)", boot), ("IntMPBoot (2 parties)", mp_boot_out)):
        if out.moduli != tuple(p.moduli):
            fail(f"{tag} {what}: refreshed to {len(out.moduli)} limbs, not the full chain")
        ph = protocol_decrypt(p, sks, out, rng)
        ckks_values_close(f"{what}, threshold decrypt", decode_phase(ctx, ph, out.scale), z,
                          1.2 * p.N / 256, tag)
        ckks_values_close(f"{what}, flood 0 (the joint secret)",
                          decode_phase(ctx, exact_decrypt(p, sks, out), out.scale), z,
                          1e-3 * p.N / 256, tag)


def mp_bgv(tag: str, dev) -> None:
    """BGV 5-party threshold decrypt on the [bgv] ring
    (tests/test_multiparty.py:56's flow at full width): 0 wrong slots,
    through the protocol form and the pipeline."""
    from fhe_tpu_torch.lattice import rns
    from fhe_tpu_torch.pke import bgv, multiparty
    ctx = bgv.BgvContext.create(**BGV_CONFIG, device=dev)
    p, t = ctx.params, ctx.t
    rng = np.random.default_rng(SEED + 21)
    sks, pk = multiparty.multiparty_keygen(p, MP_PARTIES, rng, device=dev)
    m = rng.integers(0, t, size=p.N)
    ct = ctx.encrypt(pk, m, rng)
    Q = rns.modulus_product(ct.moduli)
    for what, ph in (("protocol form", protocol_decrypt(p, sks, ct, rng)),
                     ("threshold_decrypt_pipeline",
                      multiparty.threshold_decrypt_pipeline(p, sks, ct.c0, ct.c1, rng))):
        got = bgv.decode(bgv.plain_coeffs(rns.to_bigint(ph), Q, t), t, p.N, device=dev)
        pke_exact(tag, f"BGV {MP_PARTIES}-party threshold decrypt, {what}, N = {p.N}, "
                  f"{len(ct.moduli)} limbs", got, m)


def mp_phase(dev, errors: Errors, card: str) -> dict:
    """The [mp] phase: bench config 5's threshold decrypt (N = 2^12, 5
    parties) on the card; returns the launches of one counted
    threshold_decrypt_pipeline."""
    from fhe_tpu_torch.lattice import rns
    from fhe_tpu_torch.pke import ckks, multiparty
    t_phase = time.perf_counter()
    tag = "[mp]"
    with limb_launch_shapes() as phase_shapes:
        ctx = ckks.CkksContext.create(**MP_CONFIG, device=dev)
        p = ctx.params
        print(f"{tag} bench config 5: N = {p.N}, Q = {p.moduli}, P = {p.special_mods}, dnum = "
              f"{p.num_part_q}, scale 2^{p.scale_bits}, {MP_PARTIES} parties")
        t0 = time.perf_counter()
        rng, sks, pk, z, ct = mp_keys(ctx, 3)
        torch.cuda.synchronize()
        print(f"{tag} multiparty_keygen + encrypt on {dev}: {time.perf_counter() - t0:.3f} s "
              f"(host clock, with the host draws)")
        bound5 = flood_bound(p.N, MP_PARTIES, ct.scale)
        ckks_values_close("protocol form (decrypt_lead, 4 decrypt_main, fuse)",
                          decode_phase(ctx, protocol_decrypt(p, sks, ct, np.random.default_rng(4)),
                                       ct.scale), z, bound5, tag)
        pipe_rng = np.random.default_rng(5)                             # bench.py:339
        pipe = lambda: multiparty.threshold_decrypt_pipeline(p, sks, ct.c0, ct.c1, pipe_rng)
        pipe()                                                          # warm
        ph, launches, shapes = counted(tag, "threshold_decrypt_pipeline", pipe)
        ckks_values_close("threshold_decrypt_pipeline", decode_phase(ctx, ph, ct.scale), z, bound5,
                          tag)

        # the same deviates through the pipeline and through each share
        mods = tuple(ct.moduli)
        s_stack = torch.stack([sk.eval_poly(mods).data for sk in sks])
        e = multiparty._flood(int(np.random.default_rng(6).integers(1 << 62)), (MP_PARTIES, p.N),
                              multiparty.MP_SD, dev)
        whole = multiparty._pipeline(mods, 1, s_stack, ct.c0.data, ct.c1.data, e)
        parts = [multiparty.PartialDecryption(
            rns.RnsPoly(multiparty._share(mods, 1, i == 0, s_stack[i], ct.c1.data, ct.c0.data,
                                          e[i]), mods, rns.EVAL), i == 0)
            for i in range(MP_PARTIES)]
        if not torch.equal(multiparty.fuse(parts).data, whole):
            fail(f"{tag} the pipeline differs from the fusion of the shares on the same deviates")
        print(f"{tag} threshold_decrypt_pipeline byte-equal to decrypt_lead / decrypt_main's "
              f"shares fused, on the same deviates")
        sd = float(e.double().std())
        print(f"{tag} flood deviates: sample standard deviation {sd:.1f} over "
              f"{e.numel()} draws = {sd / multiparty.MP_SD:.5f} x 2^20 (within 0.02 of 1)")
        if not abs(sd / multiparty.MP_SD - 1) < 0.02:
            fail(f"{tag} the flood's standard deviation {sd} is not within 2 % of 2^20")

        mp_joint(tag, ctx, sks, pk, rng)
        mp_boot(tag, dev)
        mp_bgv(tag, dev)

        t0 = time.perf_counter()
        card_shares = zero_flood_shares(ctx, sks, ct)
        cpu = ckks.CkksContext.create(**MP_CONFIG, device="cpu")
        _, cpu_sks, _, _, cpu_ct = mp_keys(cpu, 3)
        for i, (got, want) in enumerate(zip(card_shares, zero_flood_shares(cpu, cpu_sks, cpu_ct))):
            if not torch.equal(got.cpu(), want):
                fail(f"{tag} share {i} at flood 0 differs between the card and the CPU port")
        print(f"{tag} the {MP_PARTIES} shares and their fusion at flood 0: the card's byte-equal "
              f"to the CPU port's, same seed ({time.perf_counter() - t0:.1f} s with the CPU keys)")

    int_peak = int_multiply_peak(dev)
    one_ms = time_ms(pipe, reps=11)
    dev_ms = device_split(tag, "threshold_decrypt_pipeline batch 1", pipe, 11, one_ms, shapes,
                          card)
    print(f"{tag} threshold_decrypt_pipeline ({MP_PARTIES} parties, N = {p.N}) batch 1: "
          f"{one_ms:.3f} ms (CUDA events, median of 11); the C++ reference's 3-of-5 combine "
          f"on an EPYC 7763 core: ~{MP_REFERENCE_CPU_MS:g} ms (BASELINE.md:14, not a "
          f"target)  ({card})")
    limb_kernels_at(tag, "[mp] phase", dev, phase_shapes, dev_ms, errors, int_peak, card)
    print(f"{tag} the phase took {time.perf_counter() - t_phase:.3f} s (host clock)")
    return {name: launches[name] for name in LIMB_KERNELS}


def adv_keys(ctx, seed: int):
    """keygen, the relinearization key, EvalSum's rotation keys (1, 2, ...,
    N/4) and z uniform in [-4, 4) with its encryption, from seed: the
    draws the card and the CPU both make."""
    from fhe_tpu_torch.pke import advanced
    rng = np.random.default_rng(seed)
    sk, pk = ctx.keygen(rng)
    evk = ctx.relin_key_gen(sk, rng)
    sum_keys = advanced.sum_key_gen(ctx, sk, rng)
    z = rng.uniform(-4, 4, size=ctx.params.N // 2)
    return rng, sk, pk, evk, sum_keys, z, ctx.encrypt(pk, z, rng)


def levels_needed(ctx, degree: int) -> int:
    """The rescales eval_logistic at `degree` takes: run at N = 2^10 on the
    CPU, on a chain 4 levels longer than ctx's."""
    from fhe_tpu_torch.pke import advanced, ckks
    c = ckks.CkksContext.create(N=1 << 10, num_levels=len(ctx.params.moduli) + 3,
                                scale_bits=ctx.params.scale_bits,
                                dnum=ctx.params.num_part_q, device="cpu")
    rng = np.random.default_rng(0)
    sk, pk = c.keygen(rng)
    out = advanced.eval_logistic(c, c.encrypt(pk, np.zeros(1), rng), ADV_LOGISTIC[0],
                                 ADV_LOGISTIC[1], degree, c.relin_key_gen(sk, rng))
    return len(c.params.moduli) - len(out.moduli)


def adv_phase(dev, errors: Errors, card: str) -> dict:
    """The [adv] phase: advanced SHE at bench config 3 on the card; returns
    the launches of a counted eval_sum and eval_logistic."""
    from fhe_tpu_torch.pke import advanced, ckks
    t_phase = time.perf_counter()
    tag = "[adv]"
    ctx = ckks.CkksContext.create(**CKKS_CONFIG, device=dev)
    p = ctx.params
    slots = p.N // 2
    grow = p.N / 256
    degree = ADV_LOGISTIC[2]
    need = levels_needed(ctx, degree)
    while need > len(p.moduli) - 1:
        print(f"{tag} eval_logistic at degree {degree} needs {need} levels, bench config 3 has "
              f"{len(p.moduli) - 1}")
        degree -= 1
        need = levels_needed(ctx, degree)
    logistic = (ADV_LOGISTIC[0], ADV_LOGISTIC[1], degree)
    print(f"{tag} bench config 3 (N = {p.N}, {len(p.moduli)} limbs); eval_logistic on "
          f"[{logistic[0]:g}, {logistic[1]:g}] at degree {degree}: {need} levels")
    with limb_launch_shapes() as phase_shapes:
        t0 = time.perf_counter()
        rng, sk, pk, evk, sum_keys, z, ct = adv_keys(ctx, SEED + 30)
        lt_keys = ctx.rotation_key_gen(sk, [slots - 1], rng)
        merge_keys = advanced.merge_key_gen(ctx, sk, rng, 4)
        zs = [rng.normal(size=slots) * 0.3 for _ in range(4)]
        cts = [ctx.encrypt(pk, x, rng) for x in zs]
        torch.cuda.synchronize()
        print(f"{tag} keygen, relin key, {len(sum_keys)} EvalSum rotation keys, the linear "
              f"transform's and EvalMerge's {1 + len(merge_keys)}, 5 encryptions on {dev}: "
              f"{time.perf_counter() - t0:.3f} s (host clock, with the host draws)")

        advanced.eval_sum(ctx, ct, slots, sum_keys)                     # warm
        s_out, s_launches, s_shapes = counted(tag, "eval_sum", lambda: advanced.eval_sum(
            ctx, ct, slots, sum_keys))
        l_out, l_launches, l_shapes = counted(tag, "eval_logistic", lambda: advanced.eval_logistic(
            ctx, ct, *logistic, evk))
        band = np.zeros((slots, slots))
        rows = np.arange(slots)
        for d, w in ((0, 1.0), (1, 0.5), (-1, -0.25)):
            band[rows, (rows + d) % slots] = w
        ws = [0.5, -1.25, 2.0, 0.75]
        rot_keys = {**sum_keys, **lt_keys}
        ops = {  # op: (ciphertext, expected slots, fhe_tpu's test bound at N = 256)
            f"eval_sum over {slots} slots ({len(sum_keys)} rotations)":
                (s_out, np.full(slots, z.sum()), 1e-2),
            f"eval_logistic on [{logistic[0]:g}, {logistic[1]:g}], degree {degree}":
                (l_out, 1 / (1 + np.exp(-z)), 2e-2),
            "eval_inner_product": (advanced.eval_inner_product(
                ctx, cts[0], cts[1], slots, evk, sum_keys), np.full(slots, zs[0] @ zs[1]), 5e-2),
            "eval_linear_wsum of 4": (advanced.eval_linear_wsum(ctx, cts, ws),
                                      sum(w * x for w, x in zip(ws, zs)), 1e-2),
            "eval_merge of 4": (advanced.eval_merge(ctx, cts, merge_keys),
                                np.concatenate([[x[0] for x in zs], np.zeros(slots - 4)]), 1e-2),
            f"eval_linear_transform, banded {slots} x {slots} (diagonals 0, +1, -1)":
                (advanced.eval_linear_transform(ctx, cts[0], band, rot_keys), band @ zs[0], 1e-2),
            "compress to one tower": (advanced.compress(ctx, cts[1], 1), zs[1], 1e-2)}
        for op, (got, want, tol) in ops.items():
            ckks_values_close(f"{op} (tolerance fhe_tpu's {tol:g} x N/256)",
                              ctx.decrypt(sk, got).real, want, tol * grow, tag)

        t0 = time.perf_counter()
        cpu = ckks.CkksContext.create(**CKKS_CONFIG, device="cpu")
        _, _, _, cpu_evk, cpu_sum_keys, _, cpu_ct = adv_keys(cpu, SEED + 30)
        cpu_ops = (advanced.eval_sum(cpu, cpu_ct, slots, cpu_sum_keys),
                   advanced.eval_logistic(cpu, cpu_ct, *logistic, cpu_evk))
        for what, got, want in zip(("eval_sum", "eval_logistic"), (s_out, l_out), cpu_ops):
            ckks_same(f"the card's {what} against the CPU port's, same seed", want, got, tag)
        print(f"{tag} the CPU port's keys, eval_sum and eval_logistic: "
              f"{time.perf_counter() - t0:.1f} s")
        inner = lambda: advanced.eval_inner_product(ctx, cts[0], cts[1], slots, evk, sum_keys)
        _, _, i_shapes = counted(tag, "eval_inner_product", inner)

    int_peak = int_multiply_peak(dev)
    dev_ms = {}
    for what, fn, shp in (
            ("eval_logistic", lambda: advanced.eval_logistic(ctx, ct, *logistic, evk), l_shapes),
            ("eval_inner_product", inner, i_shapes)):
        ms = time_ms(fn, reps=5)
        dev_ms.update(device_split(tag, f"{what} batch 1", fn, 5, ms, shp, card))
        print(f"{tag} {what} batch 1: {ms:.3f} ms (CUDA events, median of 5)  ({card})")
    limb_kernels_at(tag, "[adv] phase", dev, phase_shapes, dev_ms, errors, int_peak, card)
    print(f"{tag} the phase took {time.perf_counter() - t_phase:.3f} s (host clock)")
    return {name: s_launches[name] + l_launches[name] for name in LIMB_KERNELS}


def pre_ckks(ctx, seed: int):
    """Alice's and Bob's keys, z and its encryption under Alice's key, the
    re-encryption key and the re-encryption re-randomized under Bob's
    public key, from seed: (sk_a, sk_b, z, ct, the key, (c0, c1))."""
    from fhe_tpu_torch.pke import pre
    rng = np.random.default_rng(seed)
    sk_a, pk_a = ctx.keygen(rng)
    sk_b, pk_b = ctx.keygen(rng)
    z = rng.normal(size=ctx.params.N // 2)
    ct = ctx.encrypt(pk_a, z, rng)
    rk = pre.re_key_gen(ctx.params, sk_a, sk_b, rng)
    return sk_a, sk_b, z, ct, (lambda: pre.re_encrypt(ctx.params, rk, ct.c0, ct.c1, rng, pk_b))


def pre_phase(dev, errors: Errors, card: str) -> dict:
    """The [pre] phase: proxy re-encryption on the card, CKKS at bench config
    3 and BGV on the [bgv] ring; returns the launches of one counted CKKS
    re_encrypt."""
    from fhe_tpu_torch.lattice import rns
    from fhe_tpu_torch.pke import bgv, ckks, pre
    t_phase = time.perf_counter()
    tag = "[pre]"
    with limb_launch_shapes() as phase_shapes:
        ctx = ckks.CkksContext.create(**CKKS_CONFIG, device=dev)
        sk_a, sk_b, z, ct, hop = pre_ckks(ctx, SEED + 40)
        hop()                                                           # warm (draws too)
        (c0, c1), launches, shapes = counted(tag, "re_encrypt (CKKS, HYBRID, re-randomized)", hop)
        out = ckks.Ciphertext(c0, c1, ct.scale)
        ckks_values_close("CKKS re-encrypted to Bob, Bob's decryption (tolerance fhe_tpu's 1e-2 "
                          "x N/256)", ctx.decrypt(sk_b, out).real, z, 1e-2 * ctx.params.N / 256,
                          tag)
        bad = float(np.abs(ctx.decrypt(sk_a, out).real - z).max())
        print(f"{tag} Alice's key on the re-encryption: max error {bad:.3e} (must exceed 0.1)")
        if not bad > 0.1:
            fail(f"{tag} Alice's key still decrypts the re-encrypted ciphertext")
        cpu = ckks.CkksContext.create(**CKKS_CONFIG, device="cpu")
        cpu_hop = pre_ckks(cpu, SEED + 40)[-1]
        cpu_hop()
        ckks_same("the card's CKKS re-encryption against the CPU port's, same seed",
                  ckks.Ciphertext(*cpu_hop(), ct.scale), out, tag)

        g = bgv.BgvContext.create(**BGV_CONFIG, device=dev)
        rng = np.random.default_rng(SEED + 41)
        sk_a, pk_a = g.keygen(rng)
        sk_b, pk_b = g.keygen(rng)
        m = rng.integers(0, g.t, size=g.params.N)
        gct = g.encrypt(pk_a, m, rng)
        for method, bits in (("hybrid", 0), ("bv", 14)):
            rk = pre.re_key_gen(g.params, sk_a, sk_b, rng, method=method, digit_bits=bits)
            c0, c1 = pre.re_encrypt(g.params, rk, gct.c0, gct.c1, rng, pk_b)
            pke_exact(tag, f"BGV re-encrypted to Bob, {method.upper()} key"
                      f"{f' ({bits}-bit digits)' if bits else ''}, Bob's decryption",
                      g.decrypt(sk_b, bgv.Ciphertext(c0, c1)), m)
    int_peak = int_multiply_peak(dev)
    ms = time_ms(hop, reps=11)
    dev_ms = device_split(tag, "CKKS re_encrypt batch 1", hop, 11, ms, shapes, card)
    print(f"{tag} CKKS re_encrypt (re-randomized) batch 1: {ms:.3f} ms (CUDA events, median of "
          f"11)  ({card})")
    limb_kernels_at(tag, "[pre] phase", dev, phase_shapes, dev_ms, errors, int_peak, card)
    print(f"{tag} the phase took {time.perf_counter() - t_phase:.3f} s (host clock)")
    return {name: launches[name] for name in LIMB_KERNELS}


def boot_lowest(ctx, ct):
    """ct dropped to its base block (one level, cd limbs): an exhausted
    ciphertext, as fhe_tpu's tests/test_bootstrap.py feeds the bootstrap."""
    from fhe_tpu_torch.lattice import rns
    from fhe_tpu_torch.pke import ckks
    drop = len(ct.moduli) - ctx.cd
    return ckks.Ciphertext(rns.level_reduce(ct.c0, drop), rns.level_reduce(ct.c1, drop), ct.scale)


def boot_error(tag: str, what: str, got: np.ndarray, want: np.ndarray, tol: float) -> float:
    err = float(np.abs(got - want).max())
    print(f"{tag} {what}: max |decrypted - expected| = {err:.3e} ({-math.log2(err):.2f} bits of "
          f"precision; tolerance {tol:g}, fhe_tpu's tests/test_bootstrap.py)")
    if not err < tol:
        fail(f"{tag} {what}: error {err} is not below {tol}")
    return err


@contextlib.contextmanager
def host_encode_clock():
    """Host seconds spent encoding plaintexts (ckks.encode, on the host in
    float64) and making their residues (rlwe.signed_to_rns: numpy, then the
    copy to the card) in the block, by the bootstrap's calls and
    make_plaintext's."""
    from fhe_tpu_torch.pke import bootstrap, ckks, rlwe
    spent = [0.0]
    originals = (bootstrap.encode, ckks.encode, rlwe.signed_to_rns)

    def clocked(fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[0] += time.perf_counter() - t0
            return out
        return call
    bootstrap.encode = ckks.encode = clocked(originals[0])
    rlwe.signed_to_rns = clocked(originals[2])
    try:
        yield spent
    finally:
        bootstrap.encode, ckks.encode, rlwe.signed_to_rns = originals


def boot_small(dev) -> dict:
    """The N = 2^11 ring of the [boot] chain's shape on dev, keyed from one
    seed: the encapsulated budget-(3, 3) bootstrap, the sparse one
    (BOOT_SPARSE_SLOTS slots, encapsulated) and the iterative one (8 bits,
    the same ciphertext and keys as the first): {what: (c0, c1 on the CPU,
    moduli, scale, decrypted slots, expected slots)}."""
    from fhe_tpu_torch.pke import bootstrap, ckks, params
    p = params.make_ckks_params(**dict(BOOT_CONFIG, N=BOOT_SMALL_N))
    ctx = ckks.CkksContext(p, torch.device(dev))
    n = p.N // 2
    rng = np.random.default_rng(SEED + 51)
    sk, pk = ctx.keygen(rng)
    pre = bootstrap.setup(ctx, h=BOOT_H, r=BOOT_R, level_budget=BOOT_BUDGET)
    keys = bootstrap.keygen(ctx, sk, pre, rng, encapsulate_h=BOOT_H)
    z = rng.uniform(-0.4, 0.4, size=n)
    ct = boot_lowest(ctx, ctx.encrypt(pk, z, rng))
    out = {}
    keep = lambda o, got, want: (o.c0.data.cpu(), o.c1.data.cpu(), o.moduli, o.scale, got, want)
    o = bootstrap.eval_bootstrap(ctx, ct, pre, keys)
    out["encapsulated, level budget (3, 3)"] = keep(o, ctx.decrypt(sk, o).real, z)
    o = bootstrap.eval_bootstrap_iterative(ctx, ct, pre, keys, precision_bits=8)
    out["iterative, 8 bits"] = keep(o, ctx.decrypt(sk, o).real, z)
    s = BOOT_SPARSE_SLOTS
    pre_s = bootstrap.setup(ctx, h=BOOT_H, r=BOOT_R, slots=s)
    keys_s = bootstrap.keygen(ctx, sk, pre_s, rng, encapsulate_h=BOOT_H)
    zs = rng.uniform(-0.4, 0.4, size=s) + 1j * rng.uniform(-0.4, 0.4, size=s)
    o = bootstrap.eval_bootstrap(ctx, boot_lowest(ctx, ctx.encrypt(pk, zs, rng, slots=s)), pre_s,
                                 keys_s)
    out[f"sparse, {s} slots, encapsulated"] = keep(o, ctx.decrypt(sk, o, slots=s, sparse=True),
                                                   zs)
    return out


def small_child(out_dir: str) -> int:
    """chip_smoke.py --small-cpu DIR: boot_small, then fbt_small, on the CPU
    with BOOT_CPU_THREADS threads, each saved to DIR as it is done (boot.pt,
    fbt.pt); the [boot] and [fbt] phases compare them with the card's."""
    import os
    torch.set_num_threads(BOOT_CPU_THREADS)
    for kind, run in (("boot", boot_small), ("fbt", fbt_small)):
        path = os.path.join(out_dir, f"{kind}.pt")
        torch.save(run("cpu"), path + ".part")
        os.replace(path + ".part", path)
    return 0


@contextlib.contextmanager
def child_process(flag: str):
    """Starts `chip_smoke.py flag DIR` with its output in DIR/child.log;
    yields (the process, DIR, its start on the host clock).  The process is
    killed on the way out if it is still running."""
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "child.log"), "w") as log:
            t0 = time.perf_counter()
            child = subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, tmp],
                                     stdout=log, stderr=subprocess.STDOUT)
            try:
                yield child, tmp, t0
            finally:
                if child.poll() is None:
                    child.kill()
                    child.wait()


def child_log(tmp: str) -> str:
    import os
    with open(os.path.join(tmp, "child.log")) as f:
        return f.read()


@contextlib.contextmanager
def small_on_cpu():
    """Starts `chip_smoke.py --small-cpu DIR` (the N = 2^11 runs on the CPU,
    small_child), which works beside the card's phases; yields wait(tag,
    kind), which waits for its `kind` result (at most BOOT_CPU_WAIT_S) and
    returns it and the seconds since the start."""
    import os
    with child_process("--small-cpu") as (child, tmp, t0):
        def wait(tag: str, kind: str):
            path = os.path.join(tmp, f"{kind}.pt")
            deadline = time.perf_counter() + BOOT_CPU_WAIT_S
            while not os.path.exists(path):
                if child.poll() is not None and not os.path.exists(path):
                    fail(f"{tag} the CPU run at N = {BOOT_SMALL_N} failed "
                         f"({child.returncode}):\n{child_log(tmp)[-4000:]}")
                if time.perf_counter() > deadline:
                    fail(f"{tag} the CPU run at N = {BOOT_SMALL_N} took over {BOOT_CPU_WAIT_S} s")
                time.sleep(0.5)
            return torch.load(path, weights_only=False), time.perf_counter() - t0
        yield wait


def ss_child(out_dir: str) -> int:
    """chip_smoke.py --ss DIR: the [ss] phase in a process of its own on the
    card, which the parent starts beside [boot] and [fbt] (both wait on the
    host most of the time), on [main]'s STD128 key and AND outputs, made
    again from SEED; saves its launches by kernel, its kernels' largest
    differences from their plain versions and the digest of that key and
    those outputs (the parent checks it against its own) to DIR/ss.pt."""
    import os
    torch.set_num_threads(2)
    dev = torch.device("cuda", 0)
    ctx, sk, key, bits, cts = std128_inputs(dev)
    and_out = ctx.eval_bin_gate(key, "AND", cts[0], cts[1])
    errors = Errors()
    launches = ss_phase(dev, errors, card_line(), ctx, sk, key, and_out, bits[0] & bits[1])
    torch.save({"launches": dict(launches), "errors": errors.max,
                "digest": digest(key.bsk, key.ksk.a, key.ksk.b, and_out.a, and_out.b)},
               os.path.join(out_dir, "ss.pt"))
    return 0


@contextlib.contextmanager
def ss_process():
    """Starts `chip_smoke.py --ss DIR` (ss_child); yields wait(), which
    waits for it (at most BOOT_CPU_WAIT_S), prints its output and returns
    its result and seconds."""
    import os
    with child_process("--ss") as (child, tmp, t0):
        def wait():
            try:
                rc = child.wait(timeout=BOOT_CPU_WAIT_S)
            except subprocess.TimeoutExpired:
                fail(f"[ss] its process took over {BOOT_CPU_WAIT_S} s")
            print(child_log(tmp), end="")
            if rc != 0:
                fail(f"[ss] its process failed ({rc})")
            return torch.load(os.path.join(tmp, "ss.pt"), weights_only=False), \
                time.perf_counter() - t0
        yield wait


def boot_phase(dev, errors: Errors, card: str, small_cpu):
    """The [boot] phase: CKKS bootstrapping (pke/bootstrap.py) at the
    128-bit full-slot set on the card; returns the launches of one counted
    eval_bootstrap and the set's context and keys."""
    from fhe_tpu_torch.lattice import stdparams
    from fhe_tpu_torch.pke import ckks, params
    t_phase = time.perf_counter()
    tag = "[boot]"
    p = params.make_ckks_params(**BOOT_CONFIG)
    stdparams.validate(p.moduli, p.N, "128_classic", "ternary", tuple(p.special_mods))
    log_qp = sum(math.log2(q) for q in p.moduli + p.special_mods)
    bound = stdparams.max_log_q(p.N, "128_classic", "ternary")
    scales = [math.log2(v) for _, v in sorted(ckks._level_scales(p).items())]
    print(f"{tag} N = {p.N}, {p.N // 2} slots; Q {len(p.moduli)} limbs (composite degree "
          f"{p.composite_degree}), P {len(p.special_mods)}, dnum = {p.num_part_q}; log2 QP = "
          f"{log_qp:.2f} <= {bound} (HE standard, 128-bit classic, ternary): stdparams.validate "
          f"passes; level scales 2^{min(scales):.4f} to 2^{max(scales):.4f}")
    print(f"{tag} chain, log2 of each limb: Q {[round(math.log2(q), 3) for q in p.moduli]}; "
          f"P {[round(math.log2(q), 3) for q in p.special_mods]}")
    launches, state = boot_full(dev, errors, card, p)
    on_card = boot_small(dev)
    on_cpu, cpu_s = small_cpu(tag, "boot")
    print(f"{tag} N = {BOOT_SMALL_N}, the same chain shape: keys and the bootstraps below "
          f"on the CPU ({BOOT_CPU_THREADS} threads, in a child process started after the build, "
          f"beside the card's phases; ready {cpu_s:.1f} s after its start, host clock)")
    errs = {}
    for what, (c0, c1, moduli, scale, slots, want) in on_card.items():
        w0, w1, w_moduli, w_scale = on_cpu[what][:4]
        if (moduli, scale) != (w_moduli, w_scale) or not (
                torch.equal(c0, w0) and torch.equal(c1, w1)):
            fail(f"{tag} N = {BOOT_SMALL_N} {what}: the card's ciphertext differs from the CPU's")
        print(f"{tag} N = {BOOT_SMALL_N} {what}, card against CPU, same seed: byte-equal "
              f"({len(moduli)} limbs, scale {scale!r})")
        errs[what] = boot_error(tag, f"N = {BOOT_SMALL_N} {what}", slots, want, BOOT_TOL)
    e1 = errs["encapsulated, level budget (3, 3)"]
    e2 = errs["iterative, 8 bits"]
    # fhe_tpu's test coarsens the sine fit at N = 128, where one bootstrap
    # sits at the key-noise floor; at N = 2^11 one bootstrap is above 5e-6
    print(f"{tag} N = {BOOT_SMALL_N} iterative: {e2:.3e} against one bootstrap's {e1:.3e} "
          f"({e1 / e2:.1f}x; tests/test_bootstrap.py:106-132 asks > 5e-6 and at least 4x)")
    if not (e1 > 5e-6 and e2 < e1 / 4):
        fail(f"{tag} the iterative bootstrap gains too little: {e1} -> {e2}")
    print(f"{tag} the phase took {time.perf_counter() - t_phase:.3f} s (host clock)")
    return launches, state


def boot_full(dev, errors: Errors, card: str, p):
    """[boot] at the full set p on the card: keys, one bootstrap checked
    and counted, one timed and traced, kernels 1-2 at its shapes; returns
    the counted bootstrap's launches and (context, sk, pk, keys) for
    [fbt]."""
    from fhe_tpu_torch.pke import bootstrap, ckks
    tag = "[boot]"
    ctx = ckks.CkksContext(p, dev)
    n = p.N // 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pre = bootstrap.setup(ctx, h=BOOT_H, r=BOOT_R, level_budget=BOOT_BUDGET)
    setup_s = time.perf_counter() - t0
    cts_d = [len(d) for d, _ in pre.cts_levels]
    stc_d = [len(d) for d, _ in pre.stc_levels]
    print(f"{tag} setup (host, numpy): {setup_s:.3f} s; K = {pre.K}, sine degree "
          f"{len(pre.cheb_coeffs) - 1}, r = {pre.r}; level budget {BOOT_BUDGET}: CoeffsToSlots "
          f"{cts_d}, SlotsToCoeffs {stc_d} diagonals ({sum(cts_d) + sum(stc_d)} plaintexts a "
          f"bootstrap), {len(pre.rot_indices)} rotation keys")
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 50)
    sk, pk = ctx.keygen(rng)
    keys = bootstrap.keygen(ctx, sk, pre, rng, encapsulate_h=BOOT_H)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    n_keys = len(keys["rot"]) + 4
    key_gb = n_keys * 2 * keys["evk"].b.numel() * keys["evk"].b.element_size() / 1e9
    print(f"{tag} keygen (dense secret, public key, {len(keys['rot'])} rotation keys, conj, relin, "
          f"swk_down / swk_up to the weight-{BOOT_H} helper) on the card: {keygen_s:.3f} s (host "
          f"clock, with the host draws); keys {key_gb:.2f} GB ({n_keys} x 2 x "
          f"{tuple(keys['evk'].b.shape)} int32); torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    z = rng.uniform(-0.4, 0.4, size=n)
    ct = boot_lowest(ctx, ctx.encrypt(pk, z, rng))
    boot = lambda: bootstrap.eval_bootstrap(ctx, ct, pre, keys)

    # the first call (cold: it also builds the plans and tables of its bases)
    # is the counted one
    t0 = time.perf_counter()
    out, launches, shapes = counted(tag, "eval_bootstrap", boot)
    print(f"{tag} first eval_bootstrap of a level-0 ciphertext ({len(ct.moduli)} limbs), "
          f"launches counted: {time.perf_counter() - t0:.3f} s (host clock, cold); "
          f"torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    boot_error(tag, f"eval_bootstrap of uniform(-0.4, 0.4) on all {n} slots", ctx.decrypt(
        sk, out).real, z, BOOT_TOL)
    levels = (len(out.moduli) - ctx.cd) // ctx.cd
    print(f"{tag} output: {len(out.moduli)} limbs, {levels} levels above the base block")
    if levels < 2:
        fail(f"{tag} the bootstrap leaves {levels} levels (fewer than 2)")
    sq = ctx.mul_rescale(out, out, keys["evk"])
    boot_error(tag, "mul_rescale of the output against z^2", ctx.decrypt(sk, sq).real, z * z,
               BOOT_TOL)

    what = "eval_bootstrap batch 1"
    _, ms, ks = timed_traced(tag, what, boot, card,
                             f"{sum(cts_d) + sum(stc_d)} diagonals and the sine's constants")
    dev_ms = device_split(tag, what, boot, 1, ms, shapes, card, ks=ks)
    limb_kernels_at(tag, "bootstrap", dev, shapes, dev_ms, errors, int_multiply_peak(dev), card)
    return {name: launches[name] for name in LIMB_KERNELS}, (ctx, sk, pk, keys)


def timed_traced(tag: str, what: str, fn, card: str, encodes: str):
    """One warm call of fn, timed with CUDA events inside a torch.profiler
    trace and the host-encode clock: prints its time and the share of it
    the host spends encoding plaintexts; returns (the output, its ms, the
    trace's kernels for device_split)."""
    from torch.profiler import ProfilerActivity, profile
    with host_encode_clock() as host_s:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ms, out = timed_once(fn)
    print(f"{tag} {what}: {ms:.3f} ms (CUDA events, one warm call, under the profiler); "
          f"{host_s[0]:.3f} s of it ({host_s[0] * 1e3 / ms:.3f}) encoding plaintexts on the host "
          f"(ckks.encode and rlwe.signed_to_rns: {encodes}; host clock)  ({card})")
    return out, ms, trace_kernels(prof)


def fbt_r(tag: str, what: str, K: int, levels: int) -> int:
    """R for an FBT of the exponential's range K on a chain of `levels`
    levels: for each r, the series' degree (fbt._exp_cheb_coeffs) and the
    depth get_fbt_depth's formula gives with that degree (the raise's
    CoeffsToSlots 1, Paterson-Stockmeyer ceil(log2 deg) + 2, r squarings,
    the power basis of a p = 4 order-2 LUT 3, its series 1, SlotsToCoeffs
    1); the least r whose depth leaves a level to spare and whose degree
    is at most FBT_MAX_DEG (one host-encoded plaintext a coefficient)."""
    from fhe_tpu_torch.pke import fbt
    herm_deg = FBT_P + FBT_P // 2                      # order 2
    pow_depth = max(1, math.ceil(math.log2(herm_deg)))
    rows = []
    for r in range(10):
        try:
            deg = len(fbt._exp_cheb_coeffs(K, r)) - 1
        except ValueError:
            continue
        depth = 1 + max(1, math.ceil(math.log2(max(2, deg)))) + 2 + r + pow_depth + 1 + 1
        rows.append((r, deg, depth))
    fits = [r for r, deg, depth in rows if depth <= levels - 1 and deg <= FBT_MAX_DEG]
    if not fits:
        fail(f"{tag} {what}: no r fits {levels} levels: {rows}")
    print(f"{tag} {what}: K = {K}; (r, exp series degree, depth) {rows}; R = {fits[0]}, the "
          f"least r of depth <= {levels - 1} and degree <= {FBT_MAX_DEG}")
    return fits[0]


def fbt_big_q(ctx) -> int:
    """The schemelet's input modulus: 2^3 times q0's power of two, as
    fhe_tpu's tests put 2^33 over a 30-bit q0."""
    from fhe_tpu_torch.pke import bootstrap
    return 1 << (bootstrap._q0(ctx).bit_length() + 2)


def fbt_lut(ctx, sk, out, big_q: int, stride: int) -> np.ndarray:
    """The LUT digits of an FBT output: switched to big_q, decrypted mod 4,
    every stride-th coefficient."""
    from fhe_tpu_torch.pke import fbt
    return fbt.decrypt_coeff(ctx, sk, fbt.convert_ckks_to_rlwe(
        ctx, out, big_q, target_delta=big_q / FBT_P), FBT_P)[::stride]


def fbt_check(tag: str, what: str, got: np.ndarray, want: np.ndarray) -> None:
    wrong = int((got != want).sum())
    print(f"{tag} {what}: {wrong} wrong of {len(want)} (decrypt_coeff)")
    if wrong:
        fail(f"{tag} {what}: {wrong} wrong LUT outputs")


def fbt_small(dev) -> dict:
    """The N = 2^11 ring of the [boot] chain's shape on dev, keyed from one
    seed (a dense secret, the weight-BOOT_H helper): the dense FBT on full
    packing (N digits), the sparse FBT at d = BOOT_SPARSE_D (N / d digits)
    and the multiprecision sign (p_in = 16, p_digit = 4, Q = 4 big_q):
    {what: (c0, c1 on the CPU or host integers, moduli or q, scale or
    delta, decrypted, expected)}."""
    from fhe_tpu_torch.pke import ckks, fbt, params
    p = params.make_ckks_params(**dict(BOOT_CONFIG, N=BOOT_SMALL_N))
    ctx = ckks.CkksContext(p, torch.device(dev))
    N, levels = p.N, len(p.moduli) // p.composite_degree - 1
    rng = np.random.default_rng(SEED + 52)
    sk, _ = ctx.keygen(rng)
    big_q = fbt_big_q(ctx)
    func = FBT_LUTS["(3x + 2) mod 4"]
    coeffs = fbt.get_hermite_trig_coefficients(func, FBT_P, 2)
    keep = lambda o, got, want: (o.c0.data.cpu(), o.c1.data.cpu(), o.moduli, o.scale, got, want)
    out = {}
    K = (BOOT_H + 1) // 2 + 4
    pre = fbt.setup(ctx, h=BOOT_H, r=fbt_r("[fbt]", f"N = {N} dense", K, levels))
    keys = fbt.keygen(ctx, sk, pre, rng, encapsulate_h=BOOT_H)
    msg = rng.integers(0, FBT_P, size=N)
    ct = fbt.convert_rlwe_to_ckks(ctx, fbt.encrypt_coeff(ctx, sk, msg, big_q, FBT_P, rng))
    o = fbt.eval_fbt(ctx, ct, coeffs, pre, keys)
    out[f"dense eval_fbt, {N} digits"] = keep(o, fbt_lut(ctx, sk, o, big_q, 1), func(msg))
    d = BOOT_SPARSE_D
    K_s = int(math.ceil(K * math.sqrt(d)))
    pre_s = fbt.setup(ctx, h=BOOT_H, r=fbt_r("[fbt]", f"N = {N} sparse, d = {d}", K_s, levels),
                      slots=N // 2 // d)
    keys_s = fbt.keygen(ctx, sk, pre_s, rng, encapsulate_h=BOOT_H)
    vals = rng.integers(0, FBT_P, size=N // d)
    msg = np.zeros(N, dtype=np.int64)
    msg[::d] = vals
    ct = fbt.convert_rlwe_to_ckks(ctx, fbt.encrypt_coeff(ctx, sk, msg, big_q, FBT_P, rng),
                                  num_values=N // d)
    o = fbt.eval_fbt(ctx, ct, coeffs, pre_s, keys_s)
    out[f"sparse eval_fbt, d = {d}, {N // d} digits"] = keep(o, fbt_lut(ctx, sk, o, big_q, d),
                                                             func(vals))
    vals = rng.integers(0, 16, size=N)
    ct_big = fbt.encrypt_coeff(ctx, sk, vals, big_q << 2, 16, rng)
    sgn = fbt.eval_sign_multiprecision(ctx, ct_big, 16, 4, big_q, pre, keys, order=2)
    out[f"eval_sign_multiprecision, p_in 16, p_digit 4, {N} values"] = (
        sgn.c0, sgn.c1, sgn.q, sgn.delta, fbt.decrypt_coeff(ctx, sk, sgn, 2),
        (vals >= 8).astype(np.int64))
    return out


def single_ntt_2_16(dev, errors: Errors, card: str) -> None:
    """The single-modulus kernels 1-2 at N = 2^16 (the split kernels as one
    limb) at [3, 65536] under the schemelet product's first prime: byte-
    equal to their plain versions, 10 launches back to back, the plain
    time and the bound."""
    from fhe_tpu_torch.math import ntt
    from fhe_tpu_torch.pke import fbt
    plan = ntt.make_plan(1 << 16, fbt.mul_primes(1)[0], dev)
    x = _residues(np.random.default_rng(SEED + 7), plan.q, (3, plan.N), dev)
    int_peak = int_multiply_peak(dev)
    for name, fn, plain, extra in (
            ("ntt_forward", ntt.ntt_forward, ntt.forward_butterfly, 0),
            ("ntt_inverse", ntt.ntt_inverse, ntt.inverse_butterfly, plan.N)):
        errors.compare(name, fn(plan, x), plain(plan, x), f"[fbt] {name} [3, 65536]")
        ms = time_ms(lambda: [fn(plan, x) for _ in range(10)], reps=5) / 10
        p_ms = time_ms(lambda: plain(plan, x), reps=3)
        muls = 3 * (plan.N // 2 * plan.logN + extra) * 3
        b_ms, b_by = bound(_nbytes(x, x, plan.fwd_w, plan.fwd_ws), muls, int_peak)
        print(f"[fbt] {name} single-modulus [3, 65536] (q = {plan.q}): {ms:.4f} ms a launch 10 "
              f"back to back (with the host's issue), at {b_ms / ms:.3f} of the bound; plain "
              f"{p_ms:.3f} ms; bound {b_ms:.4f} ms by {b_by}  ({card})")


def fbt_phase(dev, errors: Errors, card: str, boot_state, small_cpu) -> dict:
    """The [fbt] phase: CKKS functional bootstrapping (pke/fbt.py) on
    [boot]'s set, secret and keys at full width, and at N = 2^11 card
    against CPU; returns the launches of the counted eval_fbt."""
    t_phase = time.perf_counter()
    tag = "[fbt]"
    launches = fbt_full(dev, errors, card, *boot_state)
    on_card = fbt_small(dev)
    on_cpu, cpu_s = small_cpu(tag, "fbt")
    print(f"{tag} N = {BOOT_SMALL_N}: keys and the FBTs below on the CPU ({BOOT_CPU_THREADS} "
          f"threads, after [boot]'s in the same child process; ready {cpu_s:.1f} s after its "
          f"start, host clock)")
    for what, (c0, c1, moduli, scale, got, want) in on_card.items():
        w0, w1, w_moduli, w_scale = on_cpu[what][:4]
        same = (torch.equal(c0, w0) and torch.equal(c1, w1)) if isinstance(c0, torch.Tensor) \
            else [int(x) for x in c0] + [int(x) for x in c1] == [int(x) for x in w0] + \
            [int(x) for x in w1]
        if (moduli, scale) != (w_moduli, w_scale) or not same:
            fail(f"{tag} N = {BOOT_SMALL_N} {what}: the card's output differs from the CPU's")
        print(f"{tag} N = {BOOT_SMALL_N} {what}, card against CPU, same seed: byte-equal")
        fbt_check(tag, f"N = {BOOT_SMALL_N} {what}", got, want)
    print(f"{tag} the phase took {time.perf_counter() - t_phase:.3f} s (host clock)")
    return launches


def fbt_full(dev, errors: Errors, card: str, ctx, sk, pk, keys) -> dict:
    """[fbt] at N = 2^16: the sparse FBT with FBT_SLOTS slots (d = N / (2
    slots)) on [boot]'s context, secret and keys, keyed for the rotations
    [boot] lacks; the three LUTs, the schemelet product card against CPU,
    one eval_fbt counted, timed and traced, kernels 1-2 at its shapes;
    returns its launches."""
    from fhe_tpu_torch.pke import fbt
    tag = "[fbt]"
    p = ctx.params
    N, n = p.N, p.N // 2
    levels = len(p.moduli) // p.composite_degree - 1
    d = n // FBT_SLOTS
    stride = N // (2 * FBT_SLOTS)
    K = int(math.ceil(((FBT_RANGE_H + 1) // 2 + 4) * math.sqrt(d)))
    t0 = time.perf_counter()
    pre = fbt.setup(ctx, h=FBT_RANGE_H, r=fbt_r(tag, f"N = {N}, d = {d}", K, levels),
                    slots=FBT_SLOTS)
    print(f"{tag} setup (host, numpy): {time.perf_counter() - t0:.3f} s; {FBT_SLOTS} slots, "
          f"{2 * FBT_SLOTS} digits (d = {d}), K = {pre.K} (setup's h = {FBT_RANGE_H}: the sparse "
          f"rule K = ((h + 1)/2 + 4) sqrt(d) at the helper's own h = {BOOT_H} gives "
          f"{int(math.ceil(((BOOT_H + 1) // 2 + 4) * math.sqrt(d)))}, which d |I| passes with "
          f"|I| >= 7, ROADMAP queue 3), exp series degree {len(pre.exp_coeffs) - 1}, r = {pre.r}, "
          f"{len(pre.rot_indices)} rotation keys")
    rng = np.random.default_rng(SEED + 53)
    missing = sorted(set(pre.rot_indices) - set(keys["rot"]))
    t0 = time.perf_counter()
    fkeys = dict(keys, rot={**keys["rot"], **ctx.rotation_key_gen(sk, missing, rng)})
    torch.cuda.synchronize()
    print(f"{tag} {len(missing)} rotation keys [boot] lacks, keyed on the card: "
          f"{time.perf_counter() - t0:.3f} s (host clock); torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    big_q = fbt_big_q(ctx)
    vals = rng.integers(0, FBT_P, size=2 * FBT_SLOTS)
    msg = np.zeros(N, dtype=np.int64)
    msg[::stride] = vals
    t0 = time.perf_counter()
    ct_rlwe = fbt.encrypt_coeff(ctx, sk, msg, big_q, FBT_P, rng)
    print(f"{tag} encrypt_coeff of {2 * FBT_SLOTS} digits in Z_{FBT_P} under big_q = "
          f"2^{big_q.bit_length() - 1} (q0 ~2^{math.log2(fbt._q0(ctx)):.2f}), one every "
          f"{stride}th coefficient: {time.perf_counter() - t0:.3f} s (host clock)")
    s = np.asarray(sk.s_signed.cpu().numpy(), dtype=object)
    mods = fbt.mul_primes(3)
    t0 = time.perf_counter()
    with limb_launch_shapes() as product_shapes:
        on_card = fbt._negacyclic_mul(ct_rlwe.c1, s, dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = fbt._negacyclic_mul(ct_rlwe.c1, s, "cpu")
    if [int(x) for x in on_card] != [int(x) for x in on_cpu]:
        fail(f"{tag} the schemelet's exact product differs between the card and the CPU")
    print(f"{tag} schemelet product c1 s at N = {N} (NTTs over {len(mods)} primes q = 1 mod 2^17,"
          f" centred CRT): card {card_s:.3f} s, CPU {time.perf_counter() - t0:.3f} s (host "
          f"clock), byte-equal")
    fbt_check(tag, "decrypt_coeff of the input", fbt.decrypt_coeff(ctx, sk, ct_rlwe, FBT_P)[
        ::stride], vals)
    ct = fbt.convert_rlwe_to_ckks(ctx, ct_rlwe, num_values=2 * FBT_SLOTS)

    # multi-value bootstrapping, the first (cold) calls
    mvb = {w: FBT_LUTS[w] for w in ("x^2 mod 4", "(3x + 1) mod 4")}
    cs = {w: fbt.get_hermite_trig_coefficients(f, FBT_P, 2) for w, f in mvb.items()}
    deg = max(len(c) for c in cs.values()) - 1
    t0 = time.perf_counter()
    sp, mvb_launches, mvb_shapes = counted(
        tag, "eval_mvb_precompute", lambda: fbt.eval_mvb_precompute(ctx, ct, pre, fkeys, deg))
    print(f"{tag} eval_mvb_precompute (cold; power basis to degree {deg}): "
          f"{time.perf_counter() - t0:.3f} s (host clock)")
    for w, c in cs.items():
        t0 = time.perf_counter()
        out = fbt.eval_hom_decoding(ctx, fbt.eval_mvb_no_decoding(ctx, sp, c, pre, fkeys), pre,
                                    fkeys)
        print(f"{tag} MVB {w}: series and SlotsToCoeffs {time.perf_counter() - t0:.3f} s (host "
              f"clock)")
        fbt_check(tag, f"MVB {w} at N = {N}", fbt_lut(ctx, sk, out, big_q, stride),
                  mvb[w](vals))
    del sp
    func = FBT_LUTS["(3x + 2) mod 4"]
    coeffs = fbt.get_hermite_trig_coefficients(func, FBT_P, 2)
    what = "eval_fbt (3x + 2) mod 4"
    run = lambda: fbt.eval_fbt(ctx, ct, coeffs, pre, fkeys)
    (out, ms, ks), launches, shapes = counted(tag, what, lambda: timed_traced(
        tag, what, run, card, f"{2 * FBT_SLOTS} rectangular diagonals and the series' constants"))
    dev_ms = device_split(tag, what, run, 1, ms, shapes, card, ks=ks)
    fbt_check(tag, f"eval_fbt (3x + 2) mod 4 at N = {N}", fbt_lut(ctx, sk, out, big_q, stride),
              func(vals))
    mvb_shapes.update(shapes)
    mvb_shapes.update(product_shapes)
    limb_kernels_at(tag, "eval_fbt, MVB or schemelet product", dev, mvb_shapes, dev_ms, errors,
                    int_multiply_peak(dev), card)
    single_ntt_2_16(dev, errors, card)
    del fkeys
    return {name: launches[name] for name in LIMB_KERNELS}


class RecordingSign:
    """A BinFheContext whose eval_sign keeps its input (the switched LWE
    ciphertexts) for the checks after a compare."""

    def __init__(self, ctx):
        self.ctx, self.params, self.seen = ctx, ctx.params, None

    def eval_sign(self, key, cts, scheme_switch: bool = False):
        self.seen = cts
        return self.ctx.eval_sign(key, cts, scheme_switch=scheme_switch)


def lwe_rows(ct, rows):
    return dataclasses.replace(ct, a=ct.a[rows], b=ct.b[rows])


def lwe_error(sk, ct, value) -> torch.Tensor:
    """Signed phase of ct minus value (a tensor of the expected phases) in
    (-modulus/2, modulus/2]."""
    s = sk.s.to(ct.a.device, torch.int64)
    mod = ct.modulus
    ph = (ct.b.to(torch.int64) - (ct.a.to(torch.int64) * s).sum(-1)) % mod
    return (ph - value + mod // 2) % mod - mod // 2


def sign_margins(ctx_f, sk_f, key_f, ct, negative: torch.Tensor) -> dict:
    """EvalSign's ladder (funcboot.eval_sign: floors from ct's modulus down
    to q, then the sign bootstrap) run stage by stage on the rows of ct;
    for each row, whether a stage is past its margin: the input's phase
    plus beta on the wrong side of its MSB (the first floor keeps the high
    part of ct + beta), a floor's middle phase x (ct + beta - the first
    bootstrap, mod q) outside [q/4, 3q/4), the range its second LUT
    assumes, or its output off the exact high part of ct + beta by q/2 or
    more (the next stage, after the modulus switch by q / (2 beta), adds
    beta and keeps its own high part or MSB: it tolerates less than q/2
    here), or the sign bootstrap's input (plus beta) in the wrong half;
    with the stages' output, which must be eval_sign's."""
    from fhe_tpu_torch.tfhe import funcboot, lwe
    p = ctx_f.params
    q, beta = p.q, funcboot.BETA
    mod = ct.modulus
    past = {"input": (lwe_error(sk_f, funcboot.add_const(ct, beta), 0) % mod >= mod // 2)
            != negative}
    stage, cur = 0, ct
    while mod > q:
        stage += 1
        ct1 = funcboot.add_const(cur, beta)
        ct2 = funcboot.bootstrap_func(p, key_f, funcboot.set_modulus(ct1, q),
                                      funcboot._f0_table(q, mod), mod)
        mid = funcboot.sub(ct1, ct2)
        x = lwe_error(sk_f, mid, 0) % q
        xs = np.arange(q)
        f2 = np.where(xs < q // 4, (mod - q // 2 - xs) % mod,
                      np.where(xs < 3 * (q // 4), xs, (mod + q // 2 - xs) % mod))
        ct3 = funcboot.bootstrap_func(p, key_f, funcboot.set_modulus(mid, q), f2.astype(np.uint32),
                                      mod)
        y = lwe_error(sk_f, ct1, 0) % mod
        out = funcboot.sub(mid, ct3)
        e_out = lwe_error(sk_f, out, y - y % q)
        past[f"floor {stage}"] = (x < q // 4) | (x >= 3 * q // 4) | (e_out.abs() >= q // 2)
        mod = (mod * 2 * beta) // q
        cur = lwe.mod_switch(out, mod)
    cur = funcboot.add_const(cur, beta)
    cm = cur.modulus
    past["sign bootstrap"] = (lwe_error(sk_f, cur, 0) % cm >= cm // 2) != negative
    x = np.arange(cm)
    f3 = np.where(x < cm // 2, q // 4, q - q // 4).astype(np.uint32)
    out = funcboot.sub_const(funcboot.bootstrap_func(p, key_f, cur, f3, q), q >> 2)
    return past, out


def ss_sign_check(tag: str, ctx_f, sk_f, key_f, rec: RecordingSign, out, want, card: str):
    """The compare's wrong signs: each past a margin of EvalSign's ladder
    (sign_margins, on the wrong rows), the ladder's output eval_sign's;
    the first 128 wrong rows and the first 64 through the plain rotation
    byte-equal to the kernels'; the whole EvalSign through kernel 4 ("mega") equal to it."""
    got = ctx_f.decrypt(sk_f, dataclasses.replace(out, pt_mod=2), 2).cpu().numpy()
    wrong = np.flatnonzero(got != want)
    print(f"{tag} compare: {len(wrong)} wrong signs of {len(want)}  ({card})")
    rows = torch.from_numpy(np.union1d(wrong[:128], np.arange(64))).to(out.a.device)
    lwe_in = rec.seen
    if len(wrong):
        neg = torch.from_numpy(want[wrong] == 1).to(out.a.device)
        past, ladder = sign_margins(ctx_f, sk_f, key_f, lwe_rows(lwe_in, wrong), neg)
        sub = lwe_rows(out, wrong)
        if not (torch.equal(ladder.a, sub.a) and torch.equal(ladder.b, sub.b)):
            fail(f"{tag} EvalSign's ladder taken apart does not give eval_sign's output")
        explained = past["input"].clone()
        for stage, flags in past.items():
            if stage.startswith("floor"):
                explained |= flags
        print(f"{tag} compare's wrong signs, past the margin of: "
              f"{ {stage: int(f.sum()) for stage, f in past.items()} }; past no floor's margin "
              f"and not the input's: {int((~explained).sum())}")
        if not bool(explained.all()):
            fail(f"{tag} a wrong sign is past no floor's margin (nor the input's)")
    t0 = time.perf_counter()
    with plain_rotation():
        plain = ctx_f.eval_sign(key_f, lwe_rows(lwe_in, rows))
    sub = lwe_rows(out, rows)
    if not (torch.equal(plain.a, sub.a) and torch.equal(plain.b, sub.b)):
        fail(f"{tag} the compare's EvalSign differs from the plain pipeline's")
    print(f"{tag} the compare's EvalSign on {len(rows)} rows (the first 128 wrong ones and the "
          f"first 64) "
          f"through the plain rotation: byte-equal to the kernels' "
          f"({time.perf_counter() - t0:.3f} s, host clock)")
    mega_ctx = dataclasses.replace(ctx_f, ntt_impl="mega")
    mega, m_launches, _ = counted(tag, 'EvalSign with ntt_impl="mega"',
                                  lambda: mega_ctx.eval_sign(key_f, lwe_in), limb_only=False)
    if not (torch.equal(mega.a, out.a) and torch.equal(mega.b, out.b)):
        fail(f'{tag} EvalSign with ntt_impl="mega" differs from the default accumulator')
    print(f'{tag} EvalSign with ntt_impl="mega" (kernel 4): identical to the default')
    return m_launches


@contextlib.contextmanager
def recorded_switch():
    """Keeps the inputs of lwe.switch_ct_to_qn (eval_ckks_to_fhew's
    extracted ring-LWE ciphertexts) of the calls in the block."""
    from fhe_tpu_torch.tfhe import lwe
    seen, original = [], lwe.switch_ct_to_qn

    def switch(params, ksk, ct):
        seen.append(ct)
        return original(params, ksk, ct)
    lwe.switch_ct_to_qn = switch
    try:
        yield seen
    finally:
        lwe.switch_ct_to_qn = original


def ss_switch_check(tag: str, ctx_f, sk, sk_f, ring, cts, z: np.ndarray, card: str) -> None:
    """eval_ckks_to_fhew's outputs: the extraction (under the CKKS ring
    secret, mod the chain's first prime) exact, and the switched ones
    (under the FHEW secret, mod q) wrong only as often as the switch's own
    noise says.  That noise is predicted from the parameters: the key
    switch sums N dc errors of std_dev at q_ks, the mod switches to q_ks
    and to q round N- and n-term inner products with ternary secrets; a
    p = 4 output is wrong past q/8.  The measured noise's std must be
    within 15 % of the prediction and the wrong outputs within the
    Poisson bound (tail LMK_PAST_TAIL) of its Gaussian rate."""
    from fhe_tpu_torch.tfhe import lwe
    p = ctx_f.params
    n = len(z)
    ring_sk = lwe.LweSecretKey(s=sk.s_signed.to(torch.int32))
    ring_wrong = int((lwe.decrypt(p, ring_sk, ring, 4).cpu().numpy() != z).sum())
    got = ctx_f.decrypt(sk_f, cts, 4).cpu().numpy()
    wrong = int((got != z).sum())
    e = lwe.noise(p, sk_f, cts, z, 4).double()
    N = ring.n
    var_ks = p.std_dev ** 2 * N * p.digits_ks + (1 + N * 2 / 3) / 12
    sigma = math.sqrt(var_ks * (p.q / p.q_ks) ** 2 + (1 + p.n * 2 / 3) / 12)
    rate = math.erfc(p.q / 8 / (sigma * math.sqrt(2)))
    limit = poisson_limit(rate * n, LMK_PAST_TAIL)
    measured = float(e.std())
    print(f"{tag} eval_ckks_to_fhew of {n} slots of integers in [0, 4): the extraction (N = {N}, "
          f"mod {ring.modulus}) {ring_wrong} wrong; switched to (n = {cts.n}, q = {cts.modulus}) "
          f"{wrong} wrong of {n}; the switch's noise std {measured:.2f} at q (predicted "
          f"{sigma:.2f}: std_dev sqrt(N dc) = {p.std_dev * math.sqrt(N * p.digits_ks):.1f} at q_ks "
          f"= {p.q_ks}), largest |e| {int(e.abs().max())} against the margin q/8 = {p.q // 8}: "
          f"a rate of {rate:.2e}, at most {limit} wrong (ROADMAP queue 3)  ({card})")
    if ring_wrong or cts.n != p.n or wrong > limit or abs(measured - sigma) > 0.15 * sigma:
        fail(f"{tag} eval_ckks_to_fhew: the extraction {ring_wrong} wrong, {wrong} wrong after the"
             f" switch (at most {limit}), noise std {measured} against {sigma}")


def ss_fhew_to_ckks_check(tag: str, ctx, sk, res, sk_f, cts, bits: np.ndarray, card: str):
    """eval_fhew_to_ckks of LWE bits (p = 4): the slots round to the bits,
    and hold sin(2 pi phi / q), phi each input's exact phase b - <a, s>,
    within FHEW_CKKS_TOL (the function the conversion evaluates: its
    (1/2pi) sin(2 pi x) times the post-scale 2 pi).  tests/test_schemeswitch.py
    bounds |slot - bit| by 0.3 for fresh encryptions; a bootstrapped gate's
    output carries more noise, which the sine passes on near 0, so slots
    past 0.3 are counted and must be as far through their inputs' phases."""
    B = len(bits)
    vals = ctx.decrypt(sk, res).real[:B]
    q = cts.modulus
    s = sk_f.s.to(cts.a.device, torch.int64)
    phi = ((cts.b.to(torch.int64) - (cts.a.to(torch.int64) * s).sum(-1)) % q).cpu().numpy()
    exact = np.sin(2 * np.pi * phi / q)
    err = float(np.abs(vals - exact).max())
    wrong = int((np.rint(vals) != bits).sum())
    far = np.abs(vals - bits) >= 0.3
    noisy = np.abs(exact - bits) >= 0.3 - FHEW_CKKS_TOL
    print(f"{tag} eval_fhew_to_ckks: max |decrypted - sin(2 pi phi / q)| = {err:.3e} (tolerance "
          f"{FHEW_CKKS_TOL:g}); {wrong} of {B} round wrong; {int(far.sum())} slots 0.3 or more "
          f"from their bit (the inputs' own noise: max |sin(2 pi phi / q) - bit| = "
          f"{float(np.abs(exact - bits).max()):.4f}, largest |phi - bit q/4| "
          f"{int(np.abs((phi - bits * (q // 4) + q // 2) % q - q // 2).max())} of q = {q}); "
          f"{len(res.moduli)} limbs left  ({card})")
    if not err < FHEW_CKKS_TOL or wrong or (far & ~noisy).any():
        fail(f"{tag} eval_fhew_to_ckks: error {err}, {wrong} wrong, "
             f"{int((far & ~noisy).sum())} past 0.3 without their inputs")


def fhew_to_ckks_depth(K: int) -> int:
    """Levels eval_fhew_to_ckks spends on SS_F2C_CONFIG's chain: its
    A-transform's rescale, the sine's Paterson-Stockmeyer series and 3
    double angles (measured on a probe ciphertext of that chain's shape at
    N = 128 on the CPU) and its post-scale's rescale."""
    from fhe_tpu_torch.pke import advanced, bootstrap, ckks, params
    probe = ckks.CkksContext(params.make_ckks_params(**dict(SS_F2C_CONFIG, N=128, num_levels=14)),
                             torch.device("cpu"))
    rng = np.random.default_rng(SEED + 71)
    sk, pk = probe.keygen(rng)
    evk = probe.relin_key_gen(sk, rng)
    ct = probe.encrypt(pk, np.zeros(64), rng)
    y = advanced.eval_chebyshev_series_ps(probe, ct, bootstrap._sine_cheb_coeffs(K, r=3, tol=1e-7),
                                          -1.0, 1.0, evk)
    y = bootstrap._double_angle(probe, y, evk, 3)
    return 1 + (len(ct.moduli) - len(y.moduli)) // probe.cd + 1


def ss_phase(dev, errors: Errors, card: str, ctx_f, sk_f, key_f, and_out, and_want) -> dict:
    """The [ss] phase: CKKS <-> FHEW scheme switching (pke/schemeswitch.py)
    with the main path's STD128 context, secret and key as the FHEW side:
    CKKS -> FHEW and compare at bench config 3, FHEW -> CKKS of [main]'s
    AND outputs at N = 2^14 on a chain as deep as its sine, min and max at
    N = 2^11 with TOY_RADIX; returns the launches of its calls by kernel."""
    from fhe_tpu_torch.lattice import stdparams
    from fhe_tpu_torch.pke import bootstrap, ckks, params
    from fhe_tpu_torch.pke import schemeswitch as ss
    t_phase = time.perf_counter()
    tag = "[ss]"
    total = collections.Counter()
    shapes = collections.Counter()

    def run(call: str, fn, encodes: str):
        with host_encode_clock() as host_s:
            (ms, out), launches, sh = counted(tag, call, lambda: timed_once(fn), limb_only=False)
        print(f"{tag} {call}: {ms:.3f} ms (CUDA events, one call); {host_s[0]:.3f} s of it "
              f"({host_s[0] * 1e3 / ms:.3f}) encoding plaintexts on the host ({encodes}; host "
              f"clock)  ({card})")
        total.update(launches)
        shapes.update(sh)
        return out

    # CKKS -> FHEW at bench config 3, to STD128's (n, q)
    ctx = ckks.CkksContext.create(**CKKS_CONFIG, device=dev)
    n = ctx.params.N // 2
    rng = np.random.default_rng(SEED + 60)
    sk, pk = ctx.keygen(rng)
    t0 = time.perf_counter()
    key = ss.ckks_to_fhew_setup(ctx, sk, ctx_f.params, sk_f, rng)
    torch.cuda.synchronize()
    print(f"{tag} bench config 3 (N = {ctx.params.N}, {len(ctx.params.moduli)} limbs, scale "
          f"2^{ctx.params.scale_bits}) to {ctx_f.params.name} (n = {ctx_f.params.n}, q = "
          f"{ctx_f.params.q}, q_ks = {ctx_f.params.q_ks}): ckks_to_fhew_setup "
          f"{time.perf_counter() - t0:.3f} s (host clock: {len(key.rot_keys)} rotation keys and "
          f"the "
          f"ring-to-FHEW switching key {tuple(key.ksk.a.shape)}, "
          f"{_nbytes(key.ksk.a, key.ksk.b) / 1e9:.2f} GB as int32)")
    z = rng.integers(0, 4, size=n)
    ct = ctx.encrypt(pk, z.astype(np.float64), rng)
    with recorded_switch() as switched:
        cts = run("eval_ckks_to_fhew", lambda: ss.eval_ckks_to_fhew(
            ctx, key, ct, p=4, fhew_params=ctx_f.params), f"{n} diagonals")
    ss_switch_check(tag, ctx_f, sk, sk_f, switched[0], cts, z, card)

    # compare at p = 8: EvalSign from q_ks = 16 q
    z1 = rng.integers(0, 4, size=n)
    z2 = (z1 + rng.integers(1, 4, size=n)) % 4
    ct1 = ctx.encrypt(pk, z1.astype(np.float64), rng)
    ct2 = ctx.encrypt(pk, z2.astype(np.float64), rng)
    rec = RecordingSign(ctx_f)
    out = run("eval_compare_scheme_switching", lambda: ss.eval_compare_scheme_switching(
        ctx, key, ct1, ct2, rec, key_f, p=8), f"{n} diagonals")
    total.update(ss_sign_check(tag, ctx_f, sk_f, key_f, rec, out, (z1 < z2).astype(np.int64),
                               card))
    del key, rec

    # FHEW -> CKKS of the AND outputs at N = 2^14, on a chain as deep as the sine
    K = int(3 * np.sqrt(ctx_f.params.n)) + 8
    depth = fhew_to_ckks_depth(K)
    p2 = params.make_ckks_params(**SS_F2C_CONFIG, num_levels=depth)
    ctx2 = ckks.CkksContext(p2, dev)
    log_qp = sum(math.log2(q) for q in p2.moduli + p2.special_mods)
    scales = [math.log2(v) for v in ckks._level_scales(p2).values()]
    print(f"{tag} FHEW -> CKKS chain: the sine for n = {ctx_f.params.n} (K = {K}, degree "
          f"{len(bootstrap._sine_cheb_coeffs(K, 3, 1e-7)) - 1}) and the two rescales around it "
          f"take {depth} levels: N = {p2.N}, scale 2^{p2.scale_bits} at composite degree "
          f"{p2.composite_degree}, dnum = {p2.num_part_q}, track_scale (level scales 2^"
          f"{min(scales):.3f} to 2^{max(scales):.3f}), "
          f"{len(p2.moduli)} + {len(p2.special_mods)} limbs, log2 QP = {log_qp:.2f} (the HE "
          f"standard's 128-bit bound at this N: "
          f"{stdparams.max_log_q(p2.N, '128_classic', 'ternary')}"
          f"; ROADMAP queue 3)")
    rng = np.random.default_rng(SEED + 61)
    sk2, pk2 = ctx2.keygen(rng)
    evk2 = ctx2.relin_key_gen(sk2, rng)
    t0 = time.perf_counter()
    k2 = ss.fhew_to_ckks_setup(ctx2, sk2, sk_f, pk2, rng)
    torch.cuda.synchronize()
    print(f"{tag} fhew_to_ckks_setup: {time.perf_counter() - t0:.3f} s (host clock; "
          f"{len(k2.rot_keys)} rotation keys)")
    res = run(f"eval_fhew_to_ckks of [main]'s {len(and_want)} AND outputs", lambda: (
        ss.eval_fhew_to_ckks(ctx2, k2, and_out, evk2)), f"{n} diagonals and the sine's constants")
    ss_fhew_to_ckks_check(tag, ctx2, sk2, res, sk_f, and_out, and_want, card)
    del k2, ctx2

    total.update(ss_minmax(tag, dev, card, shapes))
    limb_kernels_at(tag, "[ss] call", dev, shapes, {}, errors, int_multiply_peak(dev), card)
    print(f"{tag} the phase took {time.perf_counter() - t_phase:.3f} s (host clock)")
    return total


def ss_minmax(tag: str, dev, card: str, shapes: collections.Counter) -> collections.Counter:
    """Min and max at N = 2^11 with TOY_RADIX keyed on the card (the wide
    rotation kernels): tests/test_schemeswitch.py's chain (18 levels, scale
    2^26, dnum 2), values and bounds; compare and the _alt forms."""
    from fhe_tpu_torch import BinFheContext
    from fhe_tpu_torch.pke import ckks
    from fhe_tpu_torch.pke import schemeswitch as ss
    total = collections.Counter()
    rng = np.random.default_rng(SEED + 62)
    t0 = time.perf_counter()
    tctx = BinFheContext.generate(RADIX_SET, device=dev)
    tsk = tctx.key_gen(rng)
    tkey = tctx.bt_key_gen(tsk, rng)
    ctx = ckks.CkksContext.create(N=SS_SMALL_N, num_levels=18, scale_bits=26, dnum=2, device=dev)
    sk, pk = ctx.keygen(rng)
    evk = ctx.relin_key_gen(sk, rng)
    key = ss.ckks_to_fhew_setup(ctx, sk, tctx.params, tsk, rng)
    k2 = ss.fhew_to_ckks_setup(ctx, sk, tsk, pk, rng)
    rot = ctx.rotation_key_gen(sk, sorted(set(ss.min_max_rotation_indices(4))), rng)
    torch.cuda.synchronize()
    print(f"{tag} N = {SS_SMALL_N} (18 levels, scale 2^26, dnum 2) with {RADIX_SET} (N = "
          f"{tctx.params.N}, n = {tctx.params.n}, q_ks = {tctx.params.q_ks}): keys "
          f"{time.perf_counter() - t0:.3f} s (host clock)")
    slots = ctx.params.N // 2

    def counted_call(call, fn):
        out, launches, sh = counted(tag, call, fn, limb_only=False)
        total.update(launches)
        shapes.update(sh)
        return out

    z1, z2 = np.zeros(slots), np.zeros(slots)
    z1[:4] = [1.0, 3.0, 2.0, 0.0]
    z2[:4] = [2.0, 1.0, 4.0, 3.0]
    out = counted_call("compare (4 pairs)", lambda: ss.eval_compare_scheme_switching(
        ctx, key, ctx.encrypt(pk, z1, rng), ctx.encrypt(pk, z2, rng), tctx, tkey, num_values=4))
    got = tctx.decrypt(tsk, dataclasses.replace(out, pt_mod=2), 2).cpu().numpy()
    want = (z1[:4] < z2[:4]).astype(int)
    print(f"{tag} N = {SS_SMALL_N} compare: {got.tolist()} (want {want.tolist()})")
    if (got != want).any():
        fail(f"{tag} compare at N = {SS_SMALL_N} is wrong")
    z = np.zeros(slots)
    z[:4] = [3.0, 1.0, 2.0, 4.0]
    zz = np.zeros(slots)
    zz[:2] = [1.0, 3.0]
    for alt in (False, True):
        fmin = ss.eval_min_scheme_switching_alt if alt else ss.eval_min_scheme_switching
        fmax = ss.eval_max_scheme_switching_alt if alt else ss.eval_max_scheme_switching
        name = "_alt" if alt else ""
        mn, ind = counted_call(f"min{name} of 4", lambda: fmin(
            ctx, key, k2, ctx.encrypt(pk, z, rng), tctx, tkey, evk, rot, num_values=4))
        mx, _ = counted_call(f"max{name} of 2", lambda: fmax(
            ctx, key, k2, ctx.encrypt(pk, zz, rng), tctx, tkey, evk, rot, num_values=2))
        v_min, v_ind = ctx.decrypt(sk, mn).real[0], ctx.decrypt(sk, ind).real[:4]
        v_max = ctx.decrypt(sk, mx).real[0]
        print(f"{tag} N = {SS_SMALL_N} min{name} of [3, 1, 2, 4]: {v_min:.4f}, argmin indicator "
              f"{np.round(v_ind, 4).tolist()}; max{name} of [1, 3]: {v_max:.4f} (bounds 0.2 and "
              f"argmin > 0.6, tests/test_schemeswitch.py:127-148)")
        if not (abs(v_min - 1) < 0.2 and np.argmax(v_ind) == 1 and v_ind[1] > 0.6
                and abs(v_max - 3) < 0.2):
            fail(f"{tag} min/max{name} at N = {SS_SMALL_N} outside the bounds")
    if not total["blind_rotate_wide"]:
        fail(f"{tag} the min/max runs launched no wide rotation kernel")
    return total


# ---------------------------------------------------------------------------
# the trapdoor, arbitrary-cyclotomic, threshold, witness and packed phases
# ---------------------------------------------------------------------------

def launches_of(fn):
    """fn() with the launch counters reset just before and read just after:
    (its result, the launches of each kernel)."""
    from fhe_tpu_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts()


def nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def td_run(dev) -> tuple:
    """[td]'s trapdoor and TD_SYNDROMES preimages by each sampler on dev,
    from SEED + 16: (trapdoor, syndromes, gauss_samp's, gauss_samp_corrected's)."""
    from fhe_tpu_torch.lattice import trapdoor
    rng = np.random.default_rng(SEED + 16)
    td = trapdoor.trapdoor_gen(trapdoor.TrapdoorParams(**TD_CONFIG), rng, device=dev)
    us = [rng.integers(0, td.params.q, size=td.params.N) for _ in range(TD_SYNDROMES)]
    return (td, us, [trapdoor.gauss_samp(td, u, rng) for u in us],
            [trapdoor.gauss_samp_corrected(td, u, rng) for u in us])


def td_phase(dev, card: str) -> dict:
    """[td]: trapdoor_gen and both samplers at TD_CONFIG on the card; every
    preimage verified, the card byte-equal to the CPU, the corrected
    sampler's spread within fhe_tpu's bounds; returns the run's launches."""
    import math as m_
    from fhe_tpu_torch.lattice import trapdoor
    tag, t_phase = "[td]", time.perf_counter()
    params = trapdoor.TrapdoorParams(**TD_CONFIG)
    print(f"{tag} N = {params.N}, q = {params.q} (STD128's Q, {params.q.bit_length()} bits), "
          f"base {params.base}: k = {params.k}, a public row of {params.k + 2} polynomials, "
          f"sigma {params.sigma}")
    t0 = time.perf_counter()
    (td, us, xs, xcs), launches = launches_of(lambda: td_run(dev))
    print(f"{tag} trapdoor_gen and {TD_SYNDROMES} preimages by each sampler on the card: "
          f"{time.perf_counter() - t0:.3f} s (host clock, with the host draws); launches "
          f"{nonzero(launches)}")
    for what, x_all in (("gauss_samp", xs), ("gauss_samp_corrected", xcs)):
        if not all(trapdoor.verify_preimage(td, x, u) for x, u in zip(x_all, us)):
            fail(f"{tag} a {what} preimage does not verify")
    bad = xs[0].clone()
    bad[2, 0] = (bad[2, 0] + 1) % params.q
    if trapdoor.verify_preimage(td, bad, us[0]):
        fail(f"{tag} a changed preimage verified")
    print(f"{tag} all {2 * TD_SYNDROMES} preimages verify on the card (<A, x> = u mod q); a "
          f"changed one does not")
    for name, call in (("gauss_samp", trapdoor.gauss_samp),
                       ("gauss_samp_corrected", trapdoor.gauss_samp_corrected)):
        _, one = launches_of(lambda: call(td, us[0], np.random.default_rng(1)))
        _, ver = launches_of(lambda: trapdoor.verify_preimage(td, xs[0], us[0]))
        print(f"{tag} kernels 1-2's launches a {name} call: {nonzero(one)}; a verify_preimage: "
              f"{nonzero(ver)}")
    t0 = time.perf_counter()
    c_td, c_us, c_xs, c_xcs = td_run("cpu")
    for what, a, b in [("a_row", td.a_row, c_td.a_row), ("r", td.pair.r, c_td.pair.r),
                       ("e", td.pair.e, c_td.pair.e)] + [
            (f"gauss_samp x{i}", x, c) for i, (x, c) in enumerate(zip(xs, c_xs))] + [
            (f"gauss_samp_corrected x{i}", x, c) for i, (x, c) in enumerate(zip(xcs, c_xcs))]:
        if not torch.equal(a.cpu(), b):
            fail(f"{tag} {what} differs between the card and the CPU")
    print(f"{tag} the CPU port from the same seed: a_row, r, e and all {2 * TD_SYNDROMES} "
          f"preimages byte-equal to the card's ({time.perf_counter() - t0:.3f} s on the CPU)")
    alpha = params.sigma * (params.base + 1)
    s = alpha * params.sigma * 1.2 * (m_.sqrt(2 * params.N) + m_.sqrt(params.k * params.N) + 4.7)
    q = params.q
    for i, x in enumerate(xcs):
        xc = torch.where(x > q // 2, x - q, x).to(torch.float64)
        big, std = float(xc.abs().max()), float(xc.std())
        print(f"{tag} gauss_samp_corrected x{i}: max |x| = {big:.0f} = {big / s:.3f} s, std = "
              f"{std:.3f} = {std / s:.4f} s (s = {s:.3f}; fhe_tpu's bounds: max < 10 s, "
              f"0.2 s < std < 3 s)")
        if not (big < 10 * s and 0.2 * s < std < 3.0 * s):
            fail(f"{tag} gauss_samp_corrected x{i} outside fhe_tpu's bounds")
    print(f"{tag} the phase took {time.perf_counter() - t_phase:.3f} s (host clock)")
    return launches


def arb_run(dev) -> dict:
    """[arb]'s transforms on dev at each length of ARB_MS and ARB_BIG_M:
    m -> (q, x, its Bluestein DFT and back, a, b, forward_arb(a), its
    inverse, multiply_arb(a, b))."""
    from fhe_tpu_torch.math import ntt_arb, primes
    out = {}
    for m in (*ARB_MS, ARB_BIG_M):
        q = primes.first_prime(28, 2 * m)
        phi = len(ntt_arb.cyclotomic_poly(m)) - 1
        rng = np.random.default_rng(SEED + m)
        x = rng.integers(0, q, size=m)
        a, b = rng.integers(0, q, size=phi), rng.integers(0, q, size=phi)
        dft = ntt_arb.bluestein_dft(x, m, q, device=dev)
        back = ntt_arb.bluestein_dft(dft, m, q, inverse=True, device=dev)
        fa = ntt_arb.forward_arb(a, m, q, device=dev)
        out[m] = (q, x, dft, back, a, b, fa, ntt_arb.inverse_arb(fa, m, q, device=dev),
                  ntt_arb.multiply_arb(a, b, m, q, device=dev))
    return out


def mod_prime_cyclotomic(full: np.ndarray, m: int, q: int) -> np.ndarray:
    """An integer polynomial mod (Phi_m, q) for a prime m, independently of
    ntt_arb: fold mod X^m - 1, then X^(m-1) = -(1 + ... + X^(m-2))."""
    c = np.zeros(m, dtype=object)
    for k in range(0, len(full), m):
        part = full[k:k + m]
        c[:len(part)] += part
    return np.array([int(v) % q for v in c[:m - 1] - c[m - 1]], dtype=np.int64)


def arb_phase(dev, card: str) -> dict:
    """[arb]: Bluestein DFTs, forward_arb / inverse_arb and multiply_arb on
    the card at ARB_MS (the small-N kernels) against a naive DFT and a
    schoolbook product, and at ARB_BIG_M (limb-stacked, L = 2^13) the round
    trip and the product against the exact convolution mod (Phi_m, q);
    the card byte-equal to the CPU.  Returns the run's launches."""
    from fhe_tpu_torch.math import ntt_arb
    tag, t_phase = "[arb]", time.perf_counter()
    t0 = time.perf_counter()
    card_out, launches = launches_of(lambda: arb_run(dev))
    print(f"{tag} m = {ARB_MS} and {ARB_BIG_M} on the card: {time.perf_counter() - t0:.3f} s "
          f"(host clock, with the exact host arithmetic); launches {nonzero(launches)}")
    for m, (q, x, dft, back, a, b, fa, inv, prod) in card_out.items():
        L = 1 << (2 * m - 2 + m - 1).bit_length()
        if not (np.array_equal(back, x) and np.array_equal(inv, a)):
            fail(f"{tag} m = {m}: a round trip is not the identity")
        full = np.convolve(a.astype(object), b.astype(object))
        if m in ARB_MS:
            w = pow(ntt_arb.bluestein_plan(m, q).psi, 2, q)
            naive = [sum(int(x[k]) * pow(w, j * k, q) for k in range(m)) % q for j in range(m)]
            if [int(v) for v in dft] != naive:
                fail(f"{tag} m = {m}: the Bluestein DFT differs from the naive DFT")
            want = ntt_arb._poly_mod_cyclo(full, m, q)
        else:
            want = mod_prime_cyclotomic(full, m, q)
        if not np.array_equal(prod, want):
            fail(f"{tag} m = {m}: multiply_arb differs from the schoolbook product")
        print(f"{tag} m = {m}, q = {q}, phi = {len(a)}, convolutions padded to L = {L}: "
              + ("DFT = the naive DFT, " if m in ARB_MS else "") +
              f"the DFT and arb round trips exact, multiply_arb = the schoolbook product mod "
              f"(Phi_m, q)")
    t0 = time.perf_counter()
    cpu_out = arb_run("cpu")
    for m in card_out:
        for got, want in zip(card_out[m], cpu_out[m]):
            if not np.array_equal(np.asarray(got), np.asarray(want)):
                fail(f"{tag} m = {m}: the card differs from the CPU")
    print(f"{tag} the CPU port: every output at every m byte-equal to the card's "
          f"({time.perf_counter() - t0:.3f} s on the CPU)")
    print(f"{tag} the phase took {time.perf_counter() - t_phase:.3f} s (host clock)")
    return launches


class SecretsStream:
    """A seeded byte stream in place of secrets.token_bytes (the threshold
    shares and masks, the commitments' randomness), so that the card's and
    the CPU's runs draw the same bytes."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def __call__(self, n: int) -> bytes:
        return self.rng.bytes(n)


@contextlib.contextmanager
def secrets_stream(seed: int):
    import secrets
    inner = secrets.token_bytes
    secrets.token_bytes = SecretsStream(seed)
    try:
        yield
    finally:
        secrets.token_bytes = inner


def thr_run(and_out, s, ext, s_n) -> list:
    """[thr]'s protocol runs on the devices of its inputs, with SEED + 17's
    secrets stream: additive 3-of-3 with proofs on the AND outputs (secret
    s), Shamir 2-of-3 on the extended ones (ring secret s_n), each 2-subset;
    returns every share, partial, proof and combine, in order."""
    from fhe_tpu_torch.tfhe import threshold as th
    out = []
    with secrets_stream(SEED + 17):
        cfg = th.ThresholdConfig(threshold=3, total_parties=3, scheme="additive")
        shares, vks = th.generate_key_shares(s, and_out.modulus, cfg)
        pds = []
        for sh, vk in zip(shares, vks):
            pd, pf = th.batch_partial_decrypt(cfg, and_out, sh)
            ok = th.batch_verify_proofs(cfg, and_out, pd, pf, vk)
            bad = th.BatchPartialDecryption(pd.party_id, (pd.values + 1) % and_out.modulus,
                                            pd.batch_commitment)
            rejected = not th.batch_verify_proofs(cfg, and_out, bad, pf, vk)
            pds.append(pd)
            out += [sh.share, sh.commitment, pd.values, pd.batch_commitment, pf.commitments_R,
                    pf.merkle_root, pf.batch_challenge, pf.response, ok, rejected]
        out.append(th.batch_combine(cfg, and_out, pds, p=4))
        cfg = th.ThresholdConfig(threshold=2, total_parties=3, scheme="shamir")
        shares, vks = th.generate_key_shares(s_n, ext.modulus, cfg)
        out += [sh.share for sh in shares]
        for subset in ([0, 1], [0, 2], [1, 2]):
            out.append(th.threshold_decrypt(cfg, ext, [shares[i] for i in subset], vks, p=4))
    return out


def thr_phase(dev, card: str, ctx, sk, key, cts) -> dict:
    """[thr]: threshold decryption of 4096 STD128 AND outputs of [main]'s
    key, additive 3-of-3 with proofs (each verified, a tampered partial
    rejected), and Shamir 2-of-3 on 4096 extended outputs under the key's
    ring secret (bt_key_gen's first draw, made again from SEED); 0 wrong;
    the CPU port's calls on the same ciphertexts copied to the host, with
    the same secrets stream, byte-equal.  Returns the run's launches."""
    tag, t_phase = "[thr]", time.perf_counter()
    ct1, ct2 = cts[0], cts[1]
    truth = (ctx.decrypt(sk, ct1) & ctx.decrypt(sk, ct2)).cpu().numpy()
    rng = np.random.default_rng(SEED)
    ctx.key_gen(rng)
    sk_n = ctx.key_gen_n(rng)           # bt_key_gen's first draw after sk
    t0 = time.perf_counter()

    def run():
        and_out = ctx.eval_bin_gate(key, "AND", ct1, ct2)
        ext = ctx.eval_bin_gate(key, "AND", ct1, ct2, extended=True)
        return and_out, ext, thr_run(and_out, sk.s, ext, sk_n.s)
    (and_out, ext, got), launches = launches_of(run)
    print(f"{tag} AND and extended AND (N = {ext.n}, modulus {ext.modulus}) of [main]'s {BATCH} "
          f"pairs, 3-of-3 additive with proofs and Shamir 2-of-3 of each subset on the card: "
          f"{time.perf_counter() - t0:.3f} s (host clock, with the hashing); launches "
          f"{nonzero(launches)}")
    checks = got[:30]
    for i in range(3):
        if not checks[10 * i + 8]:
            fail(f"{tag} party {i + 1}'s proof does not verify")
        if not checks[10 * i + 9]:
            fail(f"{tag} party {i + 1}'s tampered partial was not rejected")
    print(f"{tag} additive 3-of-3: every proof verifies, every tampered partial (values + 1) is "
          f"rejected")
    for what, m in [("additive 3-of-3 combine", got[30])] + [
            (f"Shamir 2-of-3 subset {sub}", got[34 + i])
            for i, sub in enumerate(([1, 2], [1, 3], [2, 3]))]:
        wrong = int((m.cpu().numpy() != truth).sum())
        print(f"{tag} {what}: {wrong} wrong of {BATCH}")
        if wrong:
            fail(f"{tag} {what} does not decrypt to the AND truth table")
    t0 = time.perf_counter()
    on_cpu = thr_run(and_out.to("cpu"), sk.s.cpu(), ext.to("cpu"), sk_n.s.cpu())
    for i, (a, b) in enumerate(zip(got, on_cpu)):
        same = torch.equal(a.cpu(), b) if isinstance(a, torch.Tensor) else a == b
        if not same:
            fail(f"{tag} output {i} of the protocol differs between the card and the CPU")
    print(f"{tag} the CPU port's threshold calls on the ciphertexts copied to the host, same "
          f"secrets stream: all {len(got)} shares, partials, commitments, proofs and combines "
          f"byte-equal ({time.perf_counter() - t0:.3f} s on the CPU)")
    print(f"{tag} the phase took {time.perf_counter() - t_phase:.3f} s (host clock)")
    return launches


def adder(ctx, key, wb, zkp, a_idx, b_idx, a_cts, b_cts):
    """An 8-bit ripple-carry adder of STD128 gates at batch 1, every gate
    recorded by the WitnessBuilder wb; returns the sum's bits (LSB first,
    the carry last) and their table indices."""
    gates = {"AND": zkp.GateType.AND, "OR": zkp.GateType.OR, "XOR": zkp.GateType.XOR}

    def gate(name, x, y):
        out = ctx.eval_bin_gate(key, name, x[0], y[0])
        return out, wb.record_gate(gates[name], [x[1], y[1]], out)
    outs, carry = [], None
    for i in range(len(a_cts)):
        x, y = (a_cts[i], a_idx[i]), (b_cts[i], b_idx[i])
        t = gate("XOR", x, y)
        if carry is None:
            outs.append(t)
            carry = gate("AND", x, y)
            continue
        outs.append(gate("XOR", t, carry))
        carry = gate("OR", gate("AND", x, y), gate("AND", t, carry))
    return outs + [carry]


def zkp_phase(dev, card: str, ctx, sk, key) -> dict:
    """[zkp]: an 8-bit ripple-carry adder of STD128 gates at batch 1 on the
    card, recorded by a WitnessBuilder (security parameter 80): the sum
    right, the witness verified, a tampered gate and a wrong root rejected,
    every sampled gate replayed on the card from its opened inputs to the
    committed output bytes.  Returns the adder's launches."""
    import copy
    from fhe_tpu_torch.tfhe import lwe, zkp
    tag, t_phase = "[zkp]", time.perf_counter()
    rng = np.random.default_rng(SEED + 18)
    va, vb = (int(v) for v in rng.integers(0, 1 << ZKP_BITS, size=2))
    a_cts = [ctx.encrypt(sk, np.array([va >> i & 1]), rng) for i in range(ZKP_BITS)]
    b_cts = [ctx.encrypt(sk, np.array([vb >> i & 1]), rng) for i in range(ZKP_BITS)]
    with secrets_stream(SEED + 19):
        wb = zkp.WitnessBuilder(f"ripple-carry-{ZKP_BITS}")
        a_idx = [wb.register_input(c) for c in a_cts]
        b_idx = [wb.register_input(c) for c in b_cts]
        t0 = time.perf_counter()
        outs, launches = launches_of(lambda: adder(ctx, key, wb, zkp, a_idx, b_idx, a_cts, b_cts))
        circuit_s = time.perf_counter() - t0
        for _, idx in outs:
            wb.mark_output(idx)
        t0 = time.perf_counter()
        w = wb.build()
        build_s = time.perf_counter() - t0
    got = sum(int(ctx.decrypt(sk, c)[0]) << i for i, (c, _) in enumerate(outs))
    n_gates = len(wb.gates) - 2 * ZKP_BITS - len(outs)
    print(f"{tag} {va} + {vb} = {got} ({n_gates} STD128 gates at batch 1, recorded: "
          f"{circuit_s:.3f} s host clock; launches {nonzero(launches)}); witness of "
          f"{w.num_gates} records and {w.num_ciphertexts} ciphertexts, "
          f"{len(w.verification_points)} gates sampled, built in {build_s:.3f} s")
    if got != va + vb:
        fail(f"{tag} the adder's sum decrypts to {got}, not {va + vb}")
    verifier = zkp.WitnessVerifier()
    if not verifier.verify(w):
        fail(f"{tag} the witness does not verify")
    bad = copy.deepcopy(w)
    g = bad.verification_points[0].gate
    g.type = zkp.GateType.OR if g.type != zkp.GateType.OR else zkp.GateType.AND
    wrong_root = copy.deepcopy(w)
    wrong_root.ciphertext_root = bytes(32)
    if verifier.verify(bad) or verifier.verify(wrong_root):
        fail(f"{tag} a tampered gate record or a wrong root verified")
    print(f"{tag} the witness verifies; a tampered gate record and a wrong ciphertext root are "
          f"rejected")
    names = {zkp.GateType.AND: "AND", zkp.GateType.OR: "OR", zkp.GateType.XOR: "XOR"}

    def from_bytes(blob: bytes):
        words = np.frombuffer(blob, dtype="<u8").astype(np.int64)
        return lwe.LweCiphertext(a=torch.from_numpy(words[None, :-2].astype(np.int32)).to(dev),
                                 b=torch.from_numpy(words[None, -2].astype(np.int32)).to(dev),
                                 modulus=int(words[-1]))
    t0 = time.perf_counter()
    for vp in w.verification_points:
        replay = lambda ins, t=vp.gate.type: zkp._ct_bytes(
            ctx.eval_bin_gate(key, names[t], *(from_bytes(b) for b in ins)), 0)
        ok = verifier.verify_gate_recomputation(
            w, vp, replay, [wb.table.opening(i) for i in vp.gate.input_indices],
            wb.table.opening(vp.gate.output_index))
        if not ok:
            fail(f"{tag} sampled gate {vp.gate_index} does not replay to its committed output")
    print(f"{tag} all {len(w.verification_points)} sampled gates replayed on the card from their "
          f"opened inputs: each gives its committed output bytes ({time.perf_counter() - t0:.3f} "
          f"s host clock)")
    print(f"{tag} the phase took {time.perf_counter() - t_phase:.3f} s (host clock)")
    return launches


def pack_phase(dev, card: str, ctx, key, cts) -> dict:
    """[pack]: STD128's bootstrap and switching keys packed and unpacked on
    the card, a batch-4096 AND through the unpacked key byte-identical to
    the AND through the key itself, and the LWE batch round trip in both
    layouts.  Returns the AND's launches."""
    from fhe_tpu_torch.tfhe import packed
    tag, t_phase = "[pack]", time.perf_counter()
    p = ctx.params
    t0 = time.perf_counter()
    blob = packed.pack_bsk(p, key)
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    key2 = packed.unpack_bsk(p, blob, device=dev)
    torch.cuda.synchronize()
    unpack_s = time.perf_counter() - t0
    ksk2, q_ks = packed.unpack_switching_key(packed.pack_switching_key(key.ksk, p.q_ks),
                                             device=dev)
    if not (torch.equal(key2.bsk, key.bsk) and torch.equal(key2.ksk.a, key.ksk.a) and
            torch.equal(ksk2.b, key.ksk.b) and q_ks == p.q_ks):
        fail(f"{tag} the unpacked keys differ from the keys")
    print(f"{tag} STD128 bootstrap key (with its switching key) packed to {len(blob)} bytes in "
          f"{pack_s:.3f} s and unpacked onto the card in {unpack_s:.3f} s (host clock); equal")
    ct1, ct2 = cts[0], cts[1]
    want = ctx.eval_bin_gate(key, "AND", ct1, ct2)
    got, launches = launches_of(lambda: ctx.eval_bin_gate(key2, "AND", ct1, ct2))
    if not (torch.equal(got.a, want.a) and torch.equal(got.b, want.b)):
        fail(f"{tag} the AND through the unpacked key differs")
    print(f"{tag} AND at batch {BATCH} through the unpacked key: byte-identical to the AND "
          f"through the key; launches {nonzero(launches)}")
    for flags, what in ((packed.LWE_PACK_DEFAULT, "sequential"),
                        (packed.LWE_PACK_INTERLEAVED, "interleaved")):
        back = packed.unpack_lwe_batch(packed.pack_lwe_batch(ct1, flags), device=dev)
        if not (torch.equal(back.a, ct1.a) and torch.equal(back.b, ct1.b) and
                (back.modulus, back.pt_mod) == (ct1.modulus, ct1.pt_mod)):
            fail(f"{tag} the {what} LWE batch round trip differs")
    print(f"{tag} LWE batch of {BATCH} packed and unpacked, sequential and interleaved: equal")
    print(f"{tag} the phase took {time.perf_counter() - t_phase:.3f} s (host clock)")
    return launches


def lwe_equal(a, b) -> bool:
    return (a.modulus, a.pt_mod) == (b.modulus, b.pt_mod) and torch.equal(a.a, b.a) and \
        torch.equal(a.b, b.b)


def ser_phase(dev, card: str, sk, and_out) -> dict:
    """[ser]: [main]'s AND outputs and LWE secret through utils/serial
    (binary and JSON) on the card, equal after the round trip and
    byte-identical to the CPU port's archives (the outputs copied to the
    host, the secret made again from SEED on the CPU); the reference's
    PKE cereal archives byte for byte through serial_ref_pke; its LWE
    archives onto the card and decrypted to the manifest's bits; an euint8
    through FheContext.serialize_ciphertext and back.  Returns the run's
    launches."""
    import io
    from fhe_tpu_torch import BinFheContext
    from fhe_tpu_torch.tfhe import lwe, make_params
    from fhe_tpu_torch.tfhe.fhevm import EncryptedInt, FheContext, FheType
    from fhe_tpu_torch.tfhe.radix import RadixInt
    from fhe_tpu_torch.utils import serial, serial_ref, serial_ref_pke
    tag, t_phase = "[ser]", time.perf_counter()
    cpu_sk = BinFheContext.generate("STD128", device="cpu").key_gen(np.random.default_rng(SEED))

    def run():
        for obj, cpu_obj, what in ((and_out, and_out.to("cpu"), f"{BATCH} AND outputs"),
                                   (sk, cpu_sk, "LWE secret")):
            for mode in ("binary", "json"):
                t0 = time.perf_counter()
                blob = serial.dumps(obj, mode)
                t1 = time.perf_counter()
                back = serial.loads(blob, mode, device=dev)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                if what == "LWE secret":
                    same = torch.equal(back.s, obj.s) and back.s.device == obj.s.device
                else:
                    same = lwe_equal(back, obj) and back.a.device == obj.a.device
                if not same:
                    fail(f"{tag} {what} ({mode}) differ after the round trip on the card")
                if blob != serial.dumps(cpu_obj, mode):
                    fail(f"{tag} {what} ({mode}): the card's archive differs from the CPU port's")
                print(f"{tag} {what}, {mode}: {len(blob)} bytes, dumps {1e3 * (t1 - t0):.3f} ms, "
                      f"loads onto {dev} {1e3 * (t2 - t1):.3f} ms (host clock); equal after the "
                      f"round trip, byte-identical to the CPU port's archive")
        header = json.loads(bytes(np.load(io.BytesIO(serial.dumps(and_out)))["__header__"]))
        if header["spec"]["r"]["type"] != "fhe_tpu.tfhe.lwe.LweCiphertext":
            fail(f"{tag} the archive's type tag is {header['spec']['r']['type']}")
        print(f"{tag} the archive names fhe_tpu.tfhe.lwe.LweCiphertext, its words uint32: "
              f"fhe_tpu's wire format")
        for kind, name in (("context", "pke_cc.bin"), ("private_key", "pke_sk.bin"),
                           ("public_key", "pke_pk.bin"), ("ciphertext", "pke_ct.bin"),
                           ("ciphertext", "pke_ct2.bin")):
            with open(f"{VECTORS}/{name}", "rb") as f:
                raw = f.read()
            if serial_ref_pke.dump_binary(serial_ref_pke.load_binary(f"{VECTORS}/{name}",
                                                                     kind), kind) != raw:
                fail(f"{tag} tests/vectors/{name} does not come back byte for byte")
        print(f"{tag} tests/vectors/pke_{{cc,sk,pk,ct,ct2}}.bin: dump_binary(load_binary(...)) "
              f"byte-identical")
        with open(f"{VECTORS}/manifest_pke.json") as f:
            bits = json.load(f)["serial_lwe"]["bits"]
        v = np.load(f"{VECTORS}/serial_lwe_sk.npy").astype(np.int64)
        ref_sk = lwe.LweSecretKey(s=torch.from_numpy(np.where(v > 1, -1, v).astype(np.int32)).to(dev))
        got = []
        for bit in bits:
            for load, ext in ((serial_ref.load_lwe_binary, "bin"), (serial_ref.load_lwe_json,
                                                                    "json")):
                ct = load(f"{VECTORS}/serial_lwe_ct{bit}.{ext}", device=dev)
                got.append(int(lwe.decrypt(make_params("TOY"), ref_sk, ct, p=4)))
        if got != [b for b in bits for _ in range(2)]:
            fail(f"{tag} the reference's LWE archives decrypt to {got}, not {bits}")
        print(f"{tag} tests/vectors/serial_lwe_ct{{0,1}}.{{bin,json}} loaded onto {dev} and "
              f"decrypted with serial_lwe_sk.npy: {got} (the manifest's bits {bits})")
        t0 = time.perf_counter()
        fc = FheContext.create(RADIX_SET, rng=SEED + 42, device=dev)
        rng = np.random.default_rng(SEED + 43)
        vals = rng.integers(0, 256, size=RADIX_PAIRS)
        x = fc.encrypt(vals, FheType.EUINT8, rng)
        blob = fc.serialize_ciphertext(x)
        back = fc.deserialize_ciphertext(blob)
        x_cpu = EncryptedInt(RadixInt(x.value.ct.to("cpu"), x.value.rp, x.value.max_limb),
                             x.fhe_type)
        if not (lwe_equal(back.value.ct, x.value.ct) and back.fhe_type is FheType.EUINT8 and
                back.value.ct.a.device == x.value.ct.a.device and
                blob == serial.dumps(x_cpu)):
            fail(f"{tag} the euint8 ciphertext differs after serialize/deserialize_ciphertext")
        wrong = int((np.asarray(fc.decrypt(back), dtype=np.int64) != vals).sum())
        if wrong:
            fail(f"{tag} {wrong} deserialized euint8 values decrypt wrong")
        print(f"{tag} {RADIX_SET} keyed and {RADIX_PAIRS} euint8 encrypted "
              f"({time.perf_counter() - t0:.3f} s); serialize_ciphertext {len(blob)} bytes, "
              f"deserialize_ciphertext onto {dev}: equal, byte-identical to the CPU port's "
              f"archive, {wrong} wrong of {RADIX_PAIRS}")
    _, launches = launches_of(run)
    print(f"{tag} launches {nonzero(launches)}; the phase took "
          f"{time.perf_counter() - t_phase:.3f} s (host clock)")
    return launches


def srv_request(base: str, path: str, payload: dict | None = None):
    """(reply, wall ms) of one request to the port's server."""
    import urllib.request
    t0 = time.perf_counter()
    if payload is None:
        with urllib.request.urlopen(base + path, timeout=300) as r:
            body = r.read()
    else:
        req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            body = r.read()
    return json.loads(body), 1e3 * (time.perf_counter() - t0)


def srv_phase(dev, card: str) -> dict:
    """[srv]: the port's server in a thread on 127.0.0.1 (an ephemeral
    port), its contexts on the card: /health, /context STD128, /keygen from
    SRV_SEED, /encrypt of 2 x BATCH random bits, /v1/eval/and, /gate XOR,
    /not and /decrypt of each over HTTP, 0 wrong against the truth tables;
    kernel 3 launched once a gate request (counters reset before and read
    after each); every returned archive byte-identical to the port's
    BinFheContext called directly from the same seeds; each request's wall
    time and the gate's device time (CUDA events, utils/profiling's
    "server.gate" stage).  Returns the gate requests' launches."""
    import base64
    import threading
    from fhe_tpu_torch import BinFheContext, kernels, server
    from fhe_tpu_torch.utils import profiling, serial
    tag, t_phase = "[srv]", time.perf_counter()
    httpd = server.make_server(0, device=dev)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    total = collections.Counter()
    try:
        health, ms = srv_request(base, "/health")
        if (health["backend"], health["device"], health["devices"]) != (
                dev.type, str(dev), torch.cuda.device_count()):
            fail(f"{tag} /health does not report the card: {health}")
        print(f"{tag} GET /health on {base}: {health} ({ms:.3f} ms)")
        cid, ms = srv_request(base, "/context", {"param_set": "STD128"})
        cid = cid["context_id"]
        print(f"{tag} POST /context STD128: {ms:.3f} ms")
        kid, ms = srv_request(base, "/keygen", {"context_id": cid, "seed": SRV_SEED})
        kid = kid["key_id"]
        print(f"{tag} POST /keygen (seed {SRV_SEED}): {ms:.3f} ms")
        rng = np.random.default_rng(SRV_SEED + 1)
        m1, m2 = (rng.integers(0, 2, size=BATCH) for _ in range(2))
        cts = []
        for m, seed in ((m1, SRV_SEED + 2), (m2, SRV_SEED + 3)):
            r, ms = srv_request(base, "/encrypt", {"context_id": cid, "key_id": kid,
                                                   "bits": m.tolist(), "seed": seed})
            cts.append(r["ciphertext"])
            print(f"{tag} POST /encrypt of {BATCH} bits: {ms:.3f} ms, {len(r['ciphertext'])} "
                  f"base64 characters")
        # the same seeds through the port's context, called directly
        ctx = BinFheContext.generate("STD128", device=dev)
        krng = np.random.default_rng(SRV_SEED)
        sk = ctx.key_gen(krng)
        key = ctx.bt_key_gen(sk, krng)
        direct = [ctx.encrypt(sk, m1, np.random.default_rng(SRV_SEED + 2)),
                  ctx.encrypt(sk, m2, np.random.default_rng(SRV_SEED + 3))]
        want = {"AND": (ctx.eval_bin_gate(key, "AND", *direct), m1 & m2),
                "XOR": (ctx.eval_bin_gate(key, "XOR", *direct), m1 ^ m2),
                "NOT": (ctx.eval_not(direct[0]), 1 - m1)}
        b64 = lambda ct: base64.b64encode(serial.dumps(ct)).decode()
        if cts != [b64(c) for c in direct]:
            fail(f"{tag} /encrypt's archives differ from BinFheContext.encrypt's")
        requests = {"AND": ("/v1/eval/and", {"ct1": cts[0], "ct2": cts[1]}),
                    "XOR": ("/gate", {"gate": "XOR", "ct1": cts[0], "ct2": cts[1]}),
                    "NOT": ("/not", {"ciphertext": cts[0]})}
        for what, (path, payload) in requests.items():
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            profiling.reset()
            r, ms = srv_request(base, path, {"context_id": cid, "key_id": kid, **payload})
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            stage = profiling.report(reset=True)
            total.update(launches)
            expect = 0 if what == "NOT" else 1
            if launches["blind_rotate"] != expect or any(
                    launches[k] for k in ("blind_rotate_mega", "rotate_step_br", *WIDE_KERNEL.values())):
                fail(f"{tag} {what}: launches {nonzero(launches)}, expected {expect} of "
                     f"blind_rotate")
            if r["ciphertext"] != b64(want[what][0]):
                fail(f"{tag} {what}: the server's archive differs from BinFheContext's")
            d, d_ms = srv_request(base, "/decrypt", {"context_id": cid, "key_id": kid,
                                                     "ciphertext": r["ciphertext"]})
            wrong = int((np.asarray(d["bits"]) != want[what][1]).sum())
            if wrong:
                fail(f"{tag} {what}: {wrong} of {BATCH} outputs decrypt wrong")
            op = "server.not" if what == "NOT" else "server.gate"
            print(f"{tag} POST {path} ({what} of {BATCH} pairs): {ms:.3f} ms wall, the "
                  f"operation {stage[op]['total_s'] * 1e3:.3f} ms on the device (CUDA events); "
                  f"launches {nonzero(launches)}; byte-identical to BinFheContext's; POST "
                  f"/decrypt {d_ms:.3f} ms: {wrong} wrong of {BATCH}  ({card})")
        stats, _ = srv_request(base, "/v1/stats")
        print(f"{tag} GET /v1/stats: {stats}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()
    print(f"{tag} the phase took {time.perf_counter() - t_phase:.3f} s (host clock)")
    return total


def capi_toolchain() -> tuple[str | None, str]:
    """(g++'s path or None, this interpreter's Python.h path, which may be
    missing): what libfhecapi's build needs."""
    import shutil
    import sysconfig
    return shutil.which("g++"), os.path.join(sysconfig.get_paths()["include"], "Python.h")


def capi_ckks_handle(h):
    """The registry id that a ckks_* handle (a struct of one int64) holds."""
    import ctypes
    return ctypes.cast(h, ctypes.POINTER(ctypes.c_int64)).contents.value


def capi_ckks_cpu(z1: np.ndarray, z2: np.ndarray) -> dict:
    """The archives of [capi]'s CKKS ciphertexts made by the port's
    capi_impl on the CPU from the same seed and calls."""
    from fhe_tpu_torch.native import capi_impl
    device = capi_impl._device
    capi_impl.set_device("cpu")
    try:
        h = capi_impl.ckks_context_new(*CAPI_CKKS)
        kp = capi_impl.ckks_keygen(h, CAPI_CKKS_SEED)
        ca, cb = (capi_impl.ckks_encrypt(h, kp, z.astype("<f8").tobytes()) for z in (z1, z2))
        cts = {"encrypt": ca, "add": capi_impl.ckks_add(h, ca, cb),
               "mult": capi_impl.ckks_mult_ctx(h, ca, cb),
               "rotate by 1": capi_impl.ckks_rotate(h, kp, ca, 1)}
        out = {what: capi_impl.ckks_serialize_ciphertext(ct) for what, ct in cts.items()}
        capi_impl.ckks_keypair_free(kp)
        capi_impl.ckks_context_free(h)
        return out
    finally:
        capi_impl.set_device(device)


def capi_ckks(tag: str, lib, dev, errors: Errors, card: str) -> collections.Counter:
    """The ckks_* ABI at CAPI_CKKS on the card, with a keypair of
    CAPI_CKKS_SEED (capi_impl.ckks_keygen, the function behind the ABI's
    ckks_keygen, which takes no seed): encrypt of N/2 slots, add, mult (the
    3-argument form) and rotate by 1 through the ABI, each decrypted within
    CAPI_CKKS_TOL of numpy and each ciphertext's archive byte-identical to
    the CPU port's (capi_ckks_cpu); kernels 1-2 at every shape it launched
    them at; returns its launches."""
    import ctypes
    from fhe_tpu_torch.native import capi, capi_impl
    log_n, log_q, scale = CAPI_CKKS
    slots = 1 << (log_n - 1)
    rng = np.random.default_rng(SEED + 44)
    z1, z2 = rng.normal(size=(2, slots)) * 0.5

    def decrypt(c, kp, ct):
        n = ctypes.c_int()
        p = lib.ckks_decrypt(c, kp, ct, ctypes.byref(n))
        if not p or n.value != slots:
            fail(f"{tag} ckks_decrypt returned {n.value} values")
        out = np.ctypeslib.as_array(p, shape=(slots,)).copy()
        capi.libc_free(p)
        return out

    def archive(ct) -> bytes:
        n = ctypes.c_int()
        data = lib.ckks_serialize_ciphertext(ct, ctypes.byref(n))
        if not data:
            fail(f"{tag} ckks_serialize_ciphertext failed")
        raw = ctypes.string_at(data, n.value)
        lib.lux_fhe_bytes_free(data)
        return raw

    def run():
        t0 = time.perf_counter()
        c = lib.ckks_context_new(log_n, log_q, scale)
        if not c:
            fail(f"{tag} ckks_context_new({log_n}, {log_q}, 2^26) failed")
        box = ctypes.c_int64(capi_impl.ckks_keygen(capi_ckks_handle(c), CAPI_CKKS_SEED))
        kp = ctypes.c_void_p(ctypes.addressof(box))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ca, cb = (lib.ckks_encrypt(c, kp, np.ascontiguousarray(z).ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)), slots) for z in (z1, z2))
        outs = {"encrypt": (ca, z1), "add": (lib.ckks_add(c, ca, cb), z1 + z2),
                "mult": (lib.ckks_mult(c, ca, cb), z1 * z2),
                "rotate by 1": (lib.ckks_rotate(c, kp, ca, 1), np.roll(z1, -1))}
        errs, archives = {}, {}
        for what, (ct, want) in outs.items():
            if not ct:
                fail(f"{tag} ckks {what} failed")
            errs[what] = np.abs(decrypt(c, kp, ct) - want)
            archives[what] = archive(ct)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        capi_impl.ckks_keypair_free(box.value)
        return c, lib.ckks_context_levels(c), t1 - t0, t2 - t1, errs, archives
    with limb_launch_shapes() as shapes:
        (c, levels, key_s, ops_s, errs, archives), launches = launches_of(run)
    lib.ckks_context_free(c)
    print(f"{tag} ckks_context_new({log_n}, {log_q}, 2^26): {levels} levels; capi_impl."
          f"ckks_keygen(h, {CAPI_CKKS_SEED}) (relin and 10 stock rotation keys) {key_s:.3f} s; "
          f"encrypt of {slots} slots x 2, add, mult, rotate by 1, 4 decrypts and 4 archives "
          f"{ops_s:.3f} s (host clock); launches {nonzero(launches)}")
    for what, err in errs.items():
        print(f"{tag} ckks {what}: max |error| {err.max():.3e} at slot {int(np.argmax(err))} "
              f"(bound {CAPI_CKKS_TOL:.3e})")
        if not (err <= CAPI_CKKS_TOL).all():
            fail(f"{tag} ckks {what} through the ABI past its bound")
    t0 = time.perf_counter()
    cpu = capi_ckks_cpu(z1, z2)
    differ = [what for what in archives if archives[what] != cpu[what]]
    if differ:
        fail(f"{tag} ckks {', '.join(differ)}: the card's archive differs from the CPU port's")
    print(f"{tag} ckks encrypt, add, mult and rotate by 1: each archive byte-identical to the "
          f"CPU port's capi_impl from the same seed ({time.perf_counter() - t0:.3f} s on the "
          f"host)")
    limb_kernels_at(tag, "ckks_* ABI run", dev, shapes, {}, errors, int_multiply_peak(dev), card)
    return launches


def capi_phase(dev, errors: Errors, card: str) -> dict:
    """[capi]: libfhecapi built with g++ and loaded with ctypes into this
    process (it joins the interpreter; its registries on the card):
    lux_fhe_has_gpu 1; on STD128 keygen, encrypt, AND, OR, XOR, NOT, MUX
    and bootstrap at batch 1 on all four input pairs against the truth
    tables (kernel 3 once a gate, three times a MUX), the marshal /
    unmarshal round trip, threshold keygen and decrypt; the ckks_* ABI
    (capi_ckks); the C client (client.cpp) encrypting 4096 bits under the
    ABI's secret, the ABI's AND on the card, the C client decrypting.
    Returns the run's launches."""
    import ctypes
    from fhe_tpu_torch.native import capi, capi_impl, client
    from fhe_tpu_torch.utils import serial
    tag, t_phase = "[capi]", time.perf_counter()
    gxx, python_h = capi_toolchain()
    if gxx is None or not os.path.exists(python_h):
        print(f"{tag} not run: g++ {gxx or 'missing'}, {python_h} "
              f"{'present' if os.path.exists(python_h) else 'missing'} on this machine")
        return collections.Counter()
    print(f"{tag} g++ {gxx}; {python_h} present")
    capi_impl.set_device(dev)
    t0 = time.perf_counter()
    lib = capi.get_lib()
    client.get_lib()
    print(f"{tag} libfhecapi and libclient built with g++ and loaded: "
          f"{time.perf_counter() - t0:.3f} s")
    if lib.lux_fhe_has_gpu() != 1:
        fail(f"{tag} lux_fhe_has_gpu() = {lib.lux_fhe_has_gpu()}")

    def handle(call, *args):
        out = ctypes.c_void_p()
        rc = call(*args, ctypes.byref(out))
        if rc != 0:
            fail(f"{tag} {call.__name__}: {lib.lux_fhe_strerror(rc).decode()}")
        return out

    def dec(ctx, sk, ct) -> int:
        out = ctypes.c_int()
        if lib.lux_fhe_decrypt(ctx, sk, ct, ctypes.byref(out)) != 0:
            fail(f"{tag} lux_fhe_decrypt failed")
        return out.value

    def marshal(ct) -> bytes:
        data, n = capi._u8p(), ctypes.c_int64()
        if lib.lux_fhe_ciphertext_marshal(ct, ctypes.byref(data), ctypes.byref(n)) != 0:
            fail(f"{tag} lux_fhe_ciphertext_marshal failed")
        raw = ctypes.string_at(data, n.value)
        lib.lux_fhe_bytes_free(data)
        return raw

    def unmarshal(raw: bytes):
        buf = (ctypes.c_uint8 * len(raw)).from_buffer_copy(raw)
        return handle(lib.lux_fhe_ciphertext_unmarshal, ctypes.cast(buf, capi._u8p), len(raw))

    truth = {"and": lambda a, b: a & b, "or": lambda a, b: a | b, "xor": lambda a, b: a ^ b}
    total = collections.Counter()
    t0 = time.perf_counter()
    ctx = handle(lib.lux_fhe_context_new, b"STD128", b"GINX")
    sk = handle(lib.lux_fhe_keygen_secret, ctx, SEED + 45)
    bsk = handle(lib.lux_fhe_keygen_bootstrap, ctx, sk)
    cts = {b: handle(lib.lux_fhe_encrypt, ctx, sk, b) for b in (0, 1)}
    torch.cuda.synchronize()
    print(f"{tag} STD128 context (n = {lib.lux_fhe_context_n(ctx)}, N = "
          f"{lib.lux_fhe_context_ring_dim(ctx)}, q = {lib.lux_fhe_context_modulus(ctx)}), "
          f"secret, bootstrap key and 2 encryptions through the ABI: "
          f"{time.perf_counter() - t0:.3f} s")
    wrong = 0
    for name, f in truth.items():
        for a in (0, 1):
            for b in (0, 1):
                out, launches = launches_of(
                    lambda: handle(getattr(lib, f"lux_fhe_{name}"), ctx, bsk, cts[a], cts[b]))
                total.update(launches)
                wrong += dec(ctx, sk, out) != f(a, b)
                if launches["blind_rotate"] != 1:
                    fail(f"{tag} lux_fhe_{name}: launches {nonzero(launches)}")
                lib.lux_fhe_ciphertext_free(out)
    for a in (0, 1):
        out = handle(lib.lux_fhe_not, ctx, cts[a])
        wrong += dec(ctx, sk, out) != 1 - a
        for sel in (0, 1):
            for b in (0, 1):
                mux, launches = launches_of(lambda: handle(lib.lux_fhe_mux, ctx, bsk, cts[sel],
                                                           cts[a], cts[b]))
                total.update(launches)
                wrong += dec(ctx, sk, mux) != (a if sel else b)
                if launches["blind_rotate"] != 3:
                    fail(f"{tag} lux_fhe_mux: launches {nonzero(launches)}")
        boot, launches = launches_of(lambda: handle(lib.lux_fhe_bootstrap, ctx, bsk, cts[a]))
        total.update(launches)
        wrong += dec(ctx, sk, boot) != a
        back = unmarshal(marshal(boot))
        wrong += dec(ctx, sk, back) != a
    if wrong:
        fail(f"{tag} {wrong} wrong outputs through the ABI")
    print(f"{tag} lux_fhe_and / or / xor on all four input pairs, lux_fhe_not, lux_fhe_mux on "
          f"every (sel, a, b), lux_fhe_bootstrap and the marshal / unmarshal round trip at batch "
          f"1: 0 wrong; kernel 3 once a gate, 3 times a MUX, once a bootstrap; launches "
          f"{nonzero(total)}")
    sh = handle(lib.lux_fhe_threshold_keygen, ctx, sk, 3, 3, b"additive")
    parties = lib.lux_fhe_threshold_parties(sh)
    got = []
    for bit in (0, 1):
        out = ctypes.c_int()
        ids = (ctypes.c_int32 * 3)(1, 2, 3)
        if lib.lux_fhe_threshold_decrypt(ctx, sh, cts[bit], ids, 3, ctypes.byref(out)) != 0:
            fail(f"{tag} lux_fhe_threshold_decrypt failed")
        got.append(out.value)
    short = lib.lux_fhe_threshold_decrypt(ctx, sh, cts[1], (ctypes.c_int32 * 2)(1, 2), 2,
                                          ctypes.byref(ctypes.c_int()))
    if got != [0, 1] or short == 0:
        fail(f"{tag} threshold decrypt {got}, short quorum rc {short}")
    lib.lux_fhe_threshold_free(sh)
    print(f"{tag} lux_fhe_threshold_keygen 3-of-3 additive ({parties} parties) and lux_fhe_threshold_decrypt of 0 and 1: {got}; a quorum of 2 refused")
    # the C client under the ABI's secret; the ABI's AND on the card
    data, n = capi._u8p(), ctypes.c_int64()
    if lib.lux_fhe_secretkey_marshal(sk, ctypes.byref(data), ctypes.byref(n)) != 0:
        fail(f"{tag} lux_fhe_secretkey_marshal failed")
    key, _ = serial.loads(ctypes.string_at(data, n.value), device="cpu")
    lib.lux_fhe_bytes_free(data)
    q = lib.lux_fhe_context_modulus(ctx)
    s = key.s.numpy()
    rng = np.random.default_rng(SEED + 46)
    m1, m2 = (rng.integers(0, 2, size=BATCH).astype(np.int32) for _ in range(2))
    t0 = time.perf_counter()
    c1, c2 = (unmarshal(serial.dumps(client.as_ciphertext(
        *client.lwe_encrypt(s, q, 4, m, bytes(rng.integers(0, 256, 32, dtype=np.uint8))), q,
        device="cpu"))) for m in (m1, m2))
    t1 = time.perf_counter()
    out, launches = launches_of(lambda: handle(lib.lux_fhe_and, ctx, bsk, c1, c2))
    total.update(launches)
    t2 = time.perf_counter()
    res = serial.loads(marshal(out), device="cpu")
    got = client.lwe_decrypt(s, q, 4, *client.ciphertext_words(res))
    wrong = int((got != (m1 & m2)).sum())
    if wrong or launches["blind_rotate"] != 1:
        fail(f"{tag} C client -> ABI AND -> C client: {wrong} wrong, launches {nonzero(launches)}")
    print(f"{tag} C client: {BATCH} bit pairs encrypted under the ABI's secret and unmarshalled "
          f"{t1 - t0:.3f} s, lux_fhe_and on {dev} {1e3 * (t2 - t1):.3f} ms (host clock, one "
          f"launch of kernel 3), marshalled back and decrypted by the C client: {wrong} wrong of "
          f"{BATCH}")
    total.update(capi_ckks(tag, lib, dev, errors, card))
    for h, free in ((bsk, lib.lux_fhe_bootstrapkey_free), (sk, lib.lux_fhe_secretkey_free),
                    (ctx, lib.lux_fhe_context_free)):
        free(h)
    print(f"{tag} the phase took {time.perf_counter() - t_phase:.3f} s (host clock)")
    return total


def service_phases(dev, errors: Errors, card: str, sk, and_out) -> list:
    """[ser], [srv] and [capi]; their launches."""
    t0 = time.perf_counter()
    out = [ser_phase(dev, card, sk, and_out), srv_phase(dev, card), capi_phase(dev, errors, card)]
    print(f"[ser] + [srv] + [capi] took {time.perf_counter() - t0:.3f} s (host clock)")
    return out


def time_single_ntt(dev, shapes: collections.Counter, errors: Errors, card: str) -> dict:
    """Kernels 1-2 single-modulus at each (kernel, [rows, N]) that [td] and
    [arb] launched (under one of the moduli they launched it with), cold
    L2: byte-equal to the plain versions, beside their bound and the plain
    time; returns the small-N kernels' times at their largest N for the
    kernels line."""
    from fhe_tpu_torch.math import ntt
    from fhe_tpu_torch.profile_ntt import FLUSH_WORDS, time_cold_ms
    flush = torch.empty(FLUSH_WORDS, dtype=torch.int32, device=dev)
    int_peak = int_multiply_peak(dev)
    rng = np.random.default_rng(SEED + 20)
    by_shape = collections.defaultdict(lambda: [0, None])    # (kernel, shape) -> [launches, a q]
    for (name, shape, q), n in shapes.items():
        by_shape[(name, shape)][0] += n
        by_shape[(name, shape)][1] = by_shape[(name, shape)][1] or q
    result = {}
    for (name, (rows, N)), (n, q) in sorted(by_shape.items()):
        plan = ntt.make_plan(N, q, dev)
        x = _residues(rng, plan.q, (rows, N), dev)
        inverse = name.startswith("ntt_inverse")
        kern = (lambda: ntt.ntt_inverse(plan, x)) if inverse else (lambda: ntt.ntt_forward(plan, x))
        plain = ((lambda: ntt.inverse_butterfly(plan, x)) if inverse else
                 (lambda: ntt.forward_butterfly(plan, x)))
        errors.compare(name, kern(), plain(), f"[td]/[arb] {name} [{rows}, {N}]", show=False)
        k_ms, p_ms = time_cold_ms(kern, 21, flush), time_cold_ms(plain, 5, flush)
        muls = 3 * (N // 2 * plan.logN + (N if inverse else 0)) * rows
        b_ms, b_by = bound(_nbytes(x, x, plan.fwd_w, plan.fwd_ws), muls, int_peak)
        print(f"[time] {name} [{rows}, {N}] (q = {q}), cold L2: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.3f} ms, bound {b_ms:.3e} ms by {b_by}, kernel at {b_ms / k_ms:.3e} of its "
              f"bound; {n} launches in [td] and [arb]  ({card})")
        if name.endswith("_small") and (name not in result or N >= result[name][4]):
            result[name] = (k_ms, p_ms, b_ms, b_by, N)
    return {name: r[:4] for name, r in result.items()}


def slice_phases(dev, errors: Errors, card: str, ctx, sk, key, cts) -> tuple[list, dict]:
    """[td], [arb], [thr], [zkp] and [pack]: their launches; the times of
    kernels 1-2 at every shape [td] and [arb] launched them at, and the
    small-N kernels' for the kernels line."""
    t0 = time.perf_counter()
    with single_launch_shapes() as single, limb_launch_shapes() as limbs:
        launches = [td_phase(dev, card), arb_phase(dev, card)]
    for name in SMALL_KERNELS:
        if not launches[1][name]:
            fail(f"[arb] kernel {name} was not launched")
    launches += [thr_phase(dev, card, ctx, sk, key, cts), zkp_phase(dev, card, ctx, sk, key),
                 pack_phase(dev, card, ctx, key, cts)]
    times = time_single_ntt(dev, single, errors, card)
    limb_kernels_at("[arb]", "[arb] phase", dev, limbs, {}, errors, int_multiply_peak(dev), card)
    retrace_untraced(dev, card)
    print(f"[td] + [arb] + [thr] + [zkp] + [pack] took {time.perf_counter() - t0:.3f} s "
          f"(host clock)")
    return launches, times


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() in ms; the caller has warmed fn up."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed_once(fn):
    """(CUDA-event ms, result) of one call of fn()."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def step_multiplies(p) -> int:
    """32-bit integer multiplies of one CGGI step of one ciphertext, as the
    step (csrc/cggi_step.cuh) does them: a Shoup product is 3 (low, high,
    low); a 32 x 32 -> 64-bit product 2 (its low and high words); a REDC 2.
    2 inverse NTTs with the N^-1 scale and dG2 forward NTTs, one Shoup
    product a butterfly; per slot, the external product's 2 signs x 2
    columns each sum dG2 64-bit products and reduce once, the monomial
    multiply-add's 2 columns each sum two and reduce once, and the 2
    monomial indices are one multiply each."""
    butterflies = p.N // 2 * (p.N.bit_length() - 1)
    ntts = 2 * (3 * butterflies + 3 * p.N) + p.digits_g2 * 3 * butterflies
    external = 2 * 2 * (2 * p.digits_g2 + 2) * p.N
    monomial = 2 * (2 * 2 + 2) * p.N
    return ntts + external + monomial + 2 * p.N


def int_multiply_peak(dev) -> float:
    """32-bit integer multiplies a second: SMs x 64 a clock x the max SM clock."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * IMUL_PER_CLOCK_PER_SM * max_sm_clock_hz()


def bound(nbytes: int, muls: int, int_peak: float):
    """(bound ms, what bounds it): the larger of bytes over the memory rate
    and 32-bit multiplies over the integer multiply peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, muls / int_peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_ntt(dev, plan, x_f, x_i, errors: Errors, int_peak: float, card: str) -> dict:
    """Kernels 1 and 2 against their plain versions with a cold L2, at the
    main path's shapes (the batch's test vectors and extract_lwe's rows;
    the forward in both orders) and the single gate's; returns the
    main-path natural-order times for the kernels line."""
    from fhe_tpu_torch.math import ntt
    from fhe_tpu_torch.profile_ntt import FLUSH_WORDS, time_cold_ms
    flush = torch.empty(FLUSH_WORDS, dtype=torch.int32, device=dev)
    butterflies = plan.N // 2 * plan.logN
    twiddles = _nbytes(plan.fwd_w, plan.fwd_ws)
    fwd = lambda x: (lambda: ntt.ntt_forward(plan, x), lambda: ntt.forward_butterfly(plan, x))
    fwd_br = lambda x: (lambda: ntt.ntt_forward(plan, x, out_br=True),
                        lambda: ntt.forward_butterfly(plan, x, out_br=True))
    inv = lambda x: (lambda: ntt.ntt_inverse(plan, x), lambda: ntt.inverse_butterfly(plan, x))
    cases = [  # (kernel, order, input, (kernel call, plain call), multiplies a row, main)
        ("ntt_forward", "natural", x_f, fwd(x_f), 3 * butterflies, True),
        ("ntt_forward", "out_br", x_f, fwd_br(x_f), 3 * butterflies, False),
        ("ntt_inverse", "natural", x_i, inv(x_i), 3 * (butterflies + plan.N), True),
        ("ntt_forward", "natural", x_f[:1], fwd(x_f[:1]), 3 * butterflies, False),
        ("ntt_forward", "out_br", x_f[:1], fwd_br(x_f[:1]), 3 * butterflies, False),
        ("ntt_inverse", "natural", x_i[:2], inv(x_i[:2]), 3 * (butterflies + plan.N), False),
    ]
    result = {}
    for name, order, x, (kern, plain), muls, main in cases:
        shape = f"[{x.shape[0]}, {plan.N}] {order}"
        errors.compare(name, kern(), plain(), f"{name} {shape}")
        k_ms = time_cold_ms(kern, 21, flush)
        p_ms = time_cold_ms(plain, 5, flush)
        b_ms, b_by = bound(_nbytes(x, x) + twiddles, muls * x.shape[0], int_peak)
        print(f"[time] {name} {shape}, cold L2: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
              f"bound {b_ms:.4f} ms by {b_by}, kernel at {b_ms / k_ms:.3f} of its bound  ({card})")
        if main:
            result[name] = (k_ms, p_ms, b_ms, b_by)
    return result


def timings(dev, ctx, key, cts, errors: Errors, card: str) -> dict:
    from fhe_tpu_torch.math import ntt
    from fhe_tpu_torch.tfhe import boot, boot_pallas
    ct1, ct2, _, one1, one2 = cts
    p = ctx.params
    for impl in IMPLS:
        c = dataclasses.replace(ctx, ntt_impl=impl)
        batch_ms = time_ms(lambda: c.eval_bin_gate(key, "AND", ct1, ct2), reps=3)
        single_ms = time_ms(lambda: c.eval_bin_gate(key, "AND", one1, one2), reps=5)
        print(f"[time] ntt_impl={impl} STD128 AND batch {BATCH}: {batch_ms:.3f} ms = "
              f"{BATCH / batch_ms * 1e3:.1f} gates/s  ({card})")
        print(f"[time] ntt_impl={impl} STD128 single-gate AND latency: {single_ms:.3f} ms  "
              f"({card})")

    clock = max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    int_peak = int_multiply_peak(dev)
    print(f"[bound] memory {HBM_BYTES_PER_S / 1e12:.2f} TB/s (data sheet); 32-bit integer "
          f"multiply peak {int_peak / 1e12:.3f} T/s = {sms} SMs x {IMUL_PER_CLOCK_PER_SM}/clock "
          f"x {clock / 1e9:.3f} GHz max SM clock (derived, not a data-sheet rate)")

    from fhe_tpu_torch.kernels import blind_rotate as kbr
    c = kbr.choose_c(BATCH, sms)
    for kind in kbr.KINDS:
        blocks = kbr.occupancy(p, c, kind)
        print(f"[occupancy] {kind} blind-rotation kernel, batch {BATCH}: {c} ciphertexts x "
              f"{p.N // 8} threads a block, {blocks} resident blocks per SM")
        if blocks < 2:
            fail(f"{kind} blind-rotation kernel: {blocks} resident block per SM at batch {BATCH}")

    rng = np.random.default_rng(SEED + 2)
    plan = ntt.make_plan(p.N, p.Q, dev)
    x_f = _residues(rng, p.Q, (BATCH, p.N), dev)            # the test vectors
    x_i = _residues(rng, p.Q, (2 * BATCH, p.N), dev)        # extract_lwe
    acc = _residues(rng, p.Q, (BATCH, 2, p.N), dev)
    a = _residues(rng, p.q, (BATCH, p.n), dev)
    bsk_br = key.bsk_br
    pows = boot._psi_powers_mont_words(p.N, p.Q, dev)
    twiddles = _nbytes(plan.fwd_w, plan.fwd_ws)
    rot_bytes = _nbytes(acc, acc, key.bsk, a, pows) + 2 * twiddles
    step_bytes = _nbytes(acc, acc, key.bsk[0], a[:, 0], pows) + 2 * twiddles
    step_muls = step_multiplies(p) * BATCH
    fused = lambda: boot_pallas.blind_rotate_fused(p, bsk_br, acc, a)
    # name -> (shape, kernel, plain, timed run of the kernel and its launches,
    #          reps of that run, plain reps, bytes, multiplies)
    cases = {
        "blind_rotate": (f"[{BATCH}, 2, {p.N}] x {p.n} steps, STD128 key",
                         lambda: boot.blind_rotate(p, key, acc, a),
                         lambda: boot.blind_rotate_plain(p, key.bsk, acc, a), None, 1, 3, 1,
                         rot_bytes, step_muls * p.n),
        "blind_rotate_mega": (f"[{BATCH}, 2, {p.N}] x {p.n} steps, STD128 key, bit-reversed",
                              lambda: boot_pallas.blind_rotate_mega(p, bsk_br, acc, a),
                              lambda: boot_pallas.blind_rotate_mega_plain(p, bsk_br, acc, a),
                              None, 1, 3, 1, rot_bytes, step_muls * p.n),
        # one step; the kernel's time per launch is taken over the n launches
        # of blind_rotate_fused, which also runs nothing else on the card
        "rotate_step_br": (f"[{BATCH}, 2, {p.N}] x 1 step, STD128 key, bit-reversed",
                           lambda: boot_pallas.rotate_step_br(p, bsk_br[0], acc, a[:, 0]),
                           lambda: boot_pallas.rotate_step_br_plain(p, bsk_br[0], acc, a[:, 0]),
                           fused, p.n, 3, 3, step_bytes, step_muls),
    }
    result, mega_plain = time_ntt(dev, plan, x_f, x_i, errors, int_peak, card), None
    for name, (shape, kern, plain, run, launches, k_reps, p_reps, nbytes, muls) in cases.items():
        got = kern()
        if p_reps == 1:
            p_ms, want = timed_once(plain)
        else:
            want = plain()
            p_ms = time_ms(plain, reps=p_reps)
        errors.compare(name, got, want, f"{name} {shape} (main-path shape)")
        if name == "blind_rotate_mega":
            mega_plain = want
        if run is None:
            k_ms = time_ms(kern, reps=k_reps)
        else:
            errors.compare(name, run(), mega_plain,
                           f"{name} x {launches} launches (blind_rotate_fused) [{BATCH}, 2, {p.N}]")
            run_ms = time_ms(run, reps=k_reps)
            k_ms = run_ms / launches
            print(f"[time] {name} x {launches} launches (blind_rotate_fused) [{BATCH}, 2, {p.N}]: "
                  f"{run_ms:.3f} ms; one call of the single-step wrapper {time_ms(kern, 5):.3f} ms "
                  f"(with its index computation and the host's issue time)  ({card})")
        b_ms, b_by = bound(nbytes, muls, int_peak)
        print(f"[time] {name} {shape}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
              f"{b_ms:.3f} ms by {b_by} ({nbytes} bytes, {muls} multiplies), kernel at "
              f"{b_ms / k_ms:.3f} of its bound  ({card})")
        result[name] = (k_ms, p_ms, b_ms, b_by)
    return result


def main() -> int:
    if sys.argv[1:2] == ["--small-cpu"]:
        return small_child(sys.argv[2])
    if sys.argv[1:2] == ["--ss"]:
        return ss_child(sys.argv[2])
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is false")
    from fhe_tpu_torch import kernels  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda", 0)
    card = card_line()
    device_report(card)
    build()
    with small_on_cpu() as small_cpu:
        rows = phases(dev, card, small_cpu)
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def phases(dev, card: str, small_cpu) -> list[dict]:
    """Every phase after the build; returns the kernels line's rows."""
    errors = Errors()
    check_kernels(dev, errors)
    ctx, sk, key, cts, and_out, launches, main_digest = main_path(dev)
    func_launches = func_phase(dev, ctx, sk, key, errors, card)
    for name in ("ntt_forward", "ntt_inverse"):
        launches[name] += func_launches[None][name]
    for impl, name in ACC_KERNEL.items():
        launches[name] += func_launches[impl][name]
    acc_phase(dev, errors, card)
    rns_launches, rns_times = rns_phase(dev, errors, card)
    launches.update({name: rns_launches[name] for name in LIMB_KERNELS})
    radix_launches, radix_times = radix_phase(dev, errors, card)
    launches.update(radix_launches)
    launches.update({name: 0 for name in SMALL_KERNELS})
    ckks_launches = ckks_phase(dev, errors, card)
    bfv_launches = bfv_phase(dev, errors, card)
    bgv_launches = bgv_phase(dev, errors, card)
    t_new = time.perf_counter()
    new_launches = [mp_phase(dev, errors, card), adv_phase(dev, errors, card),
                    pre_phase(dev, errors, card)]
    print(f"[mp] + [adv] + [pre] took {time.perf_counter() - t_new:.3f} s (host clock)")
    with ss_process() as ss_result:
        boot_launches, boot_state = boot_phase(dev, errors, card, small_cpu)
        new_launches.append(boot_launches)
        new_launches.append(fbt_phase(dev, errors, card, boot_state, small_cpu))
        del boot_state
        ss, ss_s = ss_result()
    if ss["digest"] != main_digest:
        fail("[ss] its process did not hold the main path's STD128 key and AND outputs")
    print(f"[ss] the phase ran in a process of its own beside [boot] and [fbt] (its times are "
          f"taken beside them): done {ss_s:.1f} s after [boot] began (host clock); the main path's "
          f"key and AND outputs, digest {main_digest[:16]}")
    for name in LIMB_KERNELS:
        launches[name] += ckks_launches[name] + bfv_launches[name] + bgv_launches[name]
        launches[name] += sum(n[name] for n in new_launches)
    for name in KERNELS:
        launches[name] += ss["launches"][name]
        errors.max[name] = max(errors.max[name], ss["errors"][name])
    retrace_untraced(dev, card)
    slice_launches, small_times = slice_phases(dev, errors, card, ctx, sk, key, cts)
    slice_launches += service_phases(dev, errors, card, sk, and_out)
    retrace_untraced(dev, card)
    for name in KERNELS:
        launches[name] += sum(n[name] for n in slice_launches)
    times = timings(dev, ctx, key, cts, errors, card)
    times.update(rns_times)
    times.update(radix_times)
    times.update(small_times)
    return [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[name], "max_abs_err": errors.max[name],
             "ms": times[name][0], "plain_ms": times[name][1], "bound_ms": times[name][2],
             "bound_by": times[name][3], "library_ms": None}
            for name, (src, rep) in KERNELS.items()]


if __name__ == "__main__":
    sys.exit(main())
