"""On-card smoke test of the PyTorch/CUDA port (thunder_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py            # everything, on one card
    python3 chip_smoke.py --kernels  # build + kernel checks only
    python3 chip_smoke.py --cli      # build + path D (phase 9) only
    python3 chip_smoke.py --mp       # build + path G (phase 12) only
    python3 chip_smoke.py --mp --ranks 3  # path G as 3 ranks: (1, 3), gloo
    python3 chip_smoke.py --mp --ranks 4  # path G as (2, 2) on 4 cards: nccl
    python3 chip_smoke.py --cli-study  # build + path D's run, 10 seeds
    python3 chip_smoke.py --mp-study  # build + path G's run, 1 / 2 ranks
    python3 chip_smoke.py --data-study  # + the round on bench.py's data
    python3 chip_smoke.py --sym      # build + path E (phase 10) only
    python3 chip_smoke.py --mkb      # build + path F (phase 11) only
    python3 chip_smoke.py --sym-study  # build + path E's phantom designs

Phases, each printing a flushed progress line with elapsed seconds:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build of csrc/*.cu with one nvcc call (cuda_build), and the count of
   tensor-core instructions (HGMMA / HMMA) in the global-scan kernel's
   SASS (cuobjdump), as proof of tensor-core use;
3. kernel K1 (fused global scan, wgmma) against its plain version at the
   slice's shape (B=64, R=256, T=30, P=256), a ragged one (37, 200, 7)
   and one with T over two translation chunks (16, 256, 70): merged
   outputs against ``scan_plain``, raw per-tile outputs against
   ``scan_tiles_plain``, the merge kernel against ``merge_tiles``; the
   wrapper as the round calls it timed in turns with a batched-matmul
   yardstick, and the kernels' own time on the card from a profiler
   trace, at the slice shape and at B = 1024;
4. kernel K2 (gridding insert, channel-minor table, vector atomics)
   against its plain version at the slice's sample count on random rows,
   plus the empty and all-dropped cases; kernel and ``index_add_`` timed in
   turns on the same table;
5. the round sequence bench.py runs, at full width (160 px, pf 2, C4,
   256 x 30 scan, 125 x 9 local support, 100 insert draws) on bench.py's
   256 particles (synthetic; C4-symmetric phantom, noise 0.3 of the
   signal std instead of 1.0), through Optimiser.run_iteration, each round
   with the kernels' launch counts set to 0 just before it and read just
   after, and every round held to ROUND_ANG_MAX / ROUND_RES_MIN:
   a. the global warm-up round (K1 and K2 launched); then K2 held against
      the exact sum of its rows and timed in turns with ``index_add_`` on
      the round's own first insert call;
   b. two local rounds pinned as bench.py pins them (LOCAL, r = 40): K1
      launched 0 times and K2 at least 4 times in each, norm-correction
      factors, sigma and offsets sane; between them, K2 on the first local
      round's whole half table (both chunks, as the fold receives it)
      against the exact f64 sum of all its calls' rows, and timed in turns
      with ``index_add_`` on one local-round chunk;
   c. two further pinned local rounds, timed (wall, median, particles/s:
      a progress reading, not a benchmark), and a local round's peak
      device memory;
6. path A, 3D classification: configs/demo_3D.json as users write it
   (K = 4, C4, 2500 x 151 scan; ``class_para``'s deviations: init_res 25 A,
   no file output) on 512 images of four C4-symmetric phantoms
   (``class3d_dataset``, 128 a class, noise 0.3), each class's reference
   seeded from its phantom by this script; a global round (K1 launched, K2
   fused over the K-fold table: 2 x chunks launches) with K2's whole fused
   half-0 table held to the exact sum, then two local rounds pinned at
   r = 40 (K1 not launched, K2 staged class by class: K x 2 x chunks
   launches); every round held to ROUND_ANG_MAX per class,
   ROUND_RES_MIN, CLASS_PURITY_MIN and class identity (each class's map
   correlates best with its own phantom);
7. path B, 2D classification: configs/demo_2D.json (K = 30, 100 x 151
   scan) on 1,920 images of 30 views of one phantom (``class2d_dataset``,
   64 a view, random in-plane angles), references seeded from the views;
   a global and a local round, each held to ROUND_ANG_MAX (in-plane
   angle), CLASS2D_PURITY_MIN, class identity and ROUND2D_RES_MIN;
8. path C, CTF search and the final round: bench.py's Para with CTF
   search on (configs/demo.json's m_l_d 9 and ctf_refine_s 0.01) and both
   per-round save flags on, writing into a fresh temporary directory, on
   256 particles made as in phase 5 with two changes: each image's CTF at
   a true defocus factor 1 + eps, eps ~ N(0, 0.01) (the optimiser is given
   the unscaled defocus), and 150 small Gaussians with their C4 mates
   added to the phantom (``phantom(atoms=...)``: detail past shell 15 for
   the CTF search to read): a global round, a local round pinned at r = 40, a CTF round
   pinned there (``pin_ctf``) and its files, then ``Optimiser.run
   (max_iter=1)``: a second CTF round with its files and the final round
   (the Nyquist band, mc = 317) with the final file set. Each CTF round
   holds K1 launched 0 times and K2 4 times, the pose and resolution bars,
   sD finite and positive and the (2, S, 9) defocus support; the median
   defocus error after the second CTF round falls below its entry value
   and CTF_DFAC_ERR_MAX; the final round holds K2 launched 4 times at
   mc = 317, half 0's whole final-band table (31.86 M rows) against the
   exact f64 sum at K2_TOL, the joined map's FSC against the phantom above
   0.5 over shells 1 .. FINAL_FSC_SHELLS and the final FSC-0.143 shell at
   ROUND_RES_MIN; every file the JAX package names for this Para is
   written, the maps read back through ``read_mrc`` at 160^3 with voxel
   1.32, and Meta_Final.thu through ``read_thu`` with 256 x 27 values and
   ``best_defocus`` in its defocus-factor column;
9. path D, the command-line entry point (``thunder_tpu_torch.cli.main``
   called in this process, so that the counts see it) on path C's data
   written as a user hands it over, into a fresh temporary directory:
   stack.mrcs (256 x 160^2, 26 MB), particles.thu (absolute particle
   paths, micrograph names and coordinates, the unscaled defocus),
   init.mrc (the phantom); particles.thu round-tripped through
   ``thu2star`` / ``star2thu`` and the run fed the round-tripped table;
   a run.json of configs/demo.json's keys with bench.py's sizes
   (``cli_config``: 160 px, C4, 1024 scan points, 125 x 9 x 9 local
   support, 100 insert draws) and CLI_ITERS rounds. ``cli run``: every
   round held to ROUND_ANG_MAX / ROUND_RES_MIN and to its launches (K1 in
   global rounds only, K2 four times), the final round's four K2
   launches, the printed history, the file set the JAX package writes
   (and thunder.log) read back, Meta_Final.thu carrying the dataset's
   particle paths, its shifts within META_TRANS_MAX of the true ones
   (median), their mean error under META_TRANS_BIAS_MAX and their slope
   on the true ones within META_TRANS_SLOPE on each axis.
   Then a resume from Meta_Final.thu (Global Search false, subtraction
   on, one round): its entry state the table's (``load_poses``), its
   round held to the same bars, K2 also launched by
   the subtraction's second Nyquist reconstruction,
   Subtract_Rank_000000.mrcs (256 x 4 images) and Meta_Subtract.thu read
   back, the subtracted images' variance inside the mask radius over
   outside it under SUB_RESID_MAX, and the controls of
   ``subtraction_controls`` (the phantom subtracted at the truth under
   SUB_TRUTH_MAX). The same resume with its reference at the run's final
   resolution, held to RESUME_HI_ANG_MAX and SUB_HI_MAX (the band of the
   first resume's round). Then every other subcommand once
   on the run's files, each read back: ``reconstruct`` (FSC against the
   run's final map), ``postprocess`` (its FSC near the run's final FSC),
   ``genmask``, ``genmask_shell``, ``lowpass``, ``bfactor``, ``mask``,
   ``average``, ``minus``, ``resize`` 160 -> 128, ``alignz``, ``view
   --slices``, ``project``, ``select --keep``; each one's seconds, the
   run's and the resume's, and their peak memory, beside the card line;
10. path E, general point-group symmetry: bench.py's Para with sym I (17
   scan rotations in I's fundamental domain; 58 of its 59 rotations are
   not grid-exact and are gathered by ``symmetrize_cropped``) on 256
   images of an I-symmetric phantom (``sym_phantom``: 30 small Gaussians,
   each under the 60 matrices of the port's ``Symmetry("I")``, noise
   0.3), files into a temporary directory: a global round, a local round
   pinned at r = 40, then ``run(max_iter=1)``: one more round and the
   final round (mc = 317). Every round holds K1 (global round only), K2
   four times, ROUND_ANG_MAX over the nearest of the 60 mates and
   ROUND_RES_MIN, and its half-0 map's FSC against the phantom above
   SYM_TRUTH_FSC_MIN over shells 1 .. ROUND_RES_MIN (the golden FSC past
   the insert band is leakage both halves share, so the shell bar alone
   cannot fail there); ``symmetrize_cropped`` is held to the plain full-grid
   ``symmetrize`` on the global round's folded half 0 (mc = 165) at
   SYM_CHECK_TOL; the symmetrisation's seconds are read at every band
   (165, 293, 317); the joined final map's FSC against the phantom > 0.5
   over shells 1 .. FINAL_FSC_SHELLS and its correlation with its own
   I-average > SYM_AVG_CORR_MIN;
11. path F, the MKB insert: phase 5's data with ``mkb_kernel``: a global
   round and a local round pinned at r = 40, each holding K1 (global
   round only), K2 launched 0 times (the MKB insert adds its 8 row sets a
   chunk with ``index_add_``), the pose and resolution bars and half 0's
   MKB table against the exact f64 sum of the same rows at MKB_TOL, and
   its first chunk folded to voxels against the MKB blob gridded anew in
   float64 from the same coordinates and values
   (``mkb_grid_f64``: weights, support, dropped rows) at MKB_F64_TOL;
   between them the MKB and the trilinear reference from the same state
   and draws, correlating above MKB_TRI_CORR_MIN, both inserts timed;
   after them the MKB insert timed at the local band;
12. path G, a multi-process run: path D's dataset (written anew) and
   ``cli run`` config as MP_RANKS = 2 ranks on the one card, each a
   process of this script (``--rank-run``: ``thunder_tpu_torch.cli.main``
   with the kernels' counts set to 0 just before it and reported just
   after) under torchrun's variables and a free port, joined on gloo
   (NCCL refuses two ranks on one device; with a card a rank, as
   ``--mp --ranks 4`` on four cards, the ranks join on nccl, each on its
   own card); the launcher kills all ranks as soon as one exits non-zero
   or MP_WALL_S passes. The ranks take the JAX package's (half, data)
   layout: two ranks are (2, 1), rank r holding hemisphere r's 128 images,
   brick tables and maps; ``--ranks 4`` is (2, 2) and ``--ranks 3`` the
   data-only (1, 3). The run (CLI_ITERS global
   rounds and the final round; rank 1 given an output directory of its
   own): each rank logged its (half, data) coordinates, built brick
   tables of its halves only (leading dimension lh: 1 on (2, W/2)) and on
   cuda:0 launched K1 in every global round and K2 in every round, lh
   halves x its 64-image chunks a call (``rank_calls``);
   only rank 0 printed the history and wrote the run's files (the file set
   of path D; each other rank's directory holds only its thunder.log); each rank
   logged that the ranks' states agreed after every round, and each
   round's record holds each rank's largest gap to rank 0 in the
   references and FSC before rank 0 broadcasts them (MP_MAP_GAP_MAX; the
   half maps reach every rank from the rank that reconstructed them, so
   each half is read against the rank that holds the same hemisphere) and
   the summed insert table's total against its hemisphere's data ranks'
   own (its rounding bound, data ranks x 2^-22: a rank missing from the
   sum reads far over it, and the optimiser raises; on (2, 1) no table is
   summed and the gap is 0) and, on (2, W/2), the number of gathered half
   maps each rank held to the digest their owner took before the pair
   gather (a gather that hands back the wrong half raises; each rank
   checked both halves of every reconstruction, the same count on every
   rank, and none on (1, W)); each round's
   Meta_Round_*.thu poses under ROUND_ANG_MAX and its shell at
   ROUND_RES_MIN, Meta_Final.thu's shifts within path D's bars, the final
   shell at ROUND_RES_MIN and the final map's FSC against the phantom
   above 0.5 over shells 1 .. TOOL_RECON_SHELLS. Then the resume from its
   Meta_Final.thu with subtraction, both ranks into one directory: K1 0
   and K2 in the local round, the final round and the subtraction's
   reconstruction, the pose bar, the ranks' Subtract_Rank_*.mrcs (each of
   its own block's images: on (2, 1) rank 0's of hemisphere A, rank 1's
   of B) reassembled through Meta_Subtract.thu's paths (each slice once)
   and held to SUB_RESID_MAX; each run's wall seconds and each rank's
   coordinates, launches and peak device memory beside the card line;
13. a JSON line of per-kernel numbers (launches summed over the rounds of
   phases 5a-b and 6-12 (path G's over its ranks), and per round or run; K1's readings at the
   class-stacked shapes; K2's on the fused class table and on a
   final-band chunk), the card line again, and the final status line
   {"ok": true, "device": {...}}.

Phase 3 also holds K1 at the classification paths' class-stacked shapes
(K1_CLASS_SHAPES: B 64, K 4, R 2500, T 151 and B 64, K 30, R 100, T 151),
normalised wC included.

``--data-study`` adds, after phase 8, the global round on bench.py's own
data (asymmetric phantom, noise 1.0) and on the two data sets that change
one of those two settings, and two pinned local rounds on bench.py's own
data, and prints their pose error and resolution without bounds: it shows
what the smoke's easier data changes; then path C's rounds on the blob
phantom without the atoms (two CTF rounds, the defocus error after each);
then both classification paths from the JAX package's default of
identical references, three global rounds each, with purity and
resolution per round (no bounds).

``--sym-study`` runs, after the build, path E's global round and a
local round pinned at r = 40 on each phantom design of
SYM_STUDY_DESIGNS, without bounds, and prints their pose errors and
shells: the study path E's phantom was chosen from.

``--cli-study`` runs, after the build and nothing else, path D's ``cli
run``, the reconstruct and postprocess tools and its two resumes on the
same files once per seed of ``cli_study`` (a repeated seed differs only by
the atomic order of the kernels' sums), without bounds, and prints each
run's readings of what path D holds to bars and their ranges: the spread
those bars are set from.

``--mp-study`` runs, after the build and nothing else, path G's ``cli
run`` on one dataset as one rank twice, one rank on the STAR round trip
of its particles.thu (path D's input) and two ranks twice, without
bounds, and prints each run's pose errors and how many of the images'
round-1 poses each pair of runs shares.

Any failed check raises, so the script exits non-zero and prints no result.
Path C's, D's, E's and G's files go to temporary directories outside the
repository, removed at their ends.
It imports nothing of JAX or of the JAX package: the synthetic data are
made with NumPy and the port's own projector, CTF and translation code.
"""

import json
import os
import subprocess
import sys
import time

T0 = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16 tensor
# FLOP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# K1 bars, set from the H100 readings (PERF.md): normalised wR/wT within
# 1.4e-4 and raw marginals and per-tile outputs within 5.3e-3 relative
# (bf16 operands, Q T and |P|^2 included, vs the f32 plain version). wC is
# checked raw only: with K = 1 its normalised value is 1 by construction
K1_TOL = 1e-3        # max |kernel - plain| of normalised wR, wT
K1_RAW_TOL = 1e-2    # max |kernel - plain| / max |plain| of wC, wR, wT
K1_ARGMAX_MIN = 0.95  # top-pose agreement (bf16 can flip near-ties)
K1_MERGE_TOL = 1e-5  # merge kernel vs merge_tiles on the same tiles (f32)
K2_TOL = 1e-5       # max |kernel - plain| / max |plain|: atomics reorder f32
# bounds on every round (the global one and each pinned local one), set
# from the first full global round on an H100 (median top-pose error 0.92
# deg, FSC-0.143 shell 15): see PERF.md
ROUND_ANG_MAX = 5.0   # median top-pose error (deg), C4 mates allowed
ROUND_RES_MIN = 12    # FSC-0.143 shell after the round
N_PARTICLES = 256     # bench.py's count: two 64-image chunks per half
R_LOCAL = 40          # bench.py's pinned band of the local rounds
# noise std relative to the clean stack's: bench.py uses 1.0, at which one
# global round at band r = 8 does not pin the poses down; 0.3 makes the
# pose check below meaningful
NOISE = 0.3
# the classification paths: configs/demo_3D.json (K = 4) on 4 x 128 images
# and configs/demo_2D.json (K = 30) on 30 x 64 images (class3d_dataset,
# class2d_dataset); bars on every round of them, set from the first card
# runs (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): path A read purity
# 1.0000 in all three rounds, path B 0.8745 in both, and path B's best
# class's shell 34 of its band 1 .. 34 in both
N_CLASS3D = 128
N_CLASS2D = 64
CLASS_PURITY_MIN = 0.95    # path A: share of images in their own class
CLASS2D_PURITY_MIN = 0.8   # path B (30 views of one phantom)
ROUND2D_RES_MIN = 30       # path B: best class's FRC-0.143 shell in band
# path C, CTF search and the final round: true defocus factors 1 + eps,
# eps ~ N(0, CTF_EPS_SD) (median |eps| ~ 0.0067 at entry); the phantom
# carries CTF_ATOMS small Gaussians (with their C4 mates) beside the blobs:
# the blobs hold no signal past shell ~15, where a 1 % defocus change
# moves the CTF phase by < 0.05 rad, and the first card run on them read
# the error rising to 0.024 (a random walk of the support); with the
# atoms it fell to 0.0022 after two CTF rounds (NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md), and CTF_DFAC_ERR_MAX is set from that reading. The
# joined final map's FSC against the phantom stays above 0.5 over shells
# 1 .. FINAL_FSC_SHELLS (the JAX package's bar, shells 1-4 of 12 in
# tests/test_final_round.py, scaled to 80 shells); FINAL_MC is the final
# band's accumulator crop (r_u = max_r = 78 at 160 px, table band 78)
CTF_EPS_SD = 0.01
ATOM_SD = 1.2        # path C's phantom detail (``phantom(atoms=...)``)
ATOM_HEIGHT = 0.5
CTF_ATOMS = 150
CTF_DFAC_ERR_MAX = 0.004
FINAL_FSC_SHELLS = 26
FINAL_MC = 317
# path D, the command-line entry point on path C's data written to files:
# CLI_ITERS rounds before the final round, all global (a .thu written
# after a local round stores only the shifts since its re-centring, as in
# the JAX package: ROADMAP Queue 3). The bars are set from the spread of
# 30 runs of ``--cli-study`` (11 at this script's seed, whose runs differ
# only by the kernels' atomic order, and 19 other seeds; NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md), each bar at least five of their standard
# deviations past their mean. Meta_Final.thu's shifts read 0.349-0.516 px
# from the true ones (median; 0.522 in one full smoke; META_TRANS_MAX),
# their mean error at most 0.141 px an axis (META_TRANS_BIAS_MAX) and
# their slope on the true ones 0.825-1.001 (META_TRANS_SLOPE: below 1, the
# stored shifts fall a little short of large true ones): a sign, scale
# or half-pixel fault of the stored shifts reads far outside these. The
# resume's local round, its reference low-passed to 25 A, read 2.50-3.75
# deg and is held to ROUND_ANG_MAX as every round; the same resume at the
# run's final resolution read 0.227-0.322 deg (RESUME_HI_ANG_MAX). The
# subtracted images' variance inside the mask radius over outside it read
# 4.06-4.36 (the input stack 15.09: the particle's signal over the noise;
# SUB_RESID_MAX) and 4.28-5.14 in the resume at the run's resolution
# (SUB_HI_MAX). The subtraction's own norm correction explains them: at
# the true poses, shifts and defocus factors the phantom leaves
# 0.990-0.992 with each image at its own scale, and 0.994 at one scale
# once the correction's factors (spread 36 %) are undone (SUB_TRUTH_MAX).
# The reconstruct tool's map (no CTF correction, as in the JAX package)
# read FSC 0.9905-0.9922 at least against the run's final map over
# shells 1 .. TOOL_RECON_SHELLS. Postprocess's FSC (its own mask and
# phase fields) read 0.021-0.032 from the run's final FSC at most over
# shells 1 .. the run's FSC-0.143 shell (TOOL_POST_FSC_TOL); the two
# curves are flat where they cross 0.143, so its shell read 0-8 above
# the run's
CLI_ITERS = 3
TOOL_RECON_SHELLS = 8
TOOL_POST_FSC_TOL = 0.06
META_TRANS_MAX = 0.7
META_TRANS_BIAS_MAX = 0.3
META_TRANS_SLOPE = (0.7, 1.1)
RESUME_HI_ANG_MAX = 0.6
SUB_RESID_MAX = 4.6
SUB_HI_MAX = 6.0
SUB_TRUTH_MAX = 1.05
# path G, a multi-process run: path D's dataset and config as MP_RANKS
# ranks of ``cli run`` on the one card (gloo: NCCL refuses two ranks on one
# device), each a process of its own under torchrun's variables, started
# and watched by this script, which kills them all when one fails or
# MP_WALL_S passes; the run is held to path D's bars (each round's poses
# and shell, Meta_Final.thu's shifts, the final shell, the final map
# against the phantom over shells 1 .. TOOL_RECON_SHELLS) and the resume's
# reassembled subtraction to SUB_RESID_MAX
MP_RANKS = 2
MP_WALL_S = 120
# each round's record of a multi-rank run carries each rank's largest gap
# to rank 0 in the references and the FSC before rank 0 broadcasts them
# (relative to their largest magnitude) and of the summed insert table's
# weight total to its hemisphere's data ranks' own totals gathered as
# numbers; those ranks sum identical all-reduced tables, so only the
# card's float atomics part their maps: MP_MAP_GAP_MAX on the maps, data
# ranks x 2^-22 on the total; on (2, W/2) it also counts the half maps
# each rank held to their owners' digests after the pair gather
MP_MAP_GAP_MAX = 1e-3
# path E, general point-group symmetry: bench.py's Para with sym I on 256
# images of an I-symmetric phantom (``sym_phantom`` of SYM_DESIGN: 30
# small Gaussians within 0.25 n of the centre, each under the 60 matrices
# of the port's Symmetry("I"), noise NOISE); every round held to
# ROUND_ANG_MAX (the nearest of 60 mates) and ROUND_RES_MIN, the joined
# final map to path C's FSC bar and to SYM_AVG_CORR_MIN with its own
# I-average, symmetrize_cropped to the plain full-grid symmetrize at
# SYM_CHECK_TOL of the peak. The design comes from ``--sym-study``
# (SYM_STUDY_DESIGNS; PERF.md): with blobs of a few pixels the 60 copies
# make a near-spherical map at the global round's band (r = 8), whose
# projections barely turn with the orientation (the first design, three
# blobs and four small Gaussians, read 21.0 deg at the global round and
# 18.4 deg after a local round); small Gaussians carry the orientation
# (2.92 and 0.16
# deg; NVIDIA H100 80GB HBM3, 700.00 W). The golden FSC of path E's
# rounds reads past the insert band (shell 79 at r_u = 34): both packages
# compute the same out-of-band values, a leakage of the in-band maps that
# both halves share (tests/test_torch_sym_fsc.py; PERF.md), so each
# round's half-0 map is also held to the phantom: FSC > SYM_TRUTH_FSC_MIN
# (the truth's 0.5 for the halves' 0.143) over shells 1 .. ROUND_RES_MIN.
# Path F, the MKB insert on phase 5's data: each round's half-0 MKB table
# at MKB_TOL of its exact f64 sum, its first chunk at MKB_F64_TOL of the
# blob gridded anew in float64, and the MKB reference from the
# post-global state above MKB_TRI_CORR_MIN against the trilinear one
# (1 - corr under ~10x the first card reading, 1.9e-4; the JAX package's
# own bar, tests/test_optimiser_parity.py, is 0.9). Each bar was checked
# against a prediction written in PERF.md before its first card run
SYM_GROUP = "I"
SYM_SEED = 3
SYM_DESIGN = {"axes": (), "blobs": 0, "blob_r": 0.25, "atoms": 30}
SYM_STUDY_DESIGNS = (
    {"blobs": 3, "blob_r": 0.2, "atoms": 4},
    {"atoms": 12},
    {},
    {"atoms": 40},
    {"atoms": 12, "axes": ((5, 0.3, 1 / 20, 1.0),)},
    {"axes": ((5, 0.3, 1 / 20, 1.0),)},
)
SYM_AVG_CORR_MIN = 0.99
SYM_CHECK_TOL = 1e-5
SYM_TRUTH_FSC_MIN = 0.5
MKB_TOL = 1e-5
MKB_F64_TOL = 1e-5
MKB_TRI_CORR_MIN = 0.998


def log(msg):
    print(f"[smoke +{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi unavailable"


def cuda_ms(fn, reps=10, warm=2):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def normalised(x):
    x = x.double()
    return x / x.sum(dim=tuple(range(1, x.ndim)), keepdim=True).clamp_min(
        1e-300)


# --------------------------------------------------------------------- K1

def k1_problem(gen, dev, b, r, t, p, scale=0.05, k=1, plant_all=False):
    """Random scan inputs shaped like the JAX package's fused-kernel test:
    projections of ``k`` classes, pose 3 of class 0 correlated with image
    0. With ``plant_all`` every image b has a posterior peak, as a real
    image has: translation 0 is the zero shift (the scan pins it,
    ``sampling.sample_translations``) and pose (37 b + 3) % r of class
    b % k is the image's Wiener-fitted projection, dat ctf / (ctf^2 +
    0.01)."""
    import torch

    from thunder_tpu_torch.ops import likelihood

    c64 = torch.complex64
    dat = torch.complex(torch.randn(b, p, generator=gen, device=dev),
                        torch.randn(b, p, generator=gen, device=dev))
    ctf = torch.rand(b, p, generator=gen, device=dev) * 2 - 1
    sig = 0.5 + 1.5 * torch.rand(b, p, generator=gen, device=dev)
    sig_rcp = likelihood.sigma_reciprocal(sig)
    proj = torch.complex(torch.randn(k, r, p, generator=gen, device=dev),
                         torch.randn(k, r, p, generator=gen, device=dev))
    proj = (proj * scale).to(c64)
    proj[0, 3] = dat[0] / ctf[0].clamp(min=0.05)
    if plant_all:
        for i in range(b):
            proj[i % k, (37 * i + 3) % r] = dat[i] * ctf[i] / (ctf[i] ** 2
                                                               + 0.01)
    phase = 2 * torch.pi * torch.rand(t, p, generator=gen, device=dev)
    if plant_all:
        phase[0] = 0.0
    tra = torch.complex(torch.cos(phase), torch.sin(phase))
    pm = (torch.rand(p, generator=gen, device=dev) > 0.1).float()
    q, e = likelihood._q_e(dat, ctf, sig_rcp, pm)
    pr = torch.full((b, r), 1.0 / r, device=dev)
    pt = torch.full((b, t), 1.0 / t, device=dev)
    return q.to(c64), e.float(), proj, tra.to(c64), pr, pt


def k1_bound_ms(b, k, r, t, p):
    """Least time for the scan FUNCTION, whatever implements it: its
    operations (4 B K R T P for term 1, 2 B K R P for term 2) over the
    bf16 tensor-core peak, or its bytes (q, e, proj, tra and the priors
    read once as passed, wR, wT, wC written once) over HBM."""
    flops = 4.0 * b * k * r * t * p + 2.0 * b * k * r * p
    nbytes = (b * p * 8 + b * p * 4 + k * r * p * 8 + t * p * 8
              + b * r * 4 + b * t * 4                          # inputs
              + b * k * r * 4 + b * k * t * 4 + b * k * 4)     # outputs
    by_ops, by_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BPS * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def sass_counts(lib_path):
    """Tensor-core instructions (HGMMA / HMMA) in the global-scan kernel's
    SASS and the atomic opcodes of the insert kernel, from cuobjdump; None
    where cuobjdump is absent."""
    import os
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300).stdout
    counts, atomics, fn = {}, set(), ""
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            continue
        ins = line.split("*/")[1].strip() if "*/" in line else ""
        op = ins.split()[0] if ins else ""
        if op.startswith("@"):
            op = ins.split()[1]
        if "global_scan" in fn and op.startswith(("HGMMA", "HMMA")):
            counts[op.split(".")[0]] = counts.get(op.split(".")[0], 0) + 1
        if "insert" in fn and op.startswith(("RED", "ATOM")):
            atomics.add(op)
    return {"global_scan": counts, "insert_atomics": sorted(atomics)}


def device_ms(fn, names, reps=20):
    """Mean time on the card per call of ``fn`` of the kernels whose names
    hold one of ``names``, from a torch.profiler trace of ``reps`` calls
    (CUPTI kernel intervals; host time excluded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and any(n in e.name for n in names)]
    if not kern:
        raise AssertionError(f"profiler saw no kernel named {names}")
    busy_us = sum(e.time_range.end - e.time_range.start for e in kern)
    return busy_us / 1e3 / reps


K1_KERNELS = ("global_scan_kernel", "merge_kernel")


def k1_tile_errs(q, e, proj, tra, pr, pt):
    """K1's raw per-tile outputs against ``scan_tiles_plain`` (f32), and
    its merge kernel against ``merge_tiles`` of those same tiles: max
    |kernel - plain| / max |plain| each."""
    from thunder_tpu_torch.ops import likelihood

    tiles, merged = likelihood.scan_tiles_kernel(q, e, proj, tra, pr, pt)
    ref = likelihood.scan_tiles_plain(likelihood.pack_scan(q, e, proj, tra,
                                                           pr, pt))
    rel = lambda a, b: float((a - b).abs().max()
                             / b.abs().max().clamp_min(1e-30))
    merge_ref = likelihood.merge_tiles(tiles, proj.shape[0], proj.shape[1])
    return ({name: rel(tiles[name], ref[name])
             for name in ("base", "wr", "wc", "wt")},
            max(rel(merged[name], merge_ref[name])
                for name in ("wC", "wR", "wT", "baseline")))


def check_k1(dev):
    import torch

    from thunder_tpu_torch.ops import likelihood

    gen = torch.Generator(device=dev).manual_seed(11)
    rows = []
    launches0 = likelihood.LAUNCHES["scan_fused"]
    for (b, r, t, p) in ((64, 256, 30, 256), (37, 200, 7, 256),
                         (16, 256, 70, 256)):
        q, e, proj, tra, pr, pt = k1_problem(gen, dev, b, r, t, p)
        ref = likelihood.scan_plain(q, e, proj, tra, pr, pt)
        got = likelihood.scan_fused(q, e, proj, tra, pr, pt)
        tile_rels, merge_rel = k1_tile_errs(q, e, proj, tra, pr, pt)
        torch.cuda.synchronize()
        errs, rels = {}, {}
        for name in ("wC", "wR", "wT"):
            if not torch.isfinite(got[name]).all():
                raise AssertionError(f"K1 {name} not finite at {(b, r, t, p)}")
            rels[name] = float((ref[name] - got[name]).abs().max()
                               / ref[name].abs().max())
            if name != "wC":
                errs[name] = float((normalised(ref[name])
                                    - normalised(got[name])).abs().max())
        top_ref = ref["wR"].reshape(b, -1).argmax(1)
        top_got = got["wR"].reshape(b, -1).argmax(1)
        agree = float((top_ref == top_got).float().mean())
        log(f"K1 B={b} R={r} T={t} P={p}: max |norm err| "
            f"wR={errs['wR']:.3e} wT={errs['wT']:.3e}; raw rel wC="
            f"{rels['wC']:.3e} wR={rels['wR']:.3e} wT={rels['wT']:.3e}; "
            f"argmax agreement {agree:.3f}; raw tile outputs rel "
            + " ".join(f"{k}={v:.3e}" for k, v in tile_rels.items())
            + f"; merge kernel rel {merge_rel:.3e}")
        if (max(errs.values()) > K1_TOL or max(rels.values()) > K1_RAW_TOL
                or max(tile_rels.values()) > K1_RAW_TOL
                or merge_rel > K1_MERGE_TOL or agree < K1_ARGMAX_MIN):
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{(b, r, t, p)}: normalised {errs}, raw "
                                 f"{rels}, tiles {tile_rels}, merge "
                                 f"{merge_rel}, argmax {agree}")
        if top_ref[0] != top_got[0]:
            raise AssertionError("K1 misses the planted top pose")
        rows.append(dict(shape=(b, r, t, p), errs=errs, agree=agree,
                         inputs=(q, e, proj, tra, pr, pt)))
    # timing at the slice shape: the wrapper as the round calls it (checks,
    # two allocations, one library call: scan + merge) and the batched-
    # matmul yardstick in turns, the plain version, and the kernels' own
    # time on the card from a profiler trace
    q, e, proj, tra, pr, pt = rows[0]["inputs"]
    b, r, t, p = rows[0]["shape"]
    wrapper = lambda: likelihood.scan_fused(q, e, proj, tra, pr, pt)
    lib = batched_matmul(q, tra, proj)
    ms_a = cuda_ms(wrapper, reps=50)
    lib_a = cuda_ms(lib, reps=50)
    plain_ms = cuda_ms(lambda: likelihood.scan_plain(q, e, proj, tra, pr,
                                                     pt))
    lib_b = cuda_ms(lib, reps=50)
    ms_b = cuda_ms(wrapper, reps=50)
    ms, lib_ms = (ms_a + ms_b) / 2, (lib_a + lib_b) / 2
    dev_ms = device_ms(wrapper, K1_KERNELS)
    bound, by = k1_bound_ms(b, 1, r, t, p)
    log(f"K1 time at slice shape: wrapper {ms_a:.4f} / {ms_b:.4f} ms "
        f"(first / last in turn), batched matmul {lib_a:.4f} / {lib_b:.4f} "
        f"ms, plain {plain_ms:.4f} ms; on the card (profiler, scan + "
        f"merge) {dev_ms:.4f} ms; bound {bound:.6f} ms ({by}), share of "
        f"the wrapper {bound / ms:.4f}, of the card time {bound / dev_ms:.4f}")
    # throughput shape: B = 1024 images in one call
    bt = 1024
    q2, e2, proj2, tra2, pr2, pt2 = k1_problem(gen, dev, bt, r, t, p)
    wrapper2 = lambda: likelihood.scan_fused(q2, e2, proj2, tra2, pr2, pt2)
    ms_big = cuda_ms(wrapper2, reps=20)
    lib_big = cuda_ms(batched_matmul(q2, tra2, proj2), reps=20)
    dev_big = device_ms(wrapper2, K1_KERNELS)
    bound_big, by_big = k1_bound_ms(bt, 1, r, t, p)
    log(f"K1 time at B={bt} R={r} T={t} P={p}: wrapper {ms_big:.4f} ms, "
        f"on the card {dev_big:.4f} ms, batched matmul {lib_big:.4f} ms, "
        f"bound {bound_big:.6f} ms ({by_big}), share of bound "
        f"{bound_big / ms_big:.4f}, {4.0 * bt * r * t * p / ms_big / 1e9:.1f}"
        f" TFLOP/s of term 1")
    likelihood.LAUNCHES["scan_fused"] = launches0  # check/timing launches
    return dict(max_abs_err=max(max(x["errs"].values()) for x in rows),
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by=by, device_ms=dev_ms, ms_b1024=ms_big,
                device_ms_b1024=dev_big, library_ms_b1024=lib_big,
                bound_ms_b1024=bound_big)


# shapes of K1 on the classification paths: the global scan at the r = 8
# ring (256 padded pixels) and 151 translations (trans_s 10 px)
K1_CLASS_SHAPES = (("class3d", 64, 4, 2500, 151, 256),   # demo_3D: 10000/4
                   ("class2d", 64, 30, 100, 151, 256))   # demo_2D: m_s 100


def check_k1_classes(dev):
    """K1 at the classification paths' class-stacked shapes against
    ``scan_plain`` (merged outputs, normalised wC included: with K > 1 the
    class marginal is a real output), ``scan_tiles_plain`` (raw per-tile
    outputs: each class's poses padded to whole 64-pose tiles) and
    ``merge_tiles`` (the per-class sum over tiles), under the K = 1 bars,
    on two problems a shape: ``k1_problem``'s (one image correlated with
    one pose) and the same with a posterior peak planted in every image
    (``plant_all``). The top-pose bar and the planted peaks are held on the
    second: among 10,000 random poses an image without a peak has near-ties
    that bf16 flips (the first problem read 0.938 top-pose agreement at
    the 3D shape on the first card run, errors within the bars). Then the
    wrapper timed in turns with the batched-matmul yardstick."""
    import torch

    from thunder_tpu_torch.ops import likelihood

    gen = torch.Generator(device=dev).manual_seed(13)
    launches0 = likelihood.LAUNCHES["scan_fused"]
    out = {}
    for label, b, k, r, t, p in K1_CLASS_SHAPES:
        errs, rels, agree = {}, {}, {}
        for plant in (False, True):
            inputs = k1_problem(gen, dev, b, r, t, p, k=k, plant_all=plant)
            ref = likelihood.scan_plain(*inputs)
            got = likelihood.scan_fused(*inputs)
            tile_rels, merge_rel = k1_tile_errs(*inputs)
            torch.cuda.synchronize()
            for name in ("wC", "wR", "wT"):
                if not torch.isfinite(got[name]).all():
                    raise AssertionError(f"K1 {name} not finite at {label}")
                rels[name] = max(rels.get(name, 0.0), float(
                    (ref[name] - got[name]).abs().max()
                    / ref[name].abs().max()))
                errs[name] = max(errs.get(name, 0.0), float(
                    (normalised(ref[name]) - normalised(got[name]))
                    .abs().max()))
            top_ref = ref["wR"].reshape(b, -1).argmax(1)
            top_got = got["wR"].reshape(b, -1).argmax(1)
            agree[plant] = float((top_ref == top_got).float().mean())
            cls_agree = float((ref["wC"].argmax(1) == got["wC"].argmax(1))
                              .float().mean())
            log(f"K1 {label} B={b} K={k} R={r} T={t} P={p}"
                f"{' (a peak planted in every image)' if plant else ''}: "
                "max |norm err| " + " ".join(
                    f"{x}={v:.3e}" for x, v in errs.items())
                + "; raw rel " + " ".join(
                    f"{x}={v:.3e}" for x, v in rels.items())
                + f"; argmax agreement pose {agree[plant]:.3f} class "
                f"{cls_agree:.3f}; raw tile outputs rel " + " ".join(
                    f"{x}={v:.3e}" for x, v in tile_rels.items())
                + f"; merge kernel rel {merge_rel:.3e}")
            if (max(errs.values()) > K1_TOL
                    or max(rels.values()) > K1_RAW_TOL
                    or max(tile_rels.values()) > K1_RAW_TOL
                    or merge_rel > K1_MERGE_TOL):
                raise AssertionError(
                    f"K1 disagrees with its plain version at {label}: "
                    f"normalised {errs}, raw {rels}, tiles {tile_rels}, "
                    f"merge {merge_rel}")
            if plant:
                planted = torch.tensor([(i % k) * r + (37 * i + 3) % r
                                        for i in range(b)], device=dev)
                hits = float((top_got == planted).float().mean())
                log(f"K1 {label}: planted peaks found by the kernel "
                    f"{hits:.3f}, by the plain version "
                    f"{float((top_ref == planted).float().mean()):.3f}")
                if agree[plant] < K1_ARGMAX_MIN or hits < 1.0:
                    raise AssertionError(f"K1 top poses at {label}: "
                                         f"agreement {agree[plant]}, planted "
                                         f"peaks found {hits}")
            del ref, got
        q, e, proj, tra, pr, pt = inputs
        wrapper = lambda: likelihood.scan_fused(q, e, proj, tra, pr, pt)
        lib = batched_matmul(q, tra, proj)
        ms_a, lib_a = cuda_ms(wrapper, reps=20), cuda_ms(lib, reps=20)
        plain_ms = cuda_ms(lambda: likelihood.scan_plain(q, e, proj, tra, pr,
                                                         pt), reps=3, warm=1)
        lib_b, ms_b = cuda_ms(lib, reps=20), cuda_ms(wrapper, reps=20)
        ms, lib_ms = (ms_a + ms_b) / 2, (lib_a + lib_b) / 2
        dev_ms = device_ms(wrapper, K1_KERNELS, reps=10)
        bound, by = k1_bound_ms(b, k, r, t, p)
        log(f"K1 {label} time: wrapper {ms_a:.4f} / {ms_b:.4f} ms, batched "
            f"matmul {lib_a:.4f} / {lib_b:.4f} ms, plain {plain_ms:.4f} ms; "
            f"on the card (profiler) {dev_ms:.4f} ms; bound {bound:.6f} ms "
            f"({by}), share of the wrapper {bound / ms:.4f}")
        out[label] = dict(shape=[b, k, r, t, p],
                          max_abs_err=max(errs.values()),
                          wc_norm_err=errs["wC"], argmax_no_plant=agree[False],
                          ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound, bound_by=by, device_ms=dev_ms)
        del q, e, proj, tra, pr, pt, inputs
    likelihood.LAUNCHES["scan_fused"] = launches0  # check/timing launches
    return out


def batched_matmul(q, tra, proj):
    """The yardstick: term 1 of every (image, translation, pose) as two
    batched torch.matmul calls (no term 2, no marginals)."""
    import torch

    p = q.shape[1]
    pk = proj.reshape(-1, p)
    pk_re, pk_im = pk.real.contiguous(), pk.imag.contiguous()

    def run():
        qt = q[None] * tra[:, None, :]                  # (T, B, P)
        return (torch.matmul(qt.real, pk_re.T)
                - torch.matmul(qt.imag, pk_im.T))

    return run


# --------------------------------------------------------------------- K2

def k2_bound(idx, r_pad):
    """What this call's data needs: every sample read once (28 B), and each
    table row that some sample hits read and written once (2 x 96 B);
    rows no sample hits need no traffic."""
    import torch

    keep = (idx >= 0) & (idx < r_pad)
    hit = int(torch.unique(idx[keep]).numel())
    n_samples = idx.shape[0]
    nbytes = n_samples * 28 + 2 * 96 * hit
    flops = n_samples * (16 + 48)
    by_b, by_o = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    return ((by_b, "bytes") if by_b >= by_o else (by_o, "operations")), hit


def time_k2(tab, idx, fr, fi, tv, frac, reps=10):
    """Kernel and index_add_ in turns on the same channel-minor table:
    kernel, index_add_, index_add_, kernel; returns the means."""
    from thunder_tpu_torch.ops import insert

    contrib = insert.corner_contrib(fr, fi, tv, frac)
    keep = (idx >= 0) & (idx < tab.shape[1])
    idx_l = idx[keep].long()
    contrib = contrib[keep]
    kern = lambda: insert.insert_update(tab, idx, fr, fi, tv, frac)
    lib = lambda: tab.T.index_add_(0, idx_l, contrib)
    ka = cuda_ms(kern, reps=reps)
    la = cuda_ms(lib, reps=reps)
    lb = cuda_ms(lib, reps=reps)
    kb = cuda_ms(kern, reps=reps)
    return (ka + kb) / 2, (la + lb) / 2, (ka, la, lb, kb)


def check_k2(dev, n_samples, mc):
    import torch

    from thunder_tpu_torch.ops import insert

    gen = torch.Generator(device=dev).manual_seed(12)
    n_rows = mc ** 3 + 1
    r_pad = insert.rows_pad(n_rows)
    idx = torch.randint(0, n_rows, (n_samples,), generator=gen, device=dev,
                        dtype=torch.int32)
    fr, fi, tv = (torch.randn(n_samples, generator=gen, device=dev)
                  for _ in range(3))
    frac = torch.rand(n_samples, 3, generator=gen, device=dev)
    tab0 = insert.new_table(r_pad, device=dev)
    tab0.copy_(torch.randn(24, r_pad, generator=gen, device=dev))
    fresh = lambda: tab0.T.clone().T  # channel-minor copy
    ref = insert.insert_update_plain(fresh(), idx, fr, fi, tv, frac)
    out = insert.insert_update(fresh(), idx, fr, fi, tv, frac)
    torch.cuda.synchronize()
    abs_err = float((out - ref).abs().max())
    rel = abs_err / float(ref.abs().max())
    log(f"K2 N={n_samples} mc={mc}: max abs err {abs_err:.3e}, "
        f"rel {rel:.3e}")
    if not rel < K2_TOL:
        raise AssertionError(f"K2 disagrees with its plain version: {rel}")
    # empty insert and every sample on the drop row
    z = torch.zeros(0, device=dev)
    same = insert.insert_update(fresh(), idx[:0], z, z, z, frac[:0])
    if not torch.equal(same, tab0):
        raise AssertionError("K2 empty insert changed the table")
    drop = torch.full((1000,), mc ** 3, dtype=torch.int32, device=dev)
    ones = torch.ones(1000, device=dev)
    out_d = insert.insert_update(fresh(), drop, ones, 2 * ones,
                                 3 * ones, torch.zeros(1000, 3, device=dev))
    torch.cuda.synchronize()
    if not torch.equal(out_d[:, :mc ** 3], tab0[:, :mc ** 3]):
        raise AssertionError("K2 all-dropped insert touched voxel rows")
    log("K2 empty and all-dropped cases hold")
    del ref, out, same, out_d

    launches0 = insert.LAUNCHES["insert_update"]
    tab = fresh()
    ms, lib_ms, turns = time_k2(tab, idx, fr, fi, tv, frac)
    plain_ms = cuda_ms(lambda: insert.insert_update_plain(tab, idx, fr, fi,
                                                          tv, frac))
    insert.LAUNCHES["insert_update"] = launches0
    (bound, by), hit = k2_bound(idx, r_pad)
    log(f"K2 time at random rows: kernel {ms:.4f} ms, index_add_ "
        f"{lib_ms:.4f} ms (turns kernel/index_add_/index_add_/kernel "
        + "/".join(f"{x:.4f}" for x in turns) + f"), plain {plain_ms:.4f} "
        f"ms, bound {bound:.4f} ms ({by}; {hit} of {r_pad} rows hit)")
    return dict(max_abs_err=abs_err, rel_err=rel, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by)


def k2_main_path(dev, call):
    """K2 on the round's own first insert call (captured arguments): on a
    fresh table, held at K2_TOL against the f64 sum of its plain version's
    f32 corner rows (the plain version itself is logged beside it), then
    timed in turns with index_add_ on a fresh channel-minor table."""
    import torch

    from thunder_tpu_torch.ops import insert

    tab, idx, fr, fi, tv, frac = call
    launches0 = insert.LAUNCHES["insert_update"]
    r_pad = tab.shape[1]
    got = insert.insert_update(insert.new_table(r_pad, device=dev),
                               idx, fr, fi, tv, frac)
    plain = insert.insert_update_plain(insert.new_table(r_pad, device=dev),
                                       idx, fr, fi, tv, frac)
    # the same f32 corner rows summed in f64: the centre row takes ~1e4
    # large terms, so two f32 atomic orders differ by twice the error of
    # either; the f64 sum isolates the kernel's own
    keep = (idx >= 0) & (idx < r_pad)
    exact = torch.zeros((r_pad, 24), dtype=torch.float64, device=dev)
    exact.index_add_(0, idx[keep].long(),
                     insert.corner_contrib(fr, fi, tv, frac)[keep].double())
    exact = exact.T
    torch.cuda.synchronize()
    scale = float(exact.abs().max())
    rel = float((got.double() - exact).abs().max()) / scale
    rel_plain = float((plain.double() - exact).abs().max()) / scale
    rel_pair = float((got - plain).abs().max()) / float(plain.abs().max())
    log(f"K2 on the round's first insert: max |err| / max |exact| "
        f"{rel:.3e} (kernel), {rel_plain:.3e} (plain version, index_add_ "
        f"in f32); kernel against plain {rel_pair:.3e}")
    if not rel < K2_TOL:
        raise AssertionError(f"K2 disagrees with the exact sum of its plain "
                             f"version's rows on the round's samples: {rel}")
    del got, plain, exact
    work = insert.new_table(r_pad, device=dev)
    ms, lib_ms, turns = time_k2(work, idx, fr, fi, tv, frac)
    insert.LAUNCHES["insert_update"] = launches0
    (bound, by), hit = k2_bound(idx, r_pad)
    log(f"K2 on the round's first insert ({idx.shape[0]} samples, "
        f"R_pad {r_pad}, {hit} rows hit): kernel {ms:.4f} ms, "
        f"index_add_ {lib_ms:.4f} ms (turns "
        + "/".join(f"{x:.4f}" for x in turns)
        + f"), bound {bound:.4f} ms ({by}), share {bound / ms:.4f}")
    return dict(main_path_ms=ms, main_path_library_ms=lib_ms,
                main_path_bound_ms=bound, main_path_samples=idx.shape[0],
                main_path_rows_hit=hit, main_path_rel_err=rel,
                main_path_rel_err_plain=rel_plain)


def exact_table(calls, r_pad, dev, step=1 << 23):
    """The f64 sum of the f32 corner rows of every call, in slices."""
    import torch

    from thunder_tpu_torch.ops import insert

    exact = torch.zeros((r_pad, 24), dtype=torch.float64, device=dev)
    for _, idx, fr, fi, tv, frac in calls:
        for a in range(0, idx.shape[0], step):
            sl = slice(a, a + step)
            keep = (idx[sl] >= 0) & (idx[sl] < r_pad)
            rows = insert.corner_contrib(fr[sl], fi[sl], tv[sl], frac[sl])
            exact.index_add_(0, idx[sl][keep].long(), rows[keep].double())
    return exact.T


def k2_local_table(dev, calls, label="a local round", key="local_round"):
    """K2 on a round's whole per-half table (``label``; a local round's by
    default): the table as the fold received it (every call of the half,
    both chunks) against the f64 sum of all those calls' f32 corner rows
    at K2_TOL, the plain version's error beside it; then K2 and index_add_
    timed in turns on one chunk's samples, with the bound counted by the
    rows hit. The readings' keys start with ``key``."""
    import torch

    from thunder_tpu_torch.ops import insert

    tab = calls[0][0]
    r_pad = tab.shape[1]
    exact = exact_table(calls, r_pad, dev)
    plain = insert.new_table(r_pad, device=dev)
    for call in calls:
        insert.insert_update_plain(plain, *call[1:])
    torch.cuda.synchronize()
    scale = float(exact.abs().max())
    rel = float((tab.double() - exact).abs().max()) / scale
    rel_plain = float((plain.double() - exact).abs().max()) / scale
    n_samples = sum(c[1].shape[0] for c in calls)
    log(f"K2 on {label}'s whole half table ({len(calls)} calls, "
        f"{n_samples} samples, R_pad {r_pad}): max |err| / max |exact| "
        f"{rel:.3e} (kernel), {rel_plain:.3e} (plain version, index_add_ in "
        f"f32)")
    if not rel < K2_TOL:
        raise AssertionError(f"K2's accumulated table disagrees with the "
                             f"exact sum of its rows: {rel}")
    del exact, plain
    launches0 = insert.LAUNCHES["insert_update"]
    _, idx, fr, fi, tv, frac = calls[0]
    work = insert.new_table(r_pad, device=dev)
    ms, lib_ms, turns = time_k2(work, idx, fr, fi, tv, frac, reps=5)
    insert.LAUNCHES["insert_update"] = launches0
    (bound, by), hit = k2_bound(idx, r_pad)
    log(f"K2 on a chunk of {label} ({idx.shape[0]} samples, {hit} rows "
        f"hit): kernel {ms:.4f} ms, index_add_ {lib_ms:.4f} ms (turns "
        + "/".join(f"{x:.4f}" for x in turns)
        + f"), bound {bound:.4f} ms ({by}), share {bound / ms:.4f}")
    out = dict(ms=ms, library_ms=lib_ms, bound_ms=bound, bound_by=by,
               samples=idx.shape[0], rows_hit=hit, rows=r_pad, rel_err=rel,
               rel_err_plain=rel_plain)
    return {f"{key}_{k}": v for k, v in out.items()}


# ------------------------------------------------------------ the round

def phantom(n, rng, symmetric=True, atoms=0):
    """bench.py's 6-blob phantom (n, n, n) from ``rng``, made C4-symmetric
    about z unless ``symmetric`` is False (bench.py's is not). ``atoms``
    > 0 adds that many small Gaussians (sd ATOM_SD px, height ATOM_HEIGHT,
    each with its C4 mates when ``symmetric``) in the blobs' cube: detail
    out to high shells, which the blobs (sd n/30 .. n/12 px) do not
    carry."""
    import numpy as np

    g = np.mgrid[:n, :n, :n].astype(np.float32) - n // 2
    vol = np.zeros((n, n, n), np.float32)
    for _ in range(6):
        c = rng.uniform(-n / 5, n / 5, 3)
        s = rng.uniform(n / 30, n / 12)
        # each blob with its 3 images under C4 about z, so the phantom has
        # the symmetry the refinement imposes (bench.py's has none)
        mates = ((c[0], c[1]), (-c[1], c[0]), (-c[0], -c[1]), (c[1], -c[0]))
        for cx, cy in mates[:4 if symmetric else 1]:
            vol += np.exp(-((g[0] - c[2]) ** 2 + (g[1] - cy) ** 2
                            + (g[2] - cx) ** 2) / (2 * s * s))
    w = int(np.ceil(4 * ATOM_SD))
    for c in rng.uniform(-n / 5, n / 5, (atoms, 3)):
        mates = ((c[0], c[1]), (-c[1], c[0]), (-c[0], -c[1]), (c[1], -c[0]))
        for cx, cy in mates[:4 if symmetric else 1]:
            ctr = np.array([c[2], cy, cx]) + n // 2   # (z, y, x) voxel
            lo = np.floor(ctr).astype(int) - w
            sl = tuple(slice(a, a + 2 * w + 2) for a in lo)
            d2 = sum(((np.arange(a, a + 2 * w + 2) - x) ** 2).reshape(
                [-1 if i == j else 1 for j in range(3)])
                for i, (a, x) in enumerate(zip(lo, ctr)))
            vol[sl] += ATOM_HEIGHT * np.exp(-d2 / (2 * ATOM_SD ** 2))
    return vol


def project_stack(dev, vol, b, rng, noise, trans_sd=2.0, dfac=None,
                  with_trans=False):
    """``b`` images of ``vol`` at uniform random poses: projected,
    CTF-modulated, shifted by N(0, trans_sd) px, plus Gaussian noise of
    ``noise`` x the clean stack's std. ``dfac`` (b,) scales each image's
    defocus_u and defocus_v in its CTF (a true defocus factor); the CTF
    parameters returned are the unscaled ones. Returns (stack, quats, CTF
    params), and the shifts (b, 2) after them with ``with_trans``."""
    import numpy as np
    import torch

    from thunder_tpu_torch.core import projector
    from thunder_tpu_torch.geom import quat
    from thunder_tpu_torch.ops import ctf as ctf_ops
    from thunder_tpu_torch.ops import fft as fft_ops
    from thunder_tpu_torch.ops.translate import translate_ft

    n = vol.shape[-1]
    q = rng.normal(size=(b, 4))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    tr = rng.normal(0, trans_sd, (b, 2)).astype(np.float32)
    cp = dict(voltage=np.full(b, 300e3), defocus_u=rng.uniform(1e4, 2e4, b),
              defocus_v=rng.uniform(1e4, 2e4, b), defocus_theta=np.zeros(b),
              cs=np.zeros(b), amp_contrast=np.full(b, 0.1),
              phase_shift=np.zeros(b))
    cp = {k: v.astype(np.float32) for k, v in cp.items()}
    cp_img = dict(cp) if dfac is None else {
        **cp, "defocus_u": (cp["defocus_u"] * dfac).astype(np.float32),
        "defocus_v": (cp["defocus_v"] * dfac).astype(np.float32)}
    vf = projector.build_projectee_3d(torch.as_tensor(vol, device=dev), pf=2)
    f = torch.arange(n, device=dev) - n // 2
    colf = f[None, :].expand(n, n).reshape(-1).float()
    rowf = f[:, None].expand(n, n).reshape(-1).float()
    chunks = []
    for s0 in range(0, b, 32):
        sl = slice(s0, s0 + 32)
        rots = quat.rotate3d(torch.as_tensor(q[sl], device=dev))
        proj = projector.project_full_3d(vf, rots, n, n // 2 - 1, pf=2)
        c2d = ctf_ops.ctf_pixels(colf, rowf, n, 1.32, *[
            torch.as_tensor(cp_img[k][sl], device=dev)[:, None] for k in
            ("voltage", "defocus_u", "defocus_v", "defocus_theta", "cs",
             "amp_contrast", "phase_shift")]).reshape(-1, n, n)
        sl_ft = translate_ft(proj * c2d, torch.as_tensor(tr[sl, 0], device=dev),
                             torch.as_tensor(tr[sl, 1], device=dev))
        chunks.append(fft_ops.ifft2_center(sl_ft).real.cpu().numpy())
    del vf
    stack = np.concatenate(chunks).astype(np.float32)
    stack += rng.normal(0, noise * stack.std(), stack.shape).astype(
        np.float32)
    return (stack, q, cp, tr) if with_trans else (stack, q, cp)


def synthetic_dataset(dev, n, b, seed=0, noise=1.0, symmetric=True,
                      dfac_sd=0.0, atoms=0, with_trans=False):
    """bench.py's workload made with NumPy + the port: a 6-blob phantom
    (``phantom``) projected at random poses, CTF-modulated, shifted, plus
    Gaussian noise of ``noise`` x the clean stack's std
    (``project_stack``). With ``dfac_sd`` > 0 each image's CTF is made at a
    true defocus factor 1 + eps, eps ~ N(0, dfac_sd) from the seed, and the
    factors come back as a fifth value; ``with_trans`` appends the true
    shifts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vol = phantom(n, rng, symmetric, atoms)
    if not dfac_sd:
        out = project_stack(dev, vol, b, rng, noise, with_trans=with_trans)
        return (vol,) + out
    dfac = 1.0 + rng.normal(0, dfac_sd, b)
    stack, q, cp, *tr = project_stack(dev, vol, b, rng, noise, dfac=dfac,
                                      with_trans=with_trans)
    return (vol, stack, q, cp, dfac, *tr)


def bench_para(n=160):
    """bench.py's Para."""
    from thunder_tpu_torch.config import Para

    return Para(
        mode="3d", k=1, size=n, pixel_size=1.32, mask_radius=75.0,
        trans_s=2.0, init_res=25.0, global_search_res=15.0, sym="C4",
        m_s=1024, m_l_r=125, m_l_t=9, m_l_d=9, m_reco=100,
        c_search=False, l_search=True, pf=2, seed=7, image_batch=64,
        save_ref_each_iter=False, save_thu_each_iter=False)


def pin_local(opt, r=R_LOCAL):
    """bench.py's pin_local: a LOCAL round at band r, ladder not moving."""
    from thunder_tpu_torch.core import optimiser as om

    opt.ladder.search_type = om.SEARCH_TYPE_LOCAL
    opt.ladder.r = r
    opt.ladder.n_no_decrease = 0


def pose_error(opt, q_true, sym="C4"):
    """Per-image angle (deg) from the top pose to the nearest mate of the
    true pose under the group ``sym`` (``pose_error_q``)."""
    return pose_error_q(opt.best_quat, q_true, sym)


def pose_error_q(q_est, q_true, sym="C4"):
    """Per-image angle (deg) from ``q_est`` to the nearest mate g q_true of
    the true pose, g in the point group ``sym`` (C4 for paths A-D, I for
    path E). The scan reduces rotations into the fundamental domain by
    LEFT multiplication (symmetry_counterpart: conj(g) q), and a
    symmetric reference projects alike at q and g q."""
    import numpy as np

    from thunder_tpu_torch.geom.symmetry import Symmetry

    mates = Symmetry(sym).quat_with_identity()
    best = np.zeros(len(q_est))
    w2, x2, y2, z2 = q_true.T
    for w1, x1, y1, z1 in mates:
        gq = np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                       w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                       w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                       w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], 1)
        best = np.maximum(best, np.abs(np.sum(gq * q_est, 1)))
    return 2 * np.degrees(np.arccos(np.clip(best, -1, 1)))


def drive_round(opt, label, capture=None):
    """One ``run_iteration`` with the kernels' launch counts set to 0 just
    before it and read just after, and the device's peak memory over it.
    ``capture(args)`` sees every K2 call's arguments (by reference)."""
    import torch

    from thunder_tpu_torch.ops import insert, likelihood
    from thunder_tpu_torch.parallel import engine

    dev = opt.device
    if capture is not None:
        def hook(*args):
            capture(args)
            return insert.insert_update(*args)
        engine.insert_update = hook
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    likelihood.LAUNCHES["scan_fused"] = 0
    insert.LAUNCHES["insert_update"] = 0
    t0 = time.perf_counter()
    try:
        rec = opt.run_iteration()
        opt._sync()
    finally:
        engine.insert_update = insert.insert_update
    wall = time.perf_counter() - t0
    launches = {"global_scan": likelihood.LAUNCHES["scan_fused"],
                "insert_update": insert.LAUNCHES["insert_update"]}
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else float("nan"))
    log(f"{label} done in {wall:.2f} s; launches {launches}; peak device "
        f"memory {peak:.3f} GiB")
    log(f"{label} stage seconds: " + json.dumps(
        {k: round(v, 4) for k, v in rec["timing"].items()}))
    log(f"{label}: n_phase (mean, max) = {rec['n_phase']}, res shell "
        f"{rec['res_shell']} ({rec['res_a']:.2f} A), ladder r {rec['r']}, "
        f"search type {rec['search_type']}")
    return rec, wall, launches, peak


def check_maps(opt, n):
    import numpy as np
    import torch

    refs = opt.refs
    if tuple(refs.shape) != (2, 1, n, n, n) or not torch.isfinite(refs).all():
        raise AssertionError("non-finite or mis-shaped reference maps")
    if not np.isfinite(opt.fsc).all():
        raise AssertionError("non-finite FSC")


def check_poses(opt, q_true, rec, label, bounds, sym="C4"):
    """Median top-pose error against the truth (the mates under ``sym``
    allowed) under ROUND_ANG_MAX and the FSC-0.143 shell at ROUND_RES_MIN
    or above."""
    import numpy as np

    ang = pose_error(opt, q_true, sym)
    med = float(np.median(ang))
    log(f"{label} pose recovery: median top-pose error {med:.2f} deg "
        f"(p25 {np.percentile(ang, 25):.2f}, p75 {np.percentile(ang, 75):.2f}"
        f"), share under {ROUND_ANG_MAX} deg "
        f"{float(np.mean(ang < ROUND_ANG_MAX)):.3f}")
    if bounds:
        if not med < ROUND_ANG_MAX:
            raise AssertionError(f"{label}: median pose error {med} >= "
                                 f"{ROUND_ANG_MAX}")
        if rec["res_shell"] < ROUND_RES_MIN:
            raise AssertionError(f"{label}: resolution shell "
                                 f"{rec['res_shell']} < {ROUND_RES_MIN}")
    return med


def check_local_state(opt, label):
    """After a local round: norm-correction factors finite with their
    median (valid slots) within 1e-3 of 1, sigma finite and positive below
    r, offsets finite."""
    import numpy as np

    valid = opt.plane_valid > 0
    fac = opt.norm_fac.cpu().numpy()[valid]
    sig = opt.sig.cpu().numpy()[:, :opt.ladder.r]
    offs = opt.offsets.cpu().numpy()
    med = float(np.median(fac))
    log(f"{label}: norm factors median {med:.6f} (min {fac.min():.4f}, max "
        f"{fac.max():.4f}); sigma below r in [{sig.min():.4e}, "
        f"{sig.max():.4e}]; offsets |max| {np.abs(offs).max():.3f} px")
    if not np.isfinite(fac).all() or abs(med - 1.0) > 1e-3:
        raise AssertionError(f"{label}: norm factors non-finite or median "
                             f"{med} off 1")
    if not (np.isfinite(sig).all() and (sig > 0).all()):
        raise AssertionError(f"{label}: sigma non-finite or not positive "
                             "below r")
    if not np.isfinite(offs).all():
        raise AssertionError(f"{label}: non-finite offsets")


def make_optimiser(dev, n=160, b=N_PARTICLES, noise=NOISE, symmetric=True,
                   para=None):
    """bench.py's optimiser (or one of ``para``) on synthetic data; returns
    (opt, true quats)."""
    from thunder_tpu_torch.core.optimiser import Optimiser

    vol, stack, q_true, cp = synthetic_dataset(dev, n, b, noise=noise,
                                               symmetric=symmetric)
    log(f"synthetic stack built: {stack.shape} ({b} particles as in "
        f"bench.py), noise {noise} x signal std, "
        f"{'C4-symmetric' if symmetric else 'asymmetric'} phantom")
    opt = Optimiser(para or bench_para(n), device=dev)
    opt.set_data(stack, cp)
    opt.init_reference(vol=vol)
    opt.init_sigma()
    opt._sync()
    return opt, q_true


def run_round(dev, n=160, b=N_PARTICLES, noise=NOISE, symmetric=True,
              bounds=True):
    """The global warm-up round on synthetic data; with ``bounds`` its pose
    error and resolution are held to ROUND_ANG_MAX / ROUND_RES_MIN.
    Returns (opt, q_true, launches, the round's first K2 call)."""
    opt, q_true = make_optimiser(dev, n, b, noise, symmetric)
    log("optimiser ready; running the global round")
    calls = []

    def first(args):
        if not calls:
            calls.append(args)

    rec, _, launches, _ = drive_round(opt, "global round", capture=first)
    held = sum(x.numel() * x.element_size() for x in calls[0][1:]) / 2 ** 30
    log(f"(the peak includes the captured first insert call's samples, "
        f"{held:.2f} GiB, held past their use; profile_torch.py reads the "
        f"peak without them)")
    if bounds:
        for name, c in launches.items():
            if c <= 0:
                raise AssertionError(f"kernel {name} was not launched in "
                                     "the global round")
    check_maps(opt, n)
    check_poses(opt, q_true, rec, "global round", bounds)
    return opt, q_true, launches, calls[0]


def run_local_rounds(opt, q_true, bounds=True, label="pinned local round",
                     on_half0=None):
    """Two local rounds pinned as bench.py pins them. With ``bounds``: K1
    launched 0 times and K2 at least 4 times in each (2 halves x 2 chunks
    at 256 particles), poses and resolution within the global round's
    bars, and the norm factors, sigma and offsets sane. ``on_half0(calls)``
    gets the first round's K2 calls of half 0 (its table and samples, held
    by reference) before the second round runs. Returns (launches per
    round, peak GiB of the second round)."""
    half0, peak = [], None
    per_round = []

    def grab(args):
        if not half0 or args[0] is half0[0][0]:
            half0.append(args)

    for i in (1, 2):
        pin_local(opt)
        rec, _, launches, peak = drive_round(
            opt, f"{label} {i}", capture=grab if i == 1 and on_half0 else None)
        per_round.append(launches)
        check_maps(opt, opt.n)
        check_poses(opt, q_true, rec, f"{label} {i}", bounds)
        if bounds:
            if launches["global_scan"] != 0 or launches["insert_update"] < 4:
                raise AssertionError(f"{label} {i}: launches {launches}, "
                                     "expected global_scan 0 and "
                                     "insert_update >= 4")
            check_local_state(opt, f"{label} {i}")
        if half0:
            on_half0(half0)
            half0.clear()
    return per_round, peak


def time_local_rounds(opt, reps=2):
    """Further pinned local rounds, timed (no checks, no capture)."""
    import numpy as np

    walls = []
    for i in range(reps):
        pin_local(opt)
        _, wall, _, _ = drive_round(opt, f"timed local round {i + 1}")
        walls.append(wall)
    med = float(np.median(walls))
    log(f"timed local rounds: {[round(w, 3) for w in walls]} s, median "
        f"{med:.3f} s, {N_PARTICLES / med:.2f} particles/s (a progress "
        f"reading, not a benchmark)")
    return walls, med


# ------------------------------------------------- CTF search, final round

def ctf_para(out_dir, n=160):
    """Path C's Para: bench.py's with CTF search on, configs/demo.json's
    defocus support (m_l_d 9) and ctf_refine_s (0.01), and both per-round
    save flags on, writing into ``out_dir``."""
    import dataclasses

    return dataclasses.replace(
        bench_para(n), c_search=True, m_l_d=9, ctf_refine_s=0.01,
        save_ref_each_iter=True, save_thu_each_iter=True,
        output_directory=out_dir)


def pin_ctf(opt, r=R_LOCAL):
    """A CTF-search round at band r, entered as the optimiser enters it:
    ``LadderState.transition`` resets the ladder's counters on the switch
    (without it the round reads the previous round's counters and the
    ladder stops after it), then ``run_iteration`` seeds the defocus
    support (``_seed_defocus_search``)."""
    from thunder_tpu_torch.core import optimiser as om

    opt.ladder.search_type = om.SEARCH_TYPE_CTF
    opt.ladder.r = r
    opt.ladder._reset_counters()
    opt._seed_defocus_search()


def dfac_error(opt, dfac):
    """Median |topD - true factor| over the images."""
    import numpy as np

    return float(np.median(np.abs(opt.best_defocus - dfac)))


def expected_files(rounds, k=1):
    """The file names the JAX package's ``save_outputs`` writes in 3D with
    both save flags on, for the saved ``rounds`` (iteration numbers) and
    the final set (src/Optimiser.cpp:8250-9149 naming)."""
    names = set()
    for tag in [f"Round_{i:03d}" for i in rounds] + ["Final"]:
        names |= {f"FSC_{tag}.txt", f"Class_Info_{tag}.txt",
                  f"Meta_{tag}.thu"}
        names |= {f"Reference_{c:03d}_{h}_{tag}.mrc" for c in range(k)
                  for h in "AB"}
        if tag == "Final":
            names |= {f"Reference_{c:03d}_Final.mrc" for c in range(k)}
        else:
            names |= {f"{x}_{h}_{tag}.txt" for x in ("Sig", "Tau")
                      for h in "AB"} | {f"Timing_{tag}.txt"}
    return names


def check_files(opt, out_dir, rounds):
    """Every file of the per-round and final sets is there and nothing
    else; the maps read back through the port's ``read_mrc`` at n^3 with
    the pixel size as voxel size; Meta_Final.thu reads back through
    ``read_thu`` with one 27-column row per image and ``best_defocus`` in
    its defocus-factor column."""
    import os

    import numpy as np

    from thunder_tpu_torch.io import ThuColumns, read_mrc, read_thu

    got = set(os.listdir(out_dir))
    want = expected_files(rounds, opt.para.k)
    if got != want:
        raise AssertionError(f"path C files: missing {sorted(want - got)}, "
                             f"unexpected {sorted(got - want)}")
    n, ps = opt.n, opt.para.pixel_size
    for name in sorted(x for x in got if x.endswith(".mrc")):
        vol, hdr = read_mrc(os.path.join(out_dir, name), return_header=True)
        if vol.shape != (n, n, n) or abs(hdr.voxel_size - ps) > 1e-5 \
                or not np.isfinite(vol).all():
            raise AssertionError(f"{name}: shape {vol.shape}, voxel size "
                                 f"{hdr.voxel_size}")
    t = read_thu(os.path.join(out_dir, "Meta_Final.thu"))
    col = t.values[:, ThuColumns.DEFOCUS_FACTOR]
    d_err = float(np.abs(col - opt.best_defocus).max())
    log(f"path C files: {len(got)} as the JAX package names them; "
        f"{sum(x.endswith('.mrc') for x in got)} maps read back at "
        f"({n}, {n}, {n}), voxel {ps}; Meta_Final.thu {t.values.shape}, "
        f"defocus column against best_defocus max |diff| {d_err:.2e}")
    if t.values.shape != (opt.n_imgs, 27) or d_err > 1e-6:
        raise AssertionError(f"Meta_Final.thu: shape {t.values.shape}, "
                             f"defocus column off by {d_err}")


def check_ctf_round(opt, q_true, rec, launches, label, dfac):
    """A CTF round: K1 launched 0 times, K2 4 times, poses and resolution
    within ROUND_ANG_MAX / ROUND_RES_MIN, sD finite and positive, the
    defocus support (2, S, m_l_d). Returns the median defocus error."""
    import numpy as np

    expect_launches(label, launches, False, 4)
    check_maps(opt, opt.n)
    check_poses(opt, q_true, rec, label, True)
    s_d = opt.par["sD"].cpu().numpy()[opt.plane_valid > 0]
    shape = tuple(opt.par["d"].shape)
    err = dfac_error(opt, dfac)
    log(f"{label}: median |topD - true factor| {err:.5f}; sD median "
        f"{float(np.median(s_d)):.2e} (min {s_d.min():.2e}); d {shape}")
    if not (np.isfinite(s_d).all() and (s_d > 0).all()):
        raise AssertionError(f"{label}: sD not finite and positive")
    if shape != (2, opt.s_slots, opt.para.m_l_d):
        raise AssertionError(f"{label}: defocus support shape {shape}")
    return err


def ctf_optimiser(dev, out_dir, n=160, b=N_PARTICLES, atoms=CTF_ATOMS):
    """Path C's optimiser (``ctf_para``) on bench.py's workload whose CTFs
    were made at true defocus factors 1 + eps, eps ~ N(0, CTF_EPS_SD); the
    optimiser is given the unscaled defocus. Returns (opt, phantom, true
    quats, true factors)."""
    from thunder_tpu_torch.core.optimiser import Optimiser

    vol, stack, q_true, cp, dfac = synthetic_dataset(
        dev, n, b, noise=NOISE, dfac_sd=CTF_EPS_SD, atoms=atoms)
    log(f"path C stack built: {stack.shape}, true defocus factors "
        f"1 + N(0, {CTF_EPS_SD}); output in a fresh temporary directory")
    opt = Optimiser(ctf_para(out_dir, n), device=dev)
    opt.set_data(stack, cp)
    opt.init_reference(vol=vol)
    opt.init_sigma()
    opt._sync()
    return opt, vol, q_true, dfac


def run_ctf_path(dev, k2, n=160, b=N_PARTICLES):
    """Path C: a CTF-search refinement to its end on bench.py's shape and
    256 particles whose CTFs were made at true defocus factors 1 + eps,
    eps ~ N(0, CTF_EPS_SD) (the optimiser is given the unscaled defocus):
    a global round, a local round pinned at r = 40, a CTF round pinned
    there (``pin_ctf``) with its files (``save_outputs``, as ``run`` calls
    it), then ``run(max_iter=1)``: a second CTF round with its files and
    the final round at the Nyquist band with the final set. Holds each
    round's launches, poses and resolution, the defocus error, K2's whole
    final-band half-0 table against the exact sum (readings into ``k2``),
    the joined map's FSC against the phantom and the files. Returns the
    launches per round."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from thunder_tpu_torch.core.optimiser import SEARCH_TYPE_CTF
    from thunder_tpu_torch.ops import fft as fft_ops
    from thunder_tpu_torch.ops import insert, likelihood, spectrum
    from thunder_tpu_torch.parallel import engine

    out_dir = tempfile.mkdtemp(prefix="thunder_smoke_")
    try:
        opt, vol, q_true, dfac = ctf_optimiser(dev, out_dir, n, b)
        per = {}
        rec, _, per["ctf_path_global"], _ = drive_round(
            opt, "path C global round")
        expect_launches("path C global round", per["ctf_path_global"], True,
                        4)
        check_poses(opt, q_true, rec, "path C global round", True)
        pin_local(opt)
        rec, _, per["ctf_path_local"], _ = drive_round(
            opt, "path C local round")
        expect_launches("path C local round", per["ctf_path_local"], False,
                        4)
        check_poses(opt, q_true, rec, "path C local round", True)
        err0 = float(np.median(np.abs(dfac - 1.0)))
        log(f"path C defocus error at entry (median |eps|): {err0:.5f}")
        pin_ctf(opt)
        rec, wall1, per["ctf_round_1"], peak1 = drive_round(
            opt, "path C CTF round 1")
        err1 = check_ctf_round(opt, q_true, rec, per["ctf_round_1"],
                               "path C CTF round 1", dfac)
        saved = [opt.iteration]
        opt.save_outputs()
        if opt.ladder.search_type != SEARCH_TYPE_CTF:
            raise AssertionError("path C: the ladder left CTF search after "
                                 "one round; run() would not run a CTF "
                                 "round")

        # run(max_iter=1): the second CTF round, its files, and finalise;
        # the counts are read at the entry to finalise and after it, and
        # half 0's K2 calls of the final round are kept
        final, half0 = {}, []
        finalise = opt.finalise

        def grab(args):
            if not half0 or args[0] is half0[0][0]:
                half0.append(args)

        def counted_finalise():
            opt._sync()
            final["ctf_round_2"] = {
                "global_scan": likelihood.LAUNCHES["scan_fused"],
                "insert_update": insert.LAUNCHES["insert_update"]}
            final["ctf_peak"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            likelihood.LAUNCHES["scan_fused"] = 0
            insert.LAUNCHES["insert_update"] = 0
            torch.cuda.reset_peak_memory_stats(dev)

            def hook(*args):
                grab(args)
                return insert.insert_update(*args)
            engine.insert_update = hook
            t0 = time.perf_counter()
            try:
                finalise()
                opt._sync()
            finally:
                engine.insert_update = insert.insert_update
            final["wall"] = time.perf_counter() - t0
            final["final_round"] = {
                "global_scan": likelihood.LAUNCHES["scan_fused"],
                "insert_update": insert.LAUNCHES["insert_update"]}
            final["peak"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30

        opt.finalise = counted_finalise
        likelihood.LAUNCHES["scan_fused"] = 0
        insert.LAUNCHES["insert_update"] = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        opt.run(max_iter=1)
        wall_run = time.perf_counter() - t0
        rec = opt.history[-1]
        saved.append(rec["iter"])
        per["ctf_round_2"] = final["ctf_round_2"]
        per["final_round"] = final["final_round"]
        log(f"path C CTF round 2 (in run) + final round: {wall_run:.2f} s; "
            f"CTF round 2 launches {per['ctf_round_2']}, peak device "
            f"memory {final['ctf_peak']:.3f} GiB; stage seconds "
            + json.dumps({k: round(v, 4) for k, v in rec["timing"].items()}))
        log(f"path C CTF round 2: n_phase (mean, max) = {rec['n_phase']}, "
            f"res shell {rec['res_shell']}, search type {rec['search_type']}")
        err2 = check_ctf_round(opt, q_true, rec, per["ctf_round_2"],
                               "path C CTF round 2", dfac)
        log(f"path C defocus error: entry {err0:.5f}, after CTF round 1 "
            f"{err1:.5f}, after CTF round 2 {err2:.5f} (bar "
            f"{CTF_DFAC_ERR_MAX})")
        if not (err2 < err0 and err2 <= CTF_DFAC_ERR_MAX):
            raise AssertionError(f"path C: defocus error {err2} not below "
                                 f"its entry value {err0} and "
                                 f"{CTF_DFAC_ERR_MAX}")

        mc = opt.insert_mc(opt.max_r)
        log(f"path C final round: {final['wall']:.2f} s, launches "
            f"{per['final_round']}, mc {mc}, peak device memory "
            f"{final['peak']:.3f} GiB; stage seconds " + json.dumps(
                {k: round(v, 4) for k, v in opt.final_timing.items()}))
        expect_launches("path C final round", per["final_round"], False, 4)
        if mc != FINAL_MC:
            raise AssertionError(f"path C final round: mc {mc} != {FINAL_MC}")
        k2.update(k2_local_table(dev, half0, label="the final round",
                                 key="final_band"), final_band_mc=mc)
        del half0
        log("path C readings: " + json.dumps(dict(
            ctf_round_1_s=wall1, ctf_round_1_peak_gib=peak1,
            ctf_round_2_and_final_s=wall_run,
            ctf_round_2_peak_gib=final["ctf_peak"],
            final_round_s=final["wall"], final_round_peak_gib=final["peak"],
            final_stage_s=opt.final_timing, dfac_err_entry=err0,
            dfac_err_ctf_1=err1, dfac_err_ctf_2=err2)))
        check_maps(opt, opt.n)
        joined = opt.joined_maps[0]
        fsc = spectrum.frc_fsc(
            fft_ops.fft3_center(joined),
            fft_ops.fft3_center(torch.as_tensor(vol, device=dev)),
            opt.n // 2, 3).cpu().numpy()
        res = spectrum.res_p(torch.as_tensor(opt.fsc[0]), 0.143, r_low=1)
        low = fsc[1:FINAL_FSC_SHELLS + 1]
        log(f"path C joined map against the phantom: FSC min over shells 1 "
            f".. {FINAL_FSC_SHELLS} {low.min():.4f} (first shell under 0.5: "
            f"{int(np.argmax(fsc[1:] < 0.5)) + 1}); final FSC-0.143 shell "
            f"{res}")
        if not (np.isfinite(joined.cpu().numpy()).all() and low.min() > 0.5):
            raise AssertionError("path C: joined map's FSC against the "
                                 f"phantom {low}")
        if res < ROUND_RES_MIN:
            raise AssertionError(f"path C: final FSC shell {res} < "
                                 f"{ROUND_RES_MIN}")
        check_files(opt, out_dir, saved)
        del opt
        return per
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def ctf_study(dev):
    """--data-study: path C's rounds on the blob phantom alone (no atoms):
    a global round, a local round and two CTF rounds pinned at r = 40, the
    median defocus error after each, no bounds. It shows why path C's
    phantom carries detail past shell 15."""
    import shutil
    import tempfile

    import numpy as np

    from thunder_tpu_torch.core.optimiser import SEARCH_TYPE_CTF

    out_dir = tempfile.mkdtemp(prefix="thunder_smoke_")
    opt, _, q_true, dfac = ctf_optimiser(dev, out_dir, atoms=0)
    opt.run_iteration()
    pin_local(opt)
    opt.run_iteration()
    log(f"CTF study (blob phantom): defocus error at entry "
        f"{float(np.median(np.abs(dfac - 1.0))):.5f}")
    pin_ctf(opt)
    for i in (1, 2):
        # the second round keeps the support, whatever the ladder decided
        opt.ladder.search_type, opt.ladder.r = SEARCH_TYPE_CTF, R_LOCAL
        rec = opt.run_iteration()
        log(f"CTF study (blob phantom) CTF round {i}: defocus error "
            f"{dfac_error(opt, dfac):.5f}, median pose error "
            f"{float(np.median(pose_error(opt, q_true))):.2f} deg, res shell "
            f"{rec['res_shell']}")
    del opt
    shutil.rmtree(out_dir, ignore_errors=True)


# ------------------------------------------- the command-line entry point

def cli_config(data_dir, db, out, g_search=True, iters=CLI_ITERS,
               subtract=False, n=160, init_res=25.0):
    """configs/demo.json as users write it, with bench.py's sizes (160 px,
    pixel 1.32 A, mask 75 A, translation 2 px, initial resolution
    ``init_res`` A (bench.py's 25), C4, 1024 scan points, 125 x 9 x 9 local
    support, 100 insert draws; a smaller box ``n`` scales the mask), the
    dataset's paths, ``iters`` rounds and the given search and subtraction
    switches."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "demo.json")) as f:
        cfg = json.load(f)
    basic, adv = cfg["Basic"], cfg["Advanced"]
    basic.update({
        "Global Search": g_search, "Size of Image": n,
        "Pixel Size (Angstrom)": 1.32,
        "Radius of Mask on Images (Angstrom)": 75.0 * n / 160,
        "Estimated Translation (Pixel)": 2,
        "Initial Resolution (Angstrom)": init_res, "Symmetry": "C4",
        "Initial Model": f"{data_dir}/init.mrc",
        ".thu File Storing Paths and CTFs of Images": str(db),
        "Path of Particles": data_dir, "Path of Output": out})
    adv.update({
        "Max Number of Iteration": iters,
        "Number of Sampling Points for Scanning in Global Search (3D)": 1024,
        "Number of Sampling Points of Rotation in Local Search (3D)": 125,
        "Number of Sampling Points of Translation in Local Search": 9,
        "Number of Sampling Points of Defocus in Local Search": 9,
        "Number of Sampling Points Used in Reconstruction": 100})
    cfg["Subtract"]["Subtract Masked Region Reference From Images"] = subtract
    return cfg


def write_cli_dataset(dev, data_dir, n=160, b=N_PARTICLES):
    """Path C's data (phantom with atoms, true defocus factors) written as
    a user hands it over: stack.mrcs, particles.thu (absolute particle
    paths, two micrograph names, coordinates, the unscaled defocus) and
    init.mrc (the phantom). Returns (the stack, the truth: phantom
    ``vol``, quats ``q``, shifts ``tr`` and defocus factors ``dfac``)."""
    import numpy as np

    from thunder_tpu_torch.io import write_mrc
    from thunder_tpu_torch.io.thu import make_table, write_thu

    vol, stack, q_true, cp, dfac, tr = synthetic_dataset(
        dev, n, b, noise=NOISE, dfac_sd=CTF_EPS_SD, atoms=CTF_ATOMS,
        with_trans=True)
    write_mrc(f"{data_dir}/stack.mrcs", stack, voxel_size=1.32)
    write_mrc(f"{data_dir}/init.mrc", vol, voxel_size=1.32)
    rng = np.random.default_rng(3)
    t = make_table(
        b, particle_paths=[f"{i + 1}@{data_dir}/stack.mrcs" for i in range(b)],
        micrograph_paths=[f"mic_{i % 2:03d}.mrc" for i in range(b)],
        coordinate_x=rng.uniform(0, 4096, b),
        coordinate_y=rng.uniform(0, 4096, b), voltage=cp["voltage"],
        defocus_u=cp["defocus_u"], defocus_v=cp["defocus_v"],
        defocus_theta=cp["defocus_theta"], cs=cp["cs"],
        amplitude_contrast=cp["amp_contrast"], phase_shift=cp["phase_shift"])
    write_thu(f"{data_dir}/particles.thu", t)
    return stack, dict(vol=vol, q=q_true, tr=tr, dfac=dfac)


def cli_call(argv):
    """``thunder_tpu_torch.cli.main(argv)`` in this process (so that the
    launch counters see it); returns (seconds, what it printed)."""
    import contextlib
    import io

    from thunder_tpu_torch.cli.main import main as cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli([str(a) for a in argv])
    return time.perf_counter() - t0, buf.getvalue()


def counted_rounds(q_true, rounds):
    """Wrap ``Optimiser.run_iteration`` so that each round of a CLI run is
    recorded in ``rounds``: its search type and top poses on entry,
    launches, wall time, record and median pose error (C4 mates allowed).
    Returns the undo."""
    import numpy as np

    from thunder_tpu_torch.core.optimiser import Optimiser
    from thunder_tpu_torch.ops import insert, likelihood

    orig = Optimiser.run_iteration

    def run_iteration(self):
        st_in = self.ladder.search_type
        entry = dict(quat=self.best_quat, trans=self.best_trans,
                     defocus=self.best_defocus)
        before = (likelihood.LAUNCHES["scan_fused"],
                  insert.LAUNCHES["insert_update"])
        t0 = time.perf_counter()
        rec = orig(self)
        self._sync()
        rounds.append(dict(
            search_type_in=st_in, entry=entry,
            wall=time.perf_counter() - t0, rec=rec,
            launches={"global_scan": likelihood.LAUNCHES["scan_fused"]
                      - before[0], "insert_update":
                      insert.LAUNCHES["insert_update"] - before[1]},
            pose_err=float(np.median(pose_error(self, q_true)))))
        return rec

    Optimiser.run_iteration = run_iteration
    return lambda: setattr(Optimiser, "run_iteration", orig)


def cli_run(dev, cfg_path, q_true, label, subtract=False):
    """One ``cli run`` with the counts set to 0 just before it and read
    just after; every round held to ROUND_ANG_MAX / ROUND_RES_MIN and to
    its launches (K1 in global rounds only, K2 four times a round: 2
    halves x 2 chunks of 64), the final round's four K2 launches and, in
    a subtraction run, the second Nyquist reconstruction's four. Returns
    (launches, rounds, wall seconds, printed history, peak GiB)."""
    import torch

    from thunder_tpu_torch.core.optimiser import SEARCH_TYPE_GLOBAL
    from thunder_tpu_torch.ops import insert, likelihood

    rounds = []
    undo = counted_rounds(q_true, rounds)
    torch.cuda.reset_peak_memory_stats(dev)
    likelihood.LAUNCHES["scan_fused"] = 0
    insert.LAUNCHES["insert_update"] = 0
    try:
        wall, out = cli_call(["run", cfg_path])
    finally:
        undo()
    launches = {"global_scan": likelihood.LAUNCHES["scan_fused"],
                "insert_update": insert.LAUNCHES["insert_update"]}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    history = [json.loads(x) for x in out.splitlines()]
    if [h["iter"] for h in history] != [r["rec"]["iter"] for r in rounds]:
        raise AssertionError(f"{label}: printed history {history} does not "
                             "match its rounds")
    for i, r in enumerate(rounds, 1):
        rec = r["rec"]
        glob = r["search_type_in"] == SEARCH_TYPE_GLOBAL
        log(f"{label} round {i} (search type {r['search_type_in']}): "
            f"{r['wall']:.2f} s, launches {r['launches']}, median pose "
            f"error {r['pose_err']:.2f} deg, res shell {rec['res_shell']}, "
            f"ladder r {rec['r']}")
        expect_launches(f"{label} round {i}", r["launches"], glob, 4)
        if not (r["pose_err"] < ROUND_ANG_MAX
                and rec["res_shell"] >= ROUND_RES_MIN):
            raise AssertionError(f"{label} round {i}: pose error "
                                 f"{r['pose_err']} / shell "
                                 f"{rec['res_shell']}")
    expect_launches(label, launches,
                    any(r["launches"]["global_scan"] for r in rounds),
                    4 * (len(rounds) + 1 + subtract))
    if launches["global_scan"] != sum(r["launches"]["global_scan"]
                                      for r in rounds):
        raise AssertionError(f"{label}: K1 launched outside the rounds")
    log(f"{label}: {wall:.2f} s for {len(rounds)} rounds and the final round,"
        f" launches {launches}, peak device memory {peak:.3f} GiB")
    return launches, rounds, wall, history, peak


def check_cli_files(out, rounds, paths, n=160):
    """The run's file set is the JAX package's for these rounds plus
    thunder.log; its maps read back at n^3 with voxel 1.32; Meta_Final.thu
    has a row per particle carrying the dataset's particle paths."""
    import numpy as np

    from thunder_tpu_torch.io import read_mrc, read_thu

    got = set(os.listdir(out))
    want = expected_files(rounds) | {"thunder.log"}
    if got != want:
        raise AssertionError(f"path D files: missing {sorted(want - got)}, "
                             f"unexpected {sorted(got - want)}")
    for name in sorted(x for x in got if x.endswith(".mrc")):
        vol, hdr = read_mrc(os.path.join(out, name), return_header=True)
        if vol.shape != (n,) * 3 or abs(hdr.voxel_size - 1.32) > 1e-5 \
                or not np.isfinite(vol).all():
            raise AssertionError(f"path D {name}: shape {vol.shape}, voxel "
                                 f"{hdr.voxel_size}")
    t = read_thu(os.path.join(out, "Meta_Final.thu"))
    if t.values.shape != (len(paths), 27) or t.particle_paths != paths:
        raise AssertionError("path D Meta_Final.thu: shape "
                             f"{t.values.shape} or particle paths differ")
    log(f"path D files: {len(got)} as the JAX package names them (and "
        f"thunder.log); maps read back at {n}^3, voxel 1.32; Meta_Final.thu "
        f"{t.values.shape} with the dataset's particle paths")
    return t


def residual_ratio(imgs, r_mask):
    """Variance of images (b, n, n) inside the radius ``r_mask`` over their
    variance outside it, each image's mean removed."""
    import numpy as np

    n = imgs.shape[-1]
    g = np.mgrid[:n, :n] - n // 2
    inside = np.sqrt((g ** 2).sum(0)) < r_mask
    s = imgs - imgs.mean(axis=(1, 2), keepdims=True)
    return float(np.mean(s[:, inside] ** 2) / np.mean(s[:, ~inside] ** 2))


def subtracted_stack(out, b, n):
    """Subtract_Rank_000000.mrcs of a run of ``b`` images read back with
    Meta_Subtract.thu and checked: 4 b images, g-major, finite."""
    import numpy as np

    from thunder_tpu_torch.io import read_mrc, read_thu

    sub = read_mrc(os.path.join(out, "Subtract_Rank_000000.mrcs"))
    meta = read_thu(os.path.join(out, "Meta_Subtract.thu"))
    if sub.shape != (4 * b, n, n) or len(meta) != 4 * b:
        raise AssertionError(f"path D subtraction: stack {sub.shape}, "
                             f"table {len(meta)} rows")
    want = [f"{gi * b + l + 1}@Subtract_Rank_000000.mrcs"
            for l in range(b) for gi in range(4)]
    if meta.particle_paths != want or not np.isfinite(sub).all():
        raise AssertionError("path D subtraction: Meta_Subtract.thu paths "
                             "or non-finite images")
    return sub


def subtraction_residual(out, stack_in, r_mask):
    """``residual_ratio`` of the identity copies of the subtracted stack
    (1 when the particle is wholly subtracted and what is left is the
    added noise) and of the input stack (the signal's share before
    subtraction)."""
    b, n = stack_in.shape[:2]
    sub = subtracted_stack(out, b, n)
    return (residual_ratio(sub[:b], r_mask), residual_ratio(stack_in, r_mask),
            sub.shape)


def map_fsc(dev, a, b):
    """FSC of two real maps (NumPy in), per shell."""
    import torch

    from thunder_tpu_torch.ops import fft as fft_ops
    from thunder_tpu_torch.ops import spectrum

    t = lambda x: torch.as_tensor(x, device=dev)
    return spectrum.frc_fsc(fft_ops.fft3_center(t(a)), fft_ops.fft3_center(
        t(b)), a.shape[-1] // 2, 3).cpu().numpy()


def fsc_difference(post_fsc, run_fsc, last):
    """Largest |difference| over shells 1 .. ``last`` between each FSC
    column of the postprocess tool's table (unmasked, masked, true) and
    the run's FSC_Final.txt (class 0)."""
    import numpy as np

    post = np.loadtxt(post_fsc, ndmin=2)
    run = np.loadtxt(run_fsc, ndmin=2)
    run = dict(zip(run[:, 0].astype(int), run[:, 2]))
    shells = [i for i in range(1, last + 1) if i in run and i < len(post)]
    want = np.array([run[i] for i in shells])
    return {name: float(np.abs(post[shells, col] - want).max())
            for col, name in ((1, "unmasked"), (2, "masked"), (3, "true"))}


def run_tools(dev, out, work, final_shell, card):
    """Every other subcommand once on the run's outputs, each read back
    and held to its bar; prints each one's seconds."""
    import numpy as np

    from thunder_tpu_torch.io import read_mrc, read_thu, write_mrc

    fin = f"{out}/Reference_000_Final.mrc"
    half = [f"{out}/Reference_000_{h}_Final.mrc" for h in "AB"]
    meta = f"{out}/Meta_Final.thu"
    ref = read_mrc(fin)
    a, b = (read_mrc(x) for x in half)
    n, c = ref.shape[-1], ref.shape[-1] // 2
    n_img = len(read_thu(meta))
    secs = {}

    def tool(name, argv):
        secs[name], printed = cli_call(argv)
        log(f"path D {name}: {secs[name]:.2f} s; " + " | ".join(
            printed.strip().splitlines()))
        return printed

    tool("reconstruct", ["reconstruct", meta, f"{work}/recon.mrc",
                         "--pixel-size", "1.32"])
    fsc = map_fsc(dev, read_mrc(f"{work}/recon.mrc"), ref)
    low = fsc[1:TOOL_RECON_SHELLS + 1]
    log(f"path D reconstruct: FSC against the run's final map min over "
        f"shells 1 .. {TOOL_RECON_SHELLS} {low.min():.4f} (first under 0.5: "
        f"{int(np.argmax(fsc[1:] < 0.5)) + 1})")
    if not low.min() > 0.5:
        raise AssertionError(f"path D reconstruct: FSC {low}")
    printed = tool("postprocess", ["postprocess", *half, f"{work}/post.mrc",
                                   "--fsc", f"{work}/post_fsc.txt"])
    shell = int(printed.split("(shell ")[1].split(")")[0])
    post = read_mrc(f"{work}/post.mrc")
    fsc_shape = np.loadtxt(f"{work}/post_fsc.txt").shape
    diff = fsc_difference(f"{work}/post_fsc.txt", f"{out}/FSC_Final.txt",
                          final_shell)
    log(f"path D postprocess: shell {shell}, the run's {final_shell}; FSC "
        f"against the run's over shells 1 .. {final_shell}, largest "
        f"difference {json.dumps(diff)} (bar {TOOL_POST_FSC_TOL} on true)")
    if not diff["true"] < TOOL_POST_FSC_TOL \
            or not np.isfinite(post).all() or fsc_shape != (c, 4):
        raise AssertionError(
            f"path D postprocess: shell {shell} against the run's "
            f"{final_shell}, FSC difference {diff}, "
            f"{int(np.sum(~np.isfinite(post)))} non-finite voxels, FSC "
            f"table {fsc_shape}")
    tool("genmask", ["genmask", fin, f"{work}/mask.mrc"])
    m = read_mrc(f"{work}/mask.mrc")
    share = float((m > 0.5).mean())
    if not (m.min() >= 0 and m.max() <= 1 and 0.001 < share < 0.5):
        raise AssertionError(f"path D genmask: range [{m.min()}, {m.max()}],"
                             f" share inside {share}")
    tool("genmask_shell", ["genmask_shell", f"{work}/shell.mrc", "--boxsize",
                           n, "--inner-radius", 0.125 * n * 1.32,
                           "--outer-radius", 0.375 * n * 1.32,
                           "--edgewidth", 2, "--pixelsize", 1.32])
    s = read_mrc(f"{work}/shell.mrc")
    if s.shape != (n,) * 3 or s[c, c, c] != 0 or s[c, c, c + n // 4] != 1:
        raise AssertionError("path D genmask_shell: wrong shell")
    # cutoff at shell n / 8 (shell 20 of 80 at 160 px, 10.6 A)
    tool("lowpass", ["lowpass", fin, f"{work}/lp.mrc", "--resolution",
                     8 * 1.32])
    tool("bfactor", ["bfactor", fin, f"{work}/bf.mrc", "--bfactor", -50])
    lp, bf = read_mrc(f"{work}/lp.mrc"), read_mrc(f"{work}/bf.mrc")
    fl = map_fsc(dev, lp, ref)
    if not (np.isfinite(bf).all() and bf.std() > ref.std()
            and fl[n // 32] > 0.99 and abs(fl[n // 4]) < 0.1):
        raise AssertionError(f"path D lowpass/bfactor: FSC {fl}; std "
                             f"{bf.std()} vs {ref.std()}")
    tool("mask", ["mask", fin, f"{work}/mask.mrc", f"{work}/masked.mrc"])
    tool("average", ["average", *half, f"{work}/avg.mrc"])
    tool("minus", ["minus", *half, f"{work}/minus.mrc"])
    for name, want in (("masked", ref * m), ("avg", (a + b) / 2),
                       ("minus", a - b)):
        if not np.array_equal(read_mrc(f"{work}/{name}.mrc"), want):
            raise AssertionError(f"path D {name}: not the element-wise map")
    tool("resize", ["resize", fin, f"{work}/small.mrc", "--size", n * 4 // 5])
    small, hdr = read_mrc(f"{work}/small.mrc", return_header=True)
    if small.shape != (n * 4 // 5,) * 3 \
            or abs(hdr.voxel_size - 1.32 * n / (n * 4 // 5)) > 1e-5:
        raise AssertionError(f"path D resize: {small.shape}, voxel "
                             f"{hdr.voxel_size}")
    tool("alignz", ["alignz", fin, f"{work}/az.mrc", "--axis", "0,0,1"])
    if not np.allclose(read_mrc(f"{work}/az.mrc"), ref, atol=1e-6):
        raise AssertionError("path D alignz: +z is not the identity")
    tool("view", ["view", fin, "--slices", f"{work}/slice"])
    for p in ("xy", "xz", "yz"):
        if os.path.getsize(f"{work}/slice_{p}.bmp") != 14 + 40 + 1024 \
                + n * n:
            raise AssertionError(f"path D view: slice_{p}.bmp size")
    tool("project", ["project", fin, meta, f"{work}/proj.mrcs",
                     "--pixel-size", 1.32])
    proj = read_mrc(f"{work}/proj.mrcs")
    if proj.shape != (n_img, n, n) or not np.isfinite(proj).all() \
            or not proj.std() > 0:
        raise AssertionError(f"path D project: {proj.shape}")
    write_mrc(f"{work}/classes.mrcs", np.stack([ref[c], ref[:, c],
                                                ref[:, :, c]]))
    tool("select", ["select", f"{work}/classes.mrcs", f"{work}/g.html",
                    "--thu", meta, "--keep", "0", "--keep-output",
                    f"{work}/kept.thu"])
    kept = read_thu(f"{work}/kept.thu")
    if len(kept) != n_img or kept.particle_paths != read_thu(
            meta).particle_paths:
        raise AssertionError("path D select: the kept table")
    log(f"path D subcommand seconds ({card}): " + json.dumps(
        {k: round(v, 3) for k, v in secs.items()}))
    return secs


def subtraction_controls(work, stack, truth, r_mask, readings):
    """Wrap ``Optimiser.save_subtract`` so that, before it writes the
    run's stack, it writes controls into a directory of their own and
    records each one's ``residual_ratio`` in ``readings``: ``truth`` (the
    phantom, masked as the pipeline masks its map, at the true poses,
    shifts and defocus factors, each image's projection M at the scale
    that fits that image best, the least-squares s of I - s M),
    ``truth_one_scale`` (one such scale for all images; the spread of the
    images' own scales as ``image_scale_spread``), ``map_true_poses`` (the
    pipeline's map at the truth), ``phantom_run_poses`` (the phantom at
    the one scale at the run's poses, shifts and defocus factors) and
    ``truth_before_norm`` (the truth at one scale on the images with the
    pipeline's norm correction undone; the spread of its factors as
    ``norm_factor_spread``). Returns the undo."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from thunder_tpu_torch.core.optimiser import Optimiser

    orig, orig_norm = Optimiser.save_subtract, Optimiser.norm_correction
    b, n = stack.shape[:2]
    norm = {}

    def norm_correction(self, stats=None):
        norm["fac"] = orig_norm(self, stats)
        return norm["fac"]

    def save_subtract(self):
        para, refs, par, off = self.para, self.refs, self.par, self.offsets
        imgs = self.imgs_ft_ori
        plane = lambda a: self._t(np.asarray(a, np.float32)[self.plane_index])
        self.refs = self._t(truth["vol"])[None, None].expand_as(refs).clone()
        self.solvent_flatten(True)
        ph = self.refs
        true_par = {**par, "topR": plane(truth["q"]),
                    "topT": plane(truth["tr"]), "topD": plane(truth["dfac"])}
        zero = torch.zeros_like(off)
        d = os.path.join(work, "control")

        def subtract(r, p, o):
            self.para = dataclasses.replace(para, output_directory=d)
            self.refs, self.par, self.offsets = r, p, o
            orig(self)
            sub = subtracted_stack(d, b, n)[:b].astype(np.float64)
            shutil.rmtree(d)
            return sub

        try:
            img = subtract(ph * 0, true_par, zero)    # I, re-centred
            model = img - subtract(ph, true_par, zero)  # M, unit scale
            scale = float(np.sum(img * model) / np.sum(model * model))
            each = np.sum(img * model, axis=(1, 2), keepdims=True) / np.sum(
                model * model, axis=(1, 2), keepdims=True)
            readings["truth"] = residual_ratio(img - each * model, r_mask)
            readings["truth_one_scale"] = residual_ratio(img - scale * model,
                                                         r_mask)
            readings["image_scale_spread"] = float(each.std() / each.mean())
            readings["map_true_poses"] = residual_ratio(
                subtract(refs, true_par, zero), r_mask)
            readings["phantom_run_poses"] = residual_ratio(
                subtract(ph * scale, par, off), r_mask)
            fac = norm["fac"]
            self.imgs_ft_ori = imgs / fac[..., None, None]
            img = subtract(ph * 0, true_par, zero)
            model = img - subtract(ph, true_par, zero)
            readings["truth_before_norm"] = residual_ratio(
                img - np.sum(img * model) / np.sum(model * model) * model,
                r_mask)
            readings["norm_factor_spread"] = float(fac.std() / fac.mean())
        finally:
            self.para, self.refs, self.par, self.offsets = para, refs, par, off
            self.imgs_ft_ori = imgs
        readings["phantom_scale"] = scale
        orig(self)

    Optimiser.save_subtract = save_subtract
    Optimiser.norm_correction = norm_correction

    def undo():
        Optimiser.save_subtract = orig
        Optimiser.norm_correction = orig_norm

    return undo


def check_resume_entry(first, meta, q_true, err_meta):
    """The resume's first round starts from Meta_Final.thu as written:
    its top quaternions, shifts and defocus factors on entry equal the
    table's (``load_poses``), and so does its pose error."""
    import numpy as np

    from thunder_tpu_torch.io import ThuColumns as C

    want = dict(quat=meta.values[:, C.QUAT_0:C.QUAT_3 + 1],
                trans=meta.values[:, C.TRANSLATION_X:C.TRANSLATION_Y + 1],
                defocus=meta.col(C.DEFOCUS_FACTOR))
    diff = {k: float(np.max(np.abs(first["entry"][k] - v)))
            for k, v in want.items()}
    err_in = float(np.median(pose_error_q(first["entry"]["quat"], q_true)))
    log(f"path D resume entry: largest difference from Meta_Final.thu "
        f"{json.dumps(diff)}; median pose error on entry {err_in:.4f} deg "
        f"(Meta_Final.thu {err_meta:.4f})")
    if max(diff.values()) > 1e-6 or abs(err_in - err_meta) > 1e-3:
        raise AssertionError(f"path D resume: load_poses state {diff}")


def run_cli_path(dev, card, n=160, b=N_PARTICLES):
    """Path D: the command-line entry point on the card, from files as a
    user hands them over (see the module docstring, phase 9). Returns the
    launches of the run and of the two resumes."""
    import shutil
    import tempfile

    import numpy as np

    from thunder_tpu_torch.io import ThuColumns, read_thu

    work = tempfile.mkdtemp(prefix="thunder_cli_")
    try:
        t0 = time.perf_counter()
        stack, truth = write_cli_dataset(dev, work, n, b)
        q_true = truth["q"]
        secs, _ = cli_call(["thu2star", f"{work}/particles.thu",
                            f"{work}/particles.star"])
        secs2, _ = cli_call(["star2thu", f"{work}/particles.star",
                             f"{work}/rt.thu"])
        orig, rt = (read_thu(f"{work}/{x}.thu") for x in ("particles", "rt"))
        ctf = [ThuColumns.VOLTAGE, ThuColumns.DEFOCUS_U, ThuColumns.DEFOCUS_V,
               ThuColumns.CS, ThuColumns.AMPLITUDE_CONTRAST,
               ThuColumns.GROUP_ID, ThuColumns.COORDINATE_X]
        if rt.particle_paths != orig.particle_paths or not np.allclose(
                rt.values[:, ctf], orig.values[:, ctf], rtol=1e-6, atol=1e-3):
            raise AssertionError("path D: particles.thu does not survive "
                                 "thu2star / star2thu")
        log(f"path D dataset written ({stack.shape}, "
            f"{stack.nbytes / 1e6:.1f} MB stack) and "
            f"round-tripped through thu2star / star2thu ({secs:.2f} + "
            f"{secs2:.2f} s) in {time.perf_counter() - t0:.2f} s")

        out = f"{work}/out"
        with open(f"{work}/run.json", "w") as f:
            json.dump(cli_config(work, f"{work}/rt.thu", out, n=n), f)
        per = {}
        per["cli_run"], rounds, wall, hist, peak = cli_run(
            dev, f"{work}/run.json", q_true, "path D cli run")
        meta = check_cli_files(out, [h["iter"] for h in hist],
                               orig.particle_paths, n)
        ang = pose_error_q(meta.values[:, ThuColumns.QUAT_0:
                                       ThuColumns.QUAT_3 + 1], q_true)
        # every round was global: no re-centring, so the stored shift is
        # the whole shift of the particle in its image
        shift = shift_readings(meta, truth["tr"])
        t_err = shift["err"]
        res_inv = float(np.loadtxt(f"{out}/Class_Info_Final.txt",
                                   ndmin=2)[0, 1])
        final_shell = int(res_inv * n * 1.32 + 0.5)
        log(f"path D Meta_Final.thu poses: median error "
            f"{float(np.median(ang)):.2f} deg, shift error {t_err:.3f} px "
            f"(bar {META_TRANS_MAX}; bias {shift['bias']}, bar "
            f"{META_TRANS_BIAS_MAX}; about it {shift['err_about_bias']:.3f} "
            f"px; slope {shift['slope']}, bar {META_TRANS_SLOPE}); final "
            f"FSC-0.143 shell {final_shell} ({1 / res_inv:.2f} A)")
        lo, hi = META_TRANS_SLOPE
        if not (t_err < META_TRANS_MAX
                and max(map(abs, shift["bias"])) < META_TRANS_BIAS_MAX
                and all(lo < x < hi for x in shift["slope"])):
            raise AssertionError(f"path D Meta_Final.thu: shifts {shift}")

        r_mask = 75.0 * n / 160 / 1.32
        resume = f"{work}/out_resume"
        with open(f"{work}/resume.json", "w") as f:
            json.dump(cli_config(work, f"{out}/Meta_Final.thu", resume,
                                 g_search=False, iters=1, subtract=True,
                                 n=n), f)
        controls = {}
        undo = subtraction_controls(work, stack, truth, r_mask, controls)
        try:
            per["cli_resume_subtract"], r_rounds, r_wall, _, r_peak = \
                cli_run(dev, f"{work}/resume.json", q_true,
                        "path D resume + subtraction", subtract=True)
        finally:
            undo()
        if r_rounds[0]["search_type_in"] == 0:
            raise AssertionError("path D resume: the first round was global")
        check_resume_entry(r_rounds[0], meta, q_true, float(np.median(ang)))
        r_err = r_rounds[0]["pose_err"]
        ratio, ratio_in, shape = subtraction_residual(resume, stack, r_mask)
        log(f"path D subtraction: {shape} read back with Meta_Subtract.thu; "
            f"variance inside / outside the mask radius {ratio:.4f} (input "
            f"stack {ratio_in:.4f}; bar {SUB_RESID_MAX}); controls (bar "
            f"{SUB_TRUTH_MAX} on two): truth {controls['truth']:.4f}, truth "
            f"at one scale {controls['truth_one_scale']:.4f} (the images' "
            f"scales spread {controls['image_scale_spread']:.4f}; without "
            f"the pipeline's norm correction "
            f"{controls['truth_before_norm']:.4f}, its factors spread "
            f"{controls['norm_factor_spread']:.4f}), "
            f"the map at the "
            f"true poses {controls['map_true_poses']:.4f}, the phantom at "
            f"the resume's poses {controls['phantom_run_poses']:.4f} "
            f"(phantom scale {controls['phantom_scale']:.5f}); resume pose "
            f"error {r_err:.3f} deg (bar {ROUND_ANG_MAX})")
        if not (ratio < SUB_RESID_MAX
                and controls["truth"] < SUB_TRUTH_MAX
                and controls["truth_before_norm"] < SUB_TRUTH_MAX):
            raise AssertionError(f"path D resume + subtraction: ratio "
                                 f"{ratio}, controls {controls}, pose error "
                                 f"{r_err}")

        # the same resume with the reference low-passed to the run's final
        # resolution instead of 25 A: the band of its local round
        hires = f"{work}/out_resume_hires"
        with open(f"{work}/resume_hires.json", "w") as f:
            json.dump(cli_config(work, f"{out}/Meta_Final.thu", hires,
                                 g_search=False, iters=1, subtract=True, n=n,
                                 init_res=1 / res_inv), f)
        per["cli_resume_hires"], h_rounds, h_wall, _, h_peak = cli_run(
            dev, f"{work}/resume_hires.json", q_true,
            "path D resume at the run's resolution", subtract=True)
        h_err = h_rounds[0]["pose_err"]
        h_ratio = subtraction_residual(hires, stack, r_mask)[0]
        log(f"path D resume at {1 / res_inv:.2f} A: pose error {h_err:.3f} "
            f"deg (bar {RESUME_HI_ANG_MAX}), subtraction ratio {h_ratio:.4f} "
            f"(bar {SUB_HI_MAX})")
        if not (h_err < RESUME_HI_ANG_MAX and h_ratio < SUB_HI_MAX):
            raise AssertionError(f"path D resume at the run's resolution: "
                                 f"pose error {h_err}, ratio {h_ratio}")

        tools = run_tools(dev, out, work, final_shell, card)
        log("path D readings: " + json.dumps(dict(
            card=card, run_s=wall, run_rounds_s=[r["wall"] for r in rounds],
            run_peak_gib=peak, run_pose_err=[r["pose_err"] for r in rounds],
            meta_final_pose_err=float(np.median(ang)),
            meta_final_shift_err_px=t_err, resume_subtract_s=r_wall,
            resume_rounds_s=[r["wall"] for r in r_rounds],
            resume_pose_err=r_err, resume_peak_gib=r_peak,
            subtract_residual_ratio=ratio, input_ratio=ratio_in,
            subtract_controls=controls, resume_hires_s=h_wall,
            resume_hires_pose_err=h_err, resume_hires_ratio=h_ratio,
            resume_hires_peak_gib=h_peak, tools_s=tools)))
        return per
    finally:
        shutil.rmtree(work, ignore_errors=True)


def shift_readings(meta, tr):
    """Meta_Final.thu's shifts against the true ones ``tr`` (b, 2): the
    median error (px), the mean error (bias) per axis, the median error
    about that bias, and per axis the least-squares slope of the stored
    shift on the true one (a sign or scale fault reads far from 1)."""
    import numpy as np

    from thunder_tpu_torch.io import ThuColumns

    got = meta.values[:, ThuColumns.TRANSLATION_X:
                      ThuColumns.TRANSLATION_Y + 1]
    dt = got - tr
    bias = dt.mean(axis=0)
    slope = (got * tr).sum(axis=0) / (tr * tr).sum(axis=0)
    return dict(err=float(np.median(np.hypot(dt[:, 0], dt[:, 1]))),
                bias=[float(x) for x in bias],
                err_about_bias=float(np.median(np.hypot(*(dt - bias).T))),
                slope=[float(x) for x in slope])


# ------------------------------------------ path G: ranks on the one card

def rank_run(argv):
    """``--rank-run REPORT -- ARGS``: one rank of path G. Runs
    ``thunder_tpu_torch.cli.main(ARGS)`` in this process (the launch
    variables come from the environment) with the kernels' counts set to 0
    just before and read just after, and writes them, the wall seconds and
    the peak device memory to the JSON file REPORT."""
    import torch

    from thunder_tpu_torch.cli.main import main as cli
    from thunder_tpu_torch.ops import insert, likelihood

    from thunder_tpu_torch.core.optimiser import Optimiser
    from thunder_tpu_torch.parallel import engine

    report, args = argv[0], argv[2:]
    seen = {"coords": None, "bricks": set(), "insert": set()}
    bricks, insert_fold = Optimiser._bricks, engine.insert_fold_reduce

    def bricks_seen(self, *a, **kw):
        tabs = bricks(self, *a, **kw)
        seen["coords"] = list(self.mesh.coords())
        seen["bricks"].add(tabs.shape[0])
        return tabs

    def insert_seen(*a, **kw):
        out = insert_fold(*a, **kw)
        seen["insert"].add(out[0].shape[0])
        return out

    Optimiser._bricks, engine.insert_fold_reduce = bricks_seen, insert_seen
    likelihood.LAUNCHES["scan_fused"] = 0
    insert.LAUNCHES["insert_update"] = 0
    t0 = time.perf_counter()
    cli(args)
    wall = time.perf_counter() - t0
    with open(report, "w") as f:
        json.dump(dict(wall=wall, peak_gib=torch.cuda.max_memory_allocated()
                       / 2 ** 30, coords=seen["coords"],
                       bricks=sorted(seen["bricks"]),
                       insert=sorted(seen["insert"]), launches={
                           "global_scan": likelihood.LAUNCHES["scan_fused"],
                           "insert_update":
                               insert.LAUNCHES["insert_update"]}), f)


def launch_ranks(work, label, rank_args):
    """Start one rank of ``rank_run`` for each entry of ``rank_args``
    (rank r with the cli arguments ``rank_args[r]``), all on this host,
    under torchrun's variables and a free port, kill them all as soon as one exits non-zero or MP_WALL_S passes,
    and return (wall seconds, each rank's report, each rank's output).
    This process's cached device memory is released first."""
    import gc
    import socket

    import torch

    # the ranks share the card with this process: hand back the blocks its
    # caching allocator kept from the earlier paths
    gc.collect()
    torch.cuda.empty_cache()
    log(f"path G {label}: this process holds "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB of the card "
        f"({torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB reserved) as "
        "the ranks start")
    with socket.socket() as sock:
        sock.bind(("", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    ranks = len(rank_args)
    procs, logs = [], [f"{work}/{label}_rank{r}.log" for r in range(ranks)]
    t0 = time.perf_counter()
    try:
        for r in range(ranks):
            env = dict(os.environ, MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), WORLD_SIZE=str(ranks),
                       RANK=str(r), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(ranks))
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.join(root, "chip_smoke.py"),
                     "--rank-run", f"{work}/{label}_rank{r}.json", "--",
                     *map(str, rank_args[r])],
                    env=env, cwd=root, stdout=f, stderr=subprocess.STDOUT))
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) \
                    or time.perf_counter() - t0 > MP_WALL_S:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    outs = []
    for path in logs:
        with open(path, errors="replace") as f:
            outs.append(f.read())
    codes = [p.returncode for p in procs]
    if codes != [0] * ranks:
        raise AssertionError(
            f"path G {label}: ranks exited {codes} after {wall:.1f} s (wall "
            f"limit {MP_WALL_S} s):\n" + "\n".join(
                f"--- rank {r}:\n{o[-4000:]}" for r, o in enumerate(outs)))
    reports = []
    for r in range(ranks):
        with open(f"{work}/{label}_rank{r}.json") as f:
            reports.append(json.load(f))
    return wall, reports, outs


def rank_devices(dev, ranks):
    """The backend and each rank's device that ``maybe_initialize``
    chooses for ``ranks`` ranks on this host: nccl with a card a rank,
    gloo with more ranks than cards (or on the CPU)."""
    import torch

    if dev.type != "cuda":
        return "gloo", ["cpu"] * ranks
    n_dev = torch.cuda.device_count()
    return ("nccl" if ranks <= n_dev else "gloo",
            [f"cuda:{r % n_dev}" for r in range(ranks)])


def rank_layout(ranks):
    """The (half, data) layout ``make_mesh`` gives ``ranks`` ranks: (2,
    ranks / 2) when even, (1, ranks) when odd."""
    halves = 2 if ranks % 2 == 0 else 1
    return halves, ranks // halves


def rank_calls(b, ranks):
    """Each rank's kernel calls a round: its lh halves x the 64-image
    chunks of its slice of the b / 2 slots of a half."""
    import numpy as np

    halves, n_data = rank_layout(ranks)
    sizes = [len(x) for x in np.array_split(np.arange(-(-b // 2)), n_data)]
    return [(2 // halves) * -(-sizes[r % n_data] // 64)
            for r in range(ranks)]


def check_ranks(dev, label, reports, outs, scans, inserts, rounds, logs):
    """Each rank joined the group on the backend and device
    ``rank_devices`` names at its (half, data) coordinates, built brick
    and insert tables of its own halves only (leading dimension lh) and
    launched K1 ``scans[r]`` and K2 ``inserts[r]`` times; only rank 0
    printed the history (returned); every rank's thunder.log (``logs[r]``)
    records that the ranks agreed after each of the ``rounds`` rounds."""
    ranks = len(reports)
    backend, devices = rank_devices(dev, ranks)
    halves, n_data = rank_layout(ranks)
    for r, (rep, out) in enumerate(zip(reports, outs)):
        h, d = divmod(r, n_data)
        want = (f"rank {r} of {ranks}: backend {backend}, device "
                f"{devices[r]}, mesh {{'half': {halves}, 'data': {n_data}}}"
                f", coordinates (half {h}, data {d})")
        if want not in out:
            raise AssertionError(f"path G {label} rank {r}: no '{want}'")
        if rep["coords"] != [h, d] or rep["insert"] != [2 // halves] or (
                rep["bricks"] not in ([], [2 // halves])):
            raise AssertionError(
                f"path G {label} rank {r}: coordinates {rep['coords']}, "
                f"brick tables' halves {rep['bricks']}, insert tables' "
                f"{rep['insert']} on the layout ({halves}, {n_data})")
        if rep["launches"] != {"global_scan": scans[r],
                               "insert_update": inserts[r]}:
            raise AssertionError(f"path G {label} rank {r}: launches "
                                 f"{rep['launches']}, expected K1 "
                                 f"{scans[r]}, K2 {inserts[r]}")
        with open(logs[r]) as f:
            text = f.read()
        for i in range(1, rounds + 1):
            if (f"[host {r}] [thunder.ROUND] round {i}: the {ranks} "
                    "ranks agree") not in text:
                raise AssertionError(f"path G {label} rank {r}: no state "
                                     f"check after round {i}")
    printed = [[json.loads(x) for x in o.splitlines() if x.startswith("{")]
               for o in outs]
    if [len(p) for p in printed] != [rounds] + [0] * (ranks - 1):
        raise AssertionError(f"path G {label}: history lines per rank "
                             f"{[len(p) for p in printed]}")
    return printed[0]


def rank_gaps(label, hist, ranks):
    """The largest of each round's ``rank_gaps`` over the rounds of the
    printed history ``hist`` of a ``ranks``-rank run: the maps' (refs,
    FSC) held to MP_MAP_GAP_MAX, the summed insert table's total to its
    hemisphere's data ranks x 2^-22 (its rounding bound); on (2, W/2)
    every rank held the same, even, non-zero number of gathered half maps
    to their owners' digests each round (both halves of each of its
    reconstructions), on (1, W) none."""
    halves, n_data = rank_layout(ranks)
    worst = {"refs": 0.0, "fsc": 0.0, "T": 0.0}
    for h in hist:
        got = h.get("rank_gaps")
        if got is None or any(len(got.get(k, ())) != ranks
                              for k in (*worst, "pair")):
            raise AssertionError(f"path G {label}: round {h['iter']} "
                                 f"records no gaps of {ranks} ranks: {got}")
        for k in worst:
            worst[k] = max(worst[k], max(got[k]))
        pair = got["pair"]
        if (len(set(pair)) != 1 or pair[0] % 2
                or (pair[0] > 0) != (halves == 2)):
            raise AssertionError(f"path G {label}: round {h['iter']}: the "
                                 f"ranks held {pair} gathered half maps to "
                                 f"their owners' digests on the layout "
                                 f"({halves}, {n_data})")
        worst["pair"] = worst.get("pair", 0) + pair[0]
    if (max(worst["refs"], worst["fsc"]) > MP_MAP_GAP_MAX
            or worst["T"] > n_data * 2.0 ** -22):
        raise AssertionError(f"path G {label}: the ranks' gaps {worst}")
    return worst


def reassembled_subtraction(out, b, n, ranks):
    """The ranks' Subtract_Rank_%06d.mrcs put back in the 1-rank order
    (g-major, image l of copy gi at gi b + l) through Meta_Subtract.thu's
    paths, each (rank, slice) used exactly once."""
    import re

    import numpy as np

    from thunder_tpu_torch.io import read_mrc, read_thu

    stacks = [read_mrc(f"{out}/Subtract_Rank_{r:06d}.mrcs")
              for r in range(ranks)]
    meta = read_thu(f"{out}/Meta_Subtract.thu")
    g = len(meta) // b
    if len(meta) != 4 * b or sum(len(x) for x in stacks) != 4 * b:
        raise AssertionError(f"path G subtraction: {len(meta)} rows, rank "
                             f"stacks {[x.shape for x in stacks]}")
    sub = np.empty((4 * b, n, n), np.float32)
    used = set()
    for row, path in enumerate(meta.particle_paths):
        m = re.fullmatch(r"(\d+)@Subtract_Rank_(\d+)\.mrcs", path)
        sl, rk = int(m.group(1)) - 1, int(m.group(2))
        used.add((rk, sl))
        sub[(row % g) * b + row // g] = stacks[rk][sl]
    if len(used) != 4 * b or not np.isfinite(sub).all():
        raise AssertionError(f"path G subtraction: {len(used)} distinct "
                             f"slices for {4 * b} rows")
    return sub, [len(x) for x in stacks]


def run_mp_path(dev, card, n=160, b=N_PARTICLES, ranks=MP_RANKS):
    """Path G: path D's run and a resume with subtraction as ``ranks``
    ranks on this host's cards (see the module docstring, phase 12).
    Returns the launches of both, summed over the ranks."""
    import shutil
    import tempfile

    import numpy as np

    from thunder_tpu_torch.io import ThuColumns, read_mrc, read_thu

    work = tempfile.mkdtemp(prefix="thunder_mp_")
    try:
        stack, truth = write_cli_dataset(dev, work, n, b)
        q_true = truth["q"]
        quats = lambda t: t.values[:, ThuColumns.QUAT_0:ThuColumns.QUAT_3 + 1]
        # a rank's calls a round: its halves x its 64-image chunks
        calls = rank_calls(b, ranks)
        times = lambda k: [k * c for c in calls]
        # rank 0 writes into out, the others get directories of their own
        outs_r = [f"{work}/out"] + [f"{work}/out_rank{r}"
                                    for r in range(1, ranks)]
        out = outs_r[0]
        with open(f"{work}/run.json", "w") as f:
            json.dump(cli_config(work, f"{work}/particles.thu", out, n=n), f)
        wall, reps, outs = launch_ranks(work, "run", [
            ["run", f"{work}/run.json", "-o", o] for o in outs_r])
        hist = check_ranks(dev, "cli run", reps, outs, times(CLI_ITERS),
                           times(CLI_ITERS + 1), CLI_ITERS,
                           [f"{o}/thunder.log" for o in outs_r])
        gaps = rank_gaps("cli run", hist, ranks)
        got = set(os.listdir(out))
        others = [sorted(os.listdir(o)) for o in outs_r[1:]]
        want = expected_files(range(1, CLI_ITERS + 1)) | {"thunder.log"}
        if got != want or any(x != ["thunder.log"] for x in others):
            raise AssertionError(f"path G files: rank 0 missing "
                                 f"{sorted(want - got)}, unexpected "
                                 f"{sorted(got - want)}; the other ranks "
                                 f"wrote {others}")
        errs = [float(np.median(pose_error_q(quats(read_thu(
            f"{out}/Meta_Round_{i:03d}.thu")), q_true)))
            for i in range(1, CLI_ITERS + 1)]
        shells = [h["res_shell"] for h in hist]
        meta = read_thu(f"{out}/Meta_Final.thu")
        shift = shift_readings(meta, truth["tr"])
        res_inv = float(np.loadtxt(f"{out}/Class_Info_Final.txt",
                                   ndmin=2)[0, 1])
        final_shell = int(res_inv * n * 1.32 + 0.5)
        fsc = map_fsc(dev, read_mrc(f"{out}/Reference_000_Final.mrc"),
                      truth["vol"])
        low = fsc[1:TOOL_RECON_SHELLS + 1]
        backend, devices = rank_devices(dev, ranks)
        log(f"path G cli run, {ranks} ranks (backend {backend}, devices "
            f"{devices}, layout {rank_layout(ranks)}, coordinates "
            f"{[r['coords'] for r in reps]}, brick tables' halves "
            f"{[r['bricks'] for r in reps]}): {wall:.2f} s (each rank "
            f"{[round(r['wall'], 2) for r in reps]} s in cli.main, peak "
            f"{[round(r['peak_gib'], 3) for r in reps]} GiB; {card}); "
            f"launches {[r['launches'] for r in reps]}; rounds' median pose "
            f"error {[round(e, 3) for e in errs]} deg, shells {shells}; "
            f"Meta_Final.thu shifts {json.dumps(shift)}; final shell "
            f"{final_shell}; final map against the phantom: FSC min over "
            f"shells 1 .. {TOOL_RECON_SHELLS} {low.min():.4f}, first under "
            f"0.5 at {int(np.argmax(fsc[1:] < 0.5)) + 1}; only rank 0 wrote "
            f"files; the ranks agreed after every round, their largest "
            f"relative gaps {json.dumps(gaps)} (maps' bar {MP_MAP_GAP_MAX}, "
            f"the table total's "
            f"{rank_layout(ranks)[1] * 2.0 ** -22:.3g}); rank 0's round "
            f"stages (s) {[{k: round(v, 2) for k, v in h['timing'].items()} for h in hist]}")
        lo, hi = META_TRANS_SLOPE
        if not (max(errs) < ROUND_ANG_MAX and min(shells) >= ROUND_RES_MIN
                and final_shell >= ROUND_RES_MIN and low.min() > 0.5
                and shift["err"] < META_TRANS_MAX
                and max(map(abs, shift["bias"])) < META_TRANS_BIAS_MAX
                and all(lo < x < hi for x in shift["slope"])):
            raise AssertionError(f"path G cli run: pose errors {errs}, "
                                 f"shells {shells}, final {final_shell}, "
                                 f"FSC {low}, shifts {shift}")

        resume = f"{work}/resume"
        with open(f"{work}/resume.json", "w") as f:
            json.dump(cli_config(work, f"{out}/Meta_Final.thu", resume,
                                 g_search=False, iters=1, subtract=True,
                                 n=n), f)
        r_wall, r_reps, r_outs = launch_ranks(
            work, "resume", [["run", f"{work}/resume.json"]] * ranks)
        r_gaps = rank_gaps("resume", check_ranks(
            dev, "resume + subtraction", r_reps, r_outs, times(0), times(3),
            1,
            [f"{resume}/thunder.log"] * ranks), ranks)
        r_err = float(np.median(pose_error_q(quats(read_thu(
            f"{resume}/Meta_Final.thu")), q_true)))
        sub, per_rank = reassembled_subtraction(resume, b, n, ranks)
        r_mask = 75.0 * n / 160 / 1.32
        ratio = residual_ratio(sub[:b], r_mask)
        log(f"path G resume + subtraction, {ranks} ranks: {r_wall:.2f} s "
            f"(each rank {[round(r['wall'], 2) for r in r_reps]} s, peak "
            f"{[round(r['peak_gib'], 3) for r in r_reps]} GiB; {card}); "
            f"launches {[r['launches'] for r in r_reps]}; pose error "
            f"{r_err:.3f} deg; the ranks' largest relative gaps "
            f"{json.dumps(r_gaps)}; the ranks' Subtract_Rank_*.mrcs hold "
            f"{per_rank} images, Meta_Subtract.thu's paths reassemble each "
            f"of {4 * b} once; variance inside / outside the mask radius "
            f"{ratio:.4f} (bar {SUB_RESID_MAX})")
        if not (r_err < ROUND_ANG_MAX and ratio < SUB_RESID_MAX):
            raise AssertionError(f"path G resume: pose error {r_err}, "
                                 f"subtraction ratio {ratio}")
        total = lambda rs: {k: sum(r["launches"][k] for r in rs)
                            for k in ("global_scan", "insert_update")}
        return {"mp_run": total(reps), "mp_resume_subtract": total(r_reps)}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def mp_study(dev, card, n=160, b=N_PARTICLES, ranks=MP_RANKS):
    """``--mp-study``: path G's ``cli run`` on one dataset as one rank
    twice (in this process), one rank on the STAR round trip of
    particles.thu (path D's input), and ``ranks`` ranks twice, without
    bounds; prints each run's median pose error per round and, for each
    pair of runs, the share of images whose round-1 pose is the same
    (within 1e-3 deg) and the median gap of the others: whether the rank
    count moves round 1 further than one rank's runs differ."""
    import itertools
    import shutil
    import tempfile

    import numpy as np

    from thunder_tpu_torch.io import ThuColumns, read_thu

    work = tempfile.mkdtemp(prefix="thunder_mp_study_")
    try:
        _, truth = write_cli_dataset(dev, work, n, b)
        cli_call(["thu2star", f"{work}/particles.thu",
                  f"{work}/particles.star"])
        cli_call(["star2thu", f"{work}/particles.star", f"{work}/rt.thu"])
        runs = {}
        for label, db, world in (("1 rank a", "particles", 1),
                                 ("1 rank b", "particles", 1),
                                 ("1 rank, STAR trip", "rt", 1),
                                 (f"{ranks} ranks a", "particles", ranks),
                                 (f"{ranks} ranks b", "particles", ranks)):
            tag = label.replace(" ", "_").replace(",", "")
            out, cfg = f"{work}/{tag}", f"{work}/{tag}.json"
            with open(cfg, "w") as f:
                json.dump(cli_config(work, f"{work}/{db}.thu", out, n=n), f)
            if world == 1:
                wall, _ = cli_call(["run", cfg])
            else:
                wall, _, _ = launch_ranks(work, tag, [
                    ["run", cfg, "-o", out if r == 0 else f"{out}_rank{r}"]
                    for r in range(world)])
            runs[label] = [read_thu(f"{out}/Meta_Round_{i:03d}.thu").values[
                :, ThuColumns.QUAT_0:ThuColumns.QUAT_3 + 1]
                for i in range(1, CLI_ITERS + 1)]
            errs = [float(np.median(pose_error_q(q, truth["q"])))
                    for q in runs[label]]
            log(f"mp study {label}: {wall:.2f} s; rounds' median pose error "
                f"{[round(e, 4) for e in errs]} deg ({card})")
        for x, y in itertools.combinations(runs, 2):
            gap = pose_error_q(runs[x][0], runs[y][0])
            same = gap < 1e-3
            log(f"mp study round 1, {x} / {y}: {same.mean():.4f} of the "
                f"images at the same pose; the others' median gap "
                f"{float(np.median(gap[~same])) if (~same).any() else 0:.4f}"
                f" deg")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def cli_study(dev, seeds=(0, 0, 0, 0, 14, 15, 16, 17, 18, 19), n=160,
              b=N_PARTICLES):
    """``--cli-study``: path D's ``cli run`` and its two resumes on the
    same files once per entry of ``seeds`` (the Para seed: the dataset's
    halves and the filter's draws; a repeated seed differs only by the
    kernels' atomic order), without bounds; prints each run's readings
    of the quantities path D holds to bars, then their ranges."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    import thunder_tpu_torch.config as config_mod
    from thunder_tpu_torch.io import ThuColumns, read_mrc, read_thu

    work = tempfile.mkdtemp(prefix="thunder_cli_study_")
    load = config_mod.load_para
    rows = []
    r_mask = 75.0 * n / 160 / 1.32
    try:
        stack, truth = write_cli_dataset(dev, work, n, b)
        q_true = truth["q"]

        def run(cfg, seed):
            config_mod.load_para = lambda *a, **k: dataclasses.replace(
                load(*a, **k), seed=seed)
            rounds = []
            undo = counted_rounds(q_true, rounds)
            try:
                cli_call(["run", cfg])
            finally:
                undo()
                config_mod.load_para = load
            return rounds

        for seed in seeds:
            out = f"{work}/out"
            with open(f"{work}/run.json", "w") as f:
                json.dump(cli_config(work, f"{work}/particles.thu", out,
                                     n=n), f)
            rounds = run(f"{work}/run.json", seed)
            meta = read_thu(f"{out}/Meta_Final.thu")
            ang = pose_error_q(meta.values[:, ThuColumns.QUAT_0:
                                           ThuColumns.QUAT_3 + 1], q_true)
            res_inv = float(np.loadtxt(f"{out}/Class_Info_Final.txt",
                                       ndmin=2)[0, 1])
            row = dict(seed=seed, round_pose_err=[r["pose_err"]
                                                  for r in rounds],
                       meta_pose_err=float(np.median(ang)),
                       shift=shift_readings(meta, truth["tr"]),
                       final_res_a=1 / res_inv)
            cli_call(["reconstruct", f"{out}/Meta_Final.thu",
                      f"{work}/recon.mrc", "--pixel-size", "1.32"])
            fsc = map_fsc(dev, read_mrc(f"{work}/recon.mrc"),
                          read_mrc(f"{out}/Reference_000_Final.mrc"))
            row["reconstruct_fsc_min"] = float(
                fsc[1:TOOL_RECON_SHELLS + 1].min())
            _, printed = cli_call(["postprocess", *(
                f"{out}/Reference_000_{h}_Final.mrc" for h in "AB"),
                f"{work}/post.mrc", "--fsc", f"{work}/post_fsc.txt"])
            final_shell = int(res_inv * n * 1.32 + 0.5)
            row["postprocess_shell_minus_run"] = int(printed.split(
                "(shell ")[1].split(")")[0]) - final_shell
            row["postprocess_fsc_diff"] = fsc_difference(
                f"{work}/post_fsc.txt", f"{out}/FSC_Final.txt", final_shell)
            for key, init_res in (("resume", 25.0),
                                  ("resume_hires", 1 / res_inv)):
                dst = f"{work}/{key}"
                with open(f"{work}/{key}.json", "w") as f:
                    json.dump(cli_config(
                        work, f"{out}/Meta_Final.thu", dst, g_search=False,
                        iters=1, subtract=True, n=n, init_res=init_res), f)
                r_rounds = run(f"{work}/{key}.json", seed)
                row[f"{key}_pose_err"] = r_rounds[0]["pose_err"]
                row[f"{key}_ratio"] = subtraction_residual(
                    dst, stack, r_mask)[0]
                shutil.rmtree(dst)
            shutil.rmtree(out)
            rows.append(row)
            log(f"cli study: {json.dumps(row)}")
        flat = lambda r: dict(
            meta_pose_err=r["meta_pose_err"], shift_err=r["shift"]["err"],
            shift_err_about_bias=r["shift"]["err_about_bias"],
            resume_pose_err=r["resume_pose_err"],
            resume_ratio=r["resume_ratio"],
            resume_hires_pose_err=r["resume_hires_pose_err"],
            resume_hires_ratio=r["resume_hires_ratio"],
            reconstruct_fsc_min=r["reconstruct_fsc_min"],
            postprocess_shell_minus_run=r["postprocess_shell_minus_run"],
            **{f"postprocess_fsc_diff_{k}": v
               for k, v in r["postprocess_fsc_diff"].items()},
            **{f"shift_bias_{a}": r["shift"]["bias"][i]
               for i, a in enumerate("xy")},
            **{f"shift_slope_{a}": r["shift"]["slope"][i]
               for i, a in enumerate("xy")})
        ranges = {k: [min(flat(r)[k] for r in rows),
                      max(flat(r)[k] for r in rows)] for k in flat(rows[0])}
        log(f"cli study ranges over {len(rows)} runs: {json.dumps(ranges)}")
    finally:
        config_mod.load_para = load
        shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------------ classification

def class_para(path):
    """A demo configuration as users write it (``load_para``), with the
    smoke's deviations: ``init_res`` 25 A instead of 60 (bench.py's value,
    so that the first global round resolves poses at band r = 8) and no
    per-round file output (the smoke writes no files). The initial model,
    particle and mask paths of the file are not read: the data are
    synthetic and the references are set by this script."""
    import dataclasses
    import os

    from thunder_tpu_torch.config import load_para

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), path)
    return dataclasses.replace(load_para(path), init_res=25.0,
                               save_ref_each_iter=False,
                               save_thu_each_iter=False)


def class3d_dataset(dev, n, per_class, k, noise=NOISE):
    """Path A's stack: ``per_class`` images of each of ``k`` C4-symmetric
    phantoms (``synthetic_dataset``'s generator, seeds 0 .. k-1, each with
    its own poses, shifts and CTFs), noise ``noise`` x each class's clean
    std. Each phantom and its images are scaled by one factor so that
    every class's images have the same std: the classes differ in shape,
    not in scale. Returns (phantoms (k, n, n, n), stack, true quats, true
    classes, CTF params)."""
    import numpy as np

    parts = []
    for c in range(k):
        vol, stack, q, cp = synthetic_dataset(dev, n, per_class, seed=c,
                                              noise=noise)
        a = 1.0 / stack.std()
        parts.append((vol * a, stack * a, q, cp))
    cls = np.repeat(np.arange(k), per_class).astype(np.int32)
    cp = {key: np.concatenate([x[3][key] for x in parts])
          for key in parts[0][3]}
    return (np.stack([x[0] for x in parts]),
            np.concatenate([x[1] for x in parts]),
            np.concatenate([x[2] for x in parts]), cls, cp)


def class2d_dataset(dev, n, per_class, k, noise=NOISE, seed=5):
    """Path B's stack: the smoke's 6-blob phantom (without the C4 mates, so
    that no view has an in-plane symmetry) projected at ``k`` fixed random
    views; each of the ``per_class`` images of a view is rotated in plane
    by a uniform angle, shifted by N(0, 2) px, CTF-modulated, plus noise of
    ``noise`` x the clean stack's std. Returns (views (k, n, n) clean
    class images, stack, true angles (rad), true classes, CTF params)."""
    import numpy as np
    import torch

    from thunder_tpu_torch.core import projector
    from thunder_tpu_torch.geom import quat
    from thunder_tpu_torch.ops import ctf as ctf_ops
    from thunder_tpu_torch.ops import fft as fft_ops
    from thunder_tpu_torch.ops.translate import translate_ft

    vol = synthetic_dataset(dev, n, 1, seed=seed, noise=0.0,
                            symmetric=False)[0]
    rng = np.random.default_rng(seed)
    q_view = rng.normal(size=(k, 4))
    q_view /= np.linalg.norm(q_view, axis=1, keepdims=True)
    b = k * per_class
    cls = np.repeat(np.arange(k), per_class).astype(np.int32)
    phis = rng.uniform(0, 2 * np.pi, b).astype(np.float32)
    tr = rng.normal(0, 2.0, (b, 2)).astype(np.float32)
    cp = dict(voltage=np.full(b, 300e3), defocus_u=rng.uniform(1e4, 2e4, b),
              defocus_v=rng.uniform(1e4, 2e4, b), defocus_theta=np.zeros(b),
              cs=np.zeros(b), amp_contrast=np.full(b, 0.1),
              phase_shift=np.zeros(b))
    cp = {key: v.astype(np.float32) for key, v in cp.items()}
    vf = projector.build_projectee_3d(torch.as_tensor(vol, device=dev), pf=2)
    r_view = quat.rotate3d(torch.as_tensor(q_view, dtype=torch.float32,
                                           device=dev))
    views = fft_ops.ifft2_center(projector.project_full_3d(
        vf, r_view, n, n // 2 - 1, pf=2)).real.cpu().numpy()
    f = torch.arange(n, device=dev) - n // 2
    colf = f[None, :].expand(n, n).reshape(-1).float()
    rowf = f[:, None].expand(n, n).reshape(-1).float()
    chunks = []
    for s0 in range(0, b, 64):
        sl = slice(s0, s0 + 64)
        ph = torch.as_tensor(phis[sl], device=dev)
        c, s_ = torch.cos(ph), torch.sin(ph)
        o, z = torch.ones_like(c), torch.zeros_like(c)
        r_z = torch.stack([c, -s_, z, s_, c, z, z, z, o], -1).reshape(-1, 3, 3)
        # image(k) = class image(rot2d(phi) k): R_view @ Rz(phi) in 3D
        rots = r_view[torch.as_tensor(cls[sl], device=dev).long()] @ r_z
        proj = projector.project_full_3d(vf, rots, n, n // 2 - 1, pf=2)
        c2d = ctf_ops.ctf_pixels(colf, rowf, n, 1.32, *[
            torch.as_tensor(cp[key][sl], device=dev)[:, None] for key in
            ("voltage", "defocus_u", "defocus_v", "defocus_theta", "cs",
             "amp_contrast", "phase_shift")]).reshape(-1, n, n)
        sl_ft = translate_ft(proj * c2d,
                             torch.as_tensor(tr[sl, 0], device=dev),
                             torch.as_tensor(tr[sl, 1], device=dev))
        chunks.append(fft_ops.ifft2_center(sl_ft).real.cpu().numpy())
    del vf
    stack = np.concatenate(chunks).astype(np.float32)
    stack += rng.normal(0, noise * stack.std(), stack.shape).astype(
        np.float32)
    return views.astype(np.float32), stack, phis, cls, cp


def seed_class_refs(opt, maps):
    """This script's choice, not a feature of the optimiser: after
    ``init_reference`` (identical references, the JAX package's default)
    each class's reference is set to its own map (phantom or view) low-
    passed to the initial band as ``init_reference`` low-passes a given
    model."""
    import torch

    from thunder_tpu_torch.ops.filters import low_pass_filter

    fftc, ifftc = opt._ffts()
    m = torch.as_tensor(maps, dtype=torch.float32, device=opt.device)
    low = ifftc(low_pass_filter(fftc(m), opt.ladder.r / opt.n, 3.0 / opt.n,
                                opt.dims)).real
    opt.refs = low[None].repeat(2, *(1,) * low.ndim).contiguous()


def shell_corr(a, b, dims, r):
    """Normalised correlation of two real maps over their Fourier shells
    1 .. r: Re sum F_a conj(F_b) / sqrt(sum |F_a|^2 sum |F_b|^2)."""
    import torch

    from thunder_tpu_torch.ops import fft as fft_ops

    fftc = fft_ops.fft2_center if dims == 2 else fft_ops.fft3_center
    radius = fft_ops.radius_grid_2d if dims == 2 else fft_ops.radius_grid_3d
    fa, fb = fftc(a), fftc(b)
    u = torch.round(radius(a.shape[-1], a.device))
    sel = (u >= 1) & (u <= r)
    num = (fa * torch.conj(fb)).real[sel].sum()
    den = torch.sqrt((fa.abs() ** 2)[sel].sum() * (fb.abs() ** 2)[sel].sum())
    return float(num / den)


def check_classes(opt, maps, cls_true, label, bounds, r,
                  purity_min=CLASS_PURITY_MIN):
    """Purity (share of images whose best class is their true class, at
    ``purity_min``) and class identity (each class's average map
    correlates best, over shells 1 .. r, with its own true map)."""
    import numpy as np
    import torch

    est = opt.best_class
    purity = float(np.mean(est == cls_true))
    avg = ((opt.refs[0] + opt.refs[1]) / 2).float()
    m = torch.as_tensor(maps, dtype=torch.float32, device=opt.device)
    k = avg.shape[0]
    corr = np.array([[shell_corr(avg[i], m[j], opt.dims, r) for j in range(k)]
                     for i in range(k)])
    own = np.argmax(corr, axis=1)
    ident = float(np.mean(own == np.arange(k)))
    distr = np.bincount(est, minlength=k) / len(est)
    log(f"{label}: purity {purity:.4f}; class distribution "
        f"{np.round(distr, 4).tolist()}; classes whose map "
        f"correlates best with their own true map {ident:.3f} (own "
        f"{np.round(np.diag(corr), 3).tolist()[:8]}...)")
    if bounds:
        if purity < purity_min:
            raise AssertionError(f"{label}: purity {purity} < {purity_min}")
        if ident < 1.0:
            wrong = np.nonzero(own != np.arange(k))[0].tolist()
            raise AssertionError(f"{label}: classes {wrong} correlate best "
                                 "with another map")
    return purity, ident


def class_pose_errors(opt, q_true, cls_true):
    """Median top-pose error (deg, C4 mates allowed) of each true class's
    images against their own phantom's poses."""
    import numpy as np

    ang = pose_error(opt, q_true)
    return [float(np.median(ang[cls_true == c]))
            for c in range(int(cls_true.max()) + 1)]


def angle_error_2d(opt, phis):
    """Per-image in-plane angle error (deg) of the best angle."""
    import numpy as np

    d = np.angle(np.exp(1j * (opt.best_phi - phis)))
    return np.degrees(np.abs(d))


def class3d_optimiser(dev, para=None, per_class=N_CLASS3D, seeded=True):
    """Path A's optimiser: ``para`` (default demo_3D.json, K = 4, C4) on
    ``class3d_dataset``; with ``seeded`` each class's reference starts from
    its phantom. Returns (opt, phantoms, true quats, true classes)."""
    from thunder_tpu_torch.core.optimiser import Optimiser

    para = para or class_para("configs/demo_3D.json")
    vols, stack, q_true, cls, cp = class3d_dataset(dev, para.size, per_class,
                                                   para.k)
    log(f"class 3D stack built: {stack.shape}, {para.k} C4-symmetric "
        f"phantoms x {per_class} images, noise {NOISE}")
    opt = Optimiser(para, device=dev)
    opt.set_data(stack, cp)
    opt.init_reference()
    opt.init_sigma()
    if seeded:
        seed_class_refs(opt, vols)
        # a model was given: the intensity-scale re-balance that
        # Optimiser.run makes at its start (one global scale)
        opt.correct_scale(init=True, group=False)
    opt._sync()
    return opt, vols, q_true, cls


def class2d_optimiser(dev, para=None, per_class=N_CLASS2D, seeded=True):
    """Path B's optimiser: ``para`` (default demo_2D.json, K = 30) on
    ``class2d_dataset``; with ``seeded`` each class's reference starts
    from its view. Returns (opt, views, true angles, true classes)."""
    from thunder_tpu_torch.core.optimiser import Optimiser

    para = para or class_para("configs/demo_2D.json")
    views, stack, phis, cls, cp = class2d_dataset(dev, para.size, per_class,
                                                  para.k)
    log(f"class 2D stack built: {stack.shape}, {para.k} views x "
        f"{per_class} images, noise {NOISE}")
    opt = Optimiser(para, device=dev)
    opt.set_data(stack, cp)
    opt.init_reference()
    opt.init_sigma()
    if seeded:
        seed_class_refs(opt, views)
        # a model was given: the intensity-scale re-balance that
        # Optimiser.run makes at its start (one global scale)
        opt.correct_scale(init=True, group=False)
    opt._sync()
    return opt, views, phis, cls


def expect_launches(label, launches, scan, inserts):
    """K1 launched (``scan`` True) or not, K2 exactly ``inserts`` times."""
    ok_scan = launches["global_scan"] > 0 if scan else \
        launches["global_scan"] == 0
    if not ok_scan or launches["insert_update"] != inserts:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"global_scan {'> 0' if scan else '0'} and "
                             f"insert_update {inserts}")


def k2_fused_table(dev, opt, mc, calls):
    """K2 on the global round's fused K-class table of half 0: the table
    as the fold received it against the exact f64 sum of its calls' f32
    corner rows at K2_TOL. The class offsets of that sum are computed here
    from each image's class (the filter state the insert read) and each
    sample's voxel row, and every sample's row is checked to lie in its
    image's class block; then K2 and index_add_ timed in turns on the first
    chunk's samples."""
    import torch

    from thunder_tpu_torch.ops import insert

    tab = calls[0][0]
    r_pad = tab.shape[1]
    n_vox = mc ** 3
    k = opt.para.k
    chunk = opt._chunk()
    cls_h0 = opt.par["c"][0].long()
    remapped = []
    for i, (_, idx, fr, fi, tv, frac) in enumerate(calls):
        c_img = cls_h0[i * chunk:(i + 1) * chunk]
        per = idx.shape[0] // c_img.shape[0]
        c_s = c_img.repeat_interleave(per)
        keep = idx < k * n_vox
        if not torch.equal((idx[keep].long() // n_vox), c_s[keep]):
            raise AssertionError("K2 fused rows outside their image's class "
                                 "block")
        vox = torch.where(keep, idx.long() % n_vox, torch.full_like(
            idx.long(), k * n_vox))
        idx2 = torch.where(keep, vox + c_s * n_vox, vox).to(torch.int32)
        remapped.append((tab, idx2, fr, fi, tv, frac))
    exact = exact_table(remapped, r_pad, dev)
    torch.cuda.synchronize()
    scale = float(exact.abs().max())
    abs_err = float((tab.double() - exact).abs().max())
    rel = abs_err / scale
    per_class = [float((tab[:, c * n_vox:(c + 1) * n_vox].double()
                        - exact[:, c * n_vox:(c + 1) * n_vox]).abs().max())
                 / scale for c in range(k)]
    n_samples = sum(c[1].shape[0] for c in calls)
    log(f"K2 on the global round's fused K={k} table of half 0 "
        f"({len(calls)} calls, {n_samples} samples, {k} x {n_vox} rows, "
        f"R_pad {r_pad}): max |err| {abs_err:.3e}, / max |exact| {rel:.3e} "
        "(per class "
        + " ".join(f"{x:.2e}" for x in per_class) + ")")
    if not rel < K2_TOL:
        raise AssertionError(f"K2's fused class table disagrees with the "
                             f"exact sum of its rows: {rel}")
    del exact, remapped
    launches0 = insert.LAUNCHES["insert_update"]
    _, idx, fr, fi, tv, frac = calls[0]
    work = insert.new_table(r_pad, device=dev)
    ms, lib_ms, turns = time_k2(work, idx, fr, fi, tv, frac, reps=5)
    insert.LAUNCHES["insert_update"] = launches0
    (bound, by), hit = k2_bound(idx, r_pad)
    log(f"K2 on a fused global chunk ({idx.shape[0]} samples, {hit} rows "
        f"hit): kernel {ms:.4f} ms, index_add_ {lib_ms:.4f} ms (turns "
        + "/".join(f"{x:.4f}" for x in turns)
        + f"), bound {bound:.4f} ms ({by}), share {bound / ms:.4f}")
    return dict(class3d_ms=ms, class3d_library_ms=lib_ms,
                class3d_bound_ms=bound, class3d_bound_by=by,
                class3d_max_abs_err=abs_err, class3d_rel_err=rel,
                class3d_samples=idx.shape[0],
                class3d_rows=k * n_vox)


def run_class3d(dev, k2):
    """Path A: demo_3D.json (K = 4) through one global round and two local
    rounds pinned at r = 40, each with its launch counts; K2's whole fused
    half-0 table of the global round held to the exact sum (readings into
    ``k2``). Returns the launches per round."""
    opt, vols, q_true, cls = class3d_optimiser(dev)
    n_chunks = -(-opt.s_slots // opt._chunk())
    half0 = []

    def grab(args):
        if not half0 or args[0] is half0[0][0]:
            half0.append(args)

    per = {}
    mc = opt.insert_mc()
    rec, _, per["class3d_global"], _ = drive_round(opt, "class 3D global "
                                                   "round", capture=grab)
    if not opt.insert_fused:
        raise AssertionError("class 3D global round: expected the fused "
                             "class insert (K n_vox 24 4 <= 3e9 B)")
    expect_launches("class 3D global round", per["class3d_global"], True,
                    2 * n_chunks)
    k2.update(k2_fused_table(dev, opt, mc, half0))
    half0.clear()
    for i in (1, 2):
        check_class3d(opt, vols, q_true, cls, rec, f"class 3D round {i}")
        pin_local(opt)
        rec, _, per[f"class3d_local_{i}"], _ = drive_round(
            opt, f"class 3D local round {i}")
        if opt.insert_fused:
            raise AssertionError("class 3D local round: expected the staged "
                                 "class insert (K n_vox 24 4 > 3e9 B)")
        expect_launches(f"class 3D local round {i}",
                        per[f"class3d_local_{i}"], False,
                        opt.para.k * 2 * n_chunks)
    check_class3d(opt, vols, q_true, cls, rec, "class 3D round 3")
    del opt
    return per


def check_class3d(opt, vols, q_true, cls, rec, label, bounds=True):
    import numpy as np

    errs = class_pose_errors(opt, q_true, cls)
    log(f"{label}: median pose error by class {np.round(errs, 3).tolist()} "
        f"deg; res shell {rec['res_shell']} (best class), ladder r "
        f"{rec['r']}")
    purity, _ = check_classes(opt, vols, cls, label, bounds, opt.ladder.r)
    if bounds:
        if max(errs) >= ROUND_ANG_MAX:
            raise AssertionError(f"{label}: median pose errors {errs}")
        if rec["res_shell"] < ROUND_RES_MIN:
            raise AssertionError(f"{label}: res shell {rec['res_shell']}")
    return purity


def band_shell(fsc, r_u, thres=0.143):
    """The FRC-``thres`` shell within the reconstruction band: the first
    shell in 1 .. r_u below ``thres``, less one, else r_u. (Beyond r_u the
    2D half maps hold only what the real-space grid correction spreads
    from the band, alike in both halves, so the FRC rises again there and
    the round's own crossing can read the Nyquist shell.)"""
    import numpy as np

    below = np.nonzero(np.asarray(fsc)[1:int(r_u) + 1] < thres)[0]
    return int(below[0]) if below.size else int(r_u)


def run_class2d(dev):
    """Path B: demo_2D.json (K = 30) through one global and one local
    round. Returns the launches per round."""
    import numpy as np

    from thunder_tpu_torch.core.optimiser import SEARCH_TYPE_LOCAL

    opt, views, phis, cls = class2d_optimiser(dev)
    per = {}
    for name, label in (("class2d_global", "class 2D global round"),
                        ("class2d_local", "class 2D local round")):
        if name == "class2d_local":
            opt.ladder.search_type = SEARCH_TYPE_LOCAL  # band unmoved
            opt.ladder.n_no_decrease = 0
        r_u = opt.ladder.r_u
        rec, _, per[name], _ = drive_round(opt, label)
        # K1 in the global round only; the 2D insert is index_add_ (the
        # JAX package's XLA scatter), no K2
        expect_launches(label, per[name], name == "class2d_global", 0)
        ang = angle_error_2d(opt, phis)
        med = float(np.median(ang[opt.best_class == cls]))
        shell = max(band_shell(f, r_u) for f in opt.fsc)
        log(f"{label}: median in-plane angle error {med:.3f} deg (images in "
            f"their true class), best class's FRC-0.143 shell in the band "
            f"1 .. {r_u}: {shell} (the round's own res shell "
            f"{rec['res_shell']})")
        check_classes(opt, views, cls, label, True, opt.ladder.r,
                      purity_min=CLASS2D_PURITY_MIN)
        if not med < ROUND_ANG_MAX:
            raise AssertionError(f"{label}: median angle error {med}")
        if shell < ROUND2D_RES_MIN:
            raise AssertionError(f"{label}: best class's band shell {shell} "
                                 f"< {ROUND2D_RES_MIN}")
    del opt
    return per


def class_study(dev):
    """--data-study: both classification paths started from the JAX
    package's default of identical references (``init_reference()``),
    three global rounds each, purity and resolution per round, no
    bounds."""
    import numpy as np

    opt, vols, _, cls = class3d_optimiser(dev, seeded=False)
    for i in range(3):
        rec = opt.run_iteration()
        log(f"class study 3D round {i + 1}: purity (best label map) "
            f"{best_map_purity(opt.best_class, cls, opt.para.k):.4f}, res "
            f"shell {rec['res_shell']}, distribution "
            f"{np.round(np.asarray(rec['class_distr']), 3).tolist()}")
    del opt
    opt, views, _, cls = class2d_optimiser(dev, seeded=False)
    for i in range(3):
        rec = opt.run_iteration()
        log(f"class study 2D round {i + 1}: purity (best label map) "
            f"{best_map_purity(opt.best_class, cls, opt.para.k):.4f}, res "
            f"shell {rec['res_shell']}")
    del opt


def best_map_purity(est, cls, k):
    """Purity under a label map from each estimated class to the true class
    most of its images hold (classes started identical have arbitrary
    labels)."""
    import numpy as np

    hits = 0
    for c in range(k):
        sel = est == c
        if sel.any():
            hits += np.bincount(cls[sel], minlength=k).max()
    return hits / len(cls)

# ------------------------------------------- path E: general point groups

def fold_axis(rots, fold):
    """The axis (x, y, z) of a rotation by 2 pi / ``fold`` among ``rots``
    (G, 3, 3)."""
    import numpy as np

    ang = np.arccos(np.clip((np.trace(rots, axis1=1, axis2=2) - 1) / 2,
                            -1, 1))
    r = rots[int(np.argmin(np.abs(ang - 2 * np.pi / fold)))]
    ax = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    return ax / np.linalg.norm(ax)


def sym_phantom(dev, n, rng, sym=SYM_GROUP, design=None):
    """A phantom (n, n, n) NumPy with the point group ``sym``, of
    ``design`` (default SYM_DESIGN): for each (fold, radius, sd, height)
    of "axes" a Gaussian blob on an axis of that fold at that radius (sd
    and radius as fractions of n; for I the 12 five-fold, 20 three-fold
    and 30 two-fold positions, a faceted shell whose projections turn with
    the orientation at low resolution), "blobs" Gaussian blobs (sd n/32
    .. n/20 px, height 1) at random centres within "blob_r" n of the
    centre, and "atoms" small ones (sd ATOM_SD px, height ATOM_HEIGHT:
    detail out to high shells) likewise; each centred at c and copied to
    g c under every matrix g of the port's own ``Symmetry(sym)`` (the
    identity included; copies that coincide add), c and g c in (x, y, z)
    against the (z, y, x) array as the refinement reads them. Built on
    ``dev``."""
    import numpy as np
    import torch

    from thunder_tpu_torch.geom.symmetry import Symmetry

    d = dict(SYM_DESIGN, **(design or {}))
    sy = Symmetry(sym)
    rots = sy.rot_with_identity()
    ax = torch.arange(n, dtype=torch.float32, device=dev) - n // 2
    zz, yy, xx = torch.meshgrid(ax, ax, ax, indexing="ij")
    vol = torch.zeros((n, n, n), dtype=torch.float32, device=dev)
    r_b = d["blob_r"] * n
    specs = [(rng.uniform(-r_b, r_b, 3), rng.uniform(n / 32, n / 20), 1.0)
             for _ in range(d["blobs"])]
    specs += [(rng.uniform(-r_b, r_b, 3), ATOM_SD, ATOM_HEIGHT)
              for _ in range(d["atoms"])]
    specs += [(r * n * fold_axis(sy.rot, fold), sd * n, h / fold)
              for fold, r, sd, h in d["axes"]]

    # one set of distinct centres per spec: coinciding copies (a centre on
    # an axis) are counted by height / fold above
    for c, sd, height in specs:
        for cx, cy, cz in rots @ c:
            vol += height * torch.exp(-((xx - cx) ** 2 + (yy - cy) ** 2
                                        + (zz - cz) ** 2) / (2 * sd * sd))
    return vol.cpu().numpy().astype(np.float32)


def sym_average(vol, rots):
    """The mean of a real-space map (n, n, n) over its point group with
    the identity, rots (G, 3, 3) without it: mean_g vol(g x), trilinear,
    about the box centre."""
    import torch

    from thunder_tpu_torch.ops.interp import linear_gather

    n = vol.shape[-1]
    ax = torch.arange(n, dtype=torch.float32, device=vol.device) - n // 2
    zz, yy, xx = torch.meshgrid(ax, ax, ax, indexing="ij")
    xyz = torch.stack([xx, yy, zz], -1)
    acc = vol.clone()
    for rot in torch.as_tensor(rots, dtype=torch.float32, device=vol.device):
        acc += linear_gather(vol, torch.flip(xyz @ rot.T, dims=(-1,)))
    return acc / (len(rots) + 1)


def map_corr(a, b):
    """Pearson correlation of two maps (float64)."""
    import torch

    a, b = a.double().reshape(-1), b.double().reshape(-1)
    a, b = a - a.mean(), b - b.mean()
    return float(torch.dot(a, b) / torch.sqrt(torch.dot(a, a)
                                              * torch.dot(b, b)))


def sym_optimiser(dev, out_dir, n=160, b=N_PARTICLES, sym=SYM_GROUP,
                  design=None):
    """Path E's optimiser: bench.py's Para with ``sym`` (trilinear insert,
    files into ``out_dir``) on ``b`` images of ``sym_phantom(design)``
    made as in phase 5 (``project_stack``, noise NOISE). Returns (opt,
    phantom, true quats)."""
    import dataclasses

    import numpy as np

    from thunder_tpu_torch.core.optimiser import Optimiser

    rng = np.random.default_rng(SYM_SEED)
    vol = sym_phantom(dev, n, rng, sym, design)
    stack, q_true, cp = project_stack(dev, vol, b, rng, NOISE)
    opt = Optimiser(dataclasses.replace(bench_para(n), sym=sym,
                                        output_directory=out_dir), device=dev)
    log(f"path E stack built: {stack.shape}, {sym}-symmetric phantom "
        f"({json.dumps(dict(SYM_DESIGN, **(design or {})))} under "
        f"{opt.sym.n_elements + 1} matrices), noise {NOISE}")
    opt.set_data(stack, cp)
    opt.init_reference(vol=vol)
    opt.init_sigma()
    opt._sync()
    return opt, vol, q_true


class SymTimer:
    """Wraps ``engine.symmetrize_halves`` while a path runs: each call's
    seconds (synchronised) by band mc, and the first call's inputs (half
    0's folded F and T, copied, the general rotations and r_u)."""

    def __init__(self, opt):
        from thunder_tpu_torch.parallel import engine

        self.opt, self.engine = opt, engine
        self.real = engine.symmetrize_halves
        self.seconds, self.first = {}, None

    def __call__(self, f, t, exact_ops, general_rots, *, pf, r_u):
        if self.first is None:
            self.first = (f[0].clone(), t[0].clone(), general_rots, r_u)
        self.opt._sync()
        t0 = time.perf_counter()
        out = self.real(f, t, exact_ops, general_rots, pf=pf, r_u=r_u)
        self.opt._sync()
        self.seconds.setdefault(int(f.shape[-1]), []).append(
            time.perf_counter() - t0)
        return out

    def __enter__(self):
        self.engine.symmetrize_halves = self
        return self

    def __exit__(self, *exc):
        self.engine.symmetrize_halves = self.real


def check_sym_cropped(dev, first, label):
    """``symmetrize_cropped`` (band-cropped grid, brick row gathers, in
    z-slabs) against the plain full-grid ``symmetrize`` (trilinear
    ``linear_gather`` of F and of T over the whole grid) on one half's
    folded accumulators of the round, at SYM_CHECK_TOL of the peak; both
    timed. Returns the readings."""
    import torch

    from thunder_tpu_torch.core import reconstructor

    f, t, rots, r_u = first
    mc = f.shape[-1]
    sync = (torch.cuda.synchronize if dev.type == "cuda" else lambda: None)
    sync()
    t0 = time.perf_counter()
    f_c, t_c = reconstructor.symmetrize_cropped(f, t, rots, r_u, pf=2)
    sync()
    t1 = time.perf_counter()
    plain = reconstructor.symmetrize({"F": f, "T": t}, rots, r_u, pf=2)
    sync()
    t2 = time.perf_counter()
    err_f = float(torch.amax(torch.abs(f_c - plain["F"]))
                  / torch.amax(torch.abs(plain["F"])))
    err_t = float(torch.amax(torch.abs(t_c - plain["T"]))
                  / torch.amax(torch.abs(plain["T"])))
    out = dict(mc=mc, general_rotations=len(rots), err_f=err_f, err_t=err_t,
               cropped_s=t1 - t0, plain_s=t2 - t1)
    log(f"{label}: symmetrize_cropped vs plain symmetrize at mc {mc} "
        f"({len(rots)} general rotations): " + json.dumps(out))
    if not (err_f < SYM_CHECK_TOL and err_t < SYM_CHECK_TOL):
        raise AssertionError(f"{label}: symmetrize_cropped off the plain "
                             f"symmetrize: {out}")
    return out


def check_sym_round(opt, vol_t, r_u, label):
    """A path E round's maps: half 0's FSC against the phantom ``vol_t``
    held above SYM_TRUTH_FSC_MIN over shells 1 .. ROUND_RES_MIN; beside it
    the golden FSC's shell, the plain FSC of the two unmasked half maps
    and the largest value of each past the insert band ``r_u`` (the
    leakage the halves share). Returns the readings."""
    import numpy as np
    import torch

    from thunder_tpu_torch.ops import fft as fft_ops
    from thunder_tpu_torch.ops import spectrum

    half_a, half_b = (fft_ops.fft3_center(v) for v in opt.half_maps[0])
    shells = opt.n // 2
    truth = spectrum.frc_fsc(half_a, fft_ops.fft3_center(vol_t), shells,
                             3).cpu().numpy()
    plain = spectrum.frc_fsc(half_a, half_b, shells, 3).cpu().numpy()
    golden = np.asarray(opt.fsc[0])
    past = int(np.ceil(r_u)) + 1

    def past_max(f):
        return float(f[past:].max()) if past < len(f) else float("nan")

    def shell(f, thres):
        return int(spectrum.res_p(torch.as_tensor(f), thres, r_low=1))

    low = truth[1:ROUND_RES_MIN + 1]
    out = dict(r_u=float(r_u), truth_fsc_min=float(low.min()),
               truth_shell_05=shell(truth, 0.5),
               golden_shell=shell(golden, 0.143),
               unmasked_shell=shell(plain, 0.143),
               golden_max_past_band=past_max(golden),
               unmasked_max_past_band=past_max(plain))
    log(f"{label}: half-0 map against the phantom and the halves' FSCs: "
        + json.dumps(out))
    if not low.min() > SYM_TRUTH_FSC_MIN:
        raise AssertionError(f"{label}: half-0 map's FSC against the "
                             f"phantom over shells 1 .. {ROUND_RES_MIN}: "
                             f"{low}")
    return out


def run_sym_path(dev, n=160, b=N_PARTICLES):
    """Path E: refinement under the icosahedral group I (58 of its 59
    rotations general) at bench.py's shape on 256 images of an
    I-symmetric phantom (``sym_optimiser``): a global round, a local round
    pinned at r = 40, then ``run(max_iter=1)``: one more round and the
    final round (the Nyquist band, mc = 317), files in a temporary
    directory. Holds every round's launches (K1 in the global round only,
    K2 four times in every round), poses (the nearest of 60 mates),
    resolution and half-0 map against the phantom (``check_sym_round``);
    ``symmetrize_cropped`` against the plain ``symmetrize``
    on the global round's folded half 0 (mc = 165); the joined map's FSC
    against the phantom over shells 1 .. FINAL_FSC_SHELLS and its
    correlation with its own I-average. Returns the launches per round."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from thunder_tpu_torch.core.optimiser import SEARCH_TYPE_GLOBAL
    from thunder_tpu_torch.ops import fft as fft_ops
    from thunder_tpu_torch.ops import insert, likelihood, spectrum

    out_dir = tempfile.mkdtemp(prefix="thunder_smoke_sym_")
    try:
        opt, vol, q_true = sym_optimiser(dev, out_dir, n, b)
        vol_t = torch.as_tensor(vol, device=dev)
        per, readings = {}, {}
        bands = {opt.insert_mc(), opt.insert_mc(opt.max_r)}
        with SymTimer(opt) as sym_t:
            r_u = opt.ladder.r_u
            rec, wall, per["sym_path_global"], _ = drive_round(
                opt, "path E global round")
            expect_launches("path E global round", per["sym_path_global"],
                            True, 4)
            check_poses(opt, q_true, rec, "path E global round", True,
                        SYM_GROUP)
            readings["global_maps"] = check_sym_round(
                opt, vol_t, r_u, "path E global round")
            readings["global_s"] = wall
            readings["cropped_vs_plain"] = check_sym_cropped(
                dev, sym_t.first, "path E global round")
            sym_t.first = None
            pin_local(opt)
            bands.add(opt.insert_mc())
            r_u = opt.ladder.r_u
            rec, wall, per["sym_path_local"], _ = drive_round(
                opt, "path E local round")
            expect_launches("path E local round", per["sym_path_local"],
                            False, 4)
            check_poses(opt, q_true, rec, "path E local round", True,
                        SYM_GROUP)
            readings["local_maps"] = check_sym_round(
                opt, vol_t, r_u, "path E local round")
            check_local_state(opt, "path E local round")
            readings["local_s"] = wall

            final = {}
            finalise = opt.finalise

            def counted_finalise():
                opt._sync()
                final["maps"] = check_sym_round(opt, vol_t, r_u,
                                                "path E run round")
                final["round"] = {
                    "global_scan": likelihood.LAUNCHES["scan_fused"],
                    "insert_update": insert.LAUNCHES["insert_update"]}
                likelihood.LAUNCHES["scan_fused"] = 0
                insert.LAUNCHES["insert_update"] = 0
                t0 = time.perf_counter()
                finalise()
                opt._sync()
                final["wall"] = time.perf_counter() - t0

            opt.finalise = counted_finalise
            r_u = opt.ladder.r_u
            likelihood.LAUNCHES["scan_fused"] = 0
            insert.LAUNCHES["insert_update"] = 0
            t0 = time.perf_counter()
            opt.run(max_iter=1)
            readings["run_s"] = time.perf_counter() - t0
            per["sym_path_run_round"] = final["round"]
            per["sym_path_final"] = {
                "global_scan": likelihood.LAUNCHES["scan_fused"],
                "insert_update": insert.LAUNCHES["insert_update"]}
        rec = opt.history[-1]
        log(f"path E run round: search type {rec['search_type']}, ladder r "
            f"{rec['r']}, res shell {rec['res_shell']}, launches "
            f"{per['sym_path_run_round']}; final round {final['wall']:.2f} s,"
            f" launches {per['sym_path_final']}; stage seconds "
            + json.dumps({k: round(v, 4) for k, v in opt.final_timing.items()}))
        expect_launches("path E run round", per["sym_path_run_round"],
                        rec["search_type"] == SEARCH_TYPE_GLOBAL, 4)
        check_poses(opt, q_true, rec, "path E run round", True, SYM_GROUP)
        expect_launches("path E final round", per["sym_path_final"], False, 4)
        check_maps(opt, opt.n)
        readings["run_maps"] = final["maps"]
        readings["final_maps"] = check_sym_round(opt, vol_t, opt.max_r,
                                                 "path E final round")
        joined = opt.joined_maps[0]
        fsc = spectrum.frc_fsc(fft_ops.fft3_center(joined),
                               fft_ops.fft3_center(vol_t), opt.n // 2,
                               3).cpu().numpy()
        res = spectrum.res_p(torch.as_tensor(opt.fsc[0]), 0.143, r_low=1)
        low = fsc[1:FINAL_FSC_SHELLS + 1]
        corr = map_corr(joined, sym_average(joined, opt.sym.rot))
        readings.update(
            final_s=final["wall"], final_stage_s=opt.final_timing,
            symmetrize_halves_s_by_mc={str(k): v for k, v in
                                       sym_t.seconds.items()},
            joined_fsc_min=float(low.min()), final_res_shell=int(res),
            joined_self_average_corr=corr,
            final_mc=opt.insert_mc(opt.max_r))
        log("path E readings: " + json.dumps(readings))
        log(f"path E joined map against the phantom: FSC min over shells 1 "
            f".. {FINAL_FSC_SHELLS} {low.min():.4f} (first shell under 0.5: "
            f"{int(np.argmax(fsc[1:] < 0.5)) + 1}); final FSC-0.143 shell "
            f"{res}; correlation with its own {SYM_GROUP}-average {corr:.6f}")
        if not (np.isfinite(joined.cpu().numpy()).all() and low.min() > 0.5):
            raise AssertionError("path E: joined map's FSC against the "
                                 f"phantom {low}")
        if res < ROUND_RES_MIN:
            raise AssertionError(f"path E: final FSC shell {res} < "
                                 f"{ROUND_RES_MIN}")
        if not corr > SYM_AVG_CORR_MIN:
            raise AssertionError(f"path E: joined map's correlation with "
                                 f"its {SYM_GROUP}-average {corr}")
        if not bands <= set(sym_t.seconds):
            raise AssertionError(f"path E: bands {sorted(bands)} not all "
                                 f"symmetrised: {sorted(sym_t.seconds)}")
        del opt
        return per
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def sym_study(dev, designs=SYM_STUDY_DESIGNS):
    """--sym-study: path E's global round and a local round pinned at
    r = 40 on each phantom design of ``designs`` (``sym_phantom``), no
    bounds: the median pose error (nearest of the group's mates) and the
    resolution shell of each round. It shows which designs carry the
    orientation at the global round's band (r = 8)."""
    import shutil
    import tempfile

    import numpy as np

    out = []
    for design in designs:
        out_dir = tempfile.mkdtemp(prefix="thunder_smoke_sym_")
        try:
            opt, _, q_true = sym_optimiser(dev, out_dir, design=design)
            row = {"design": design}
            for label in ("global", "local"):
                if label == "local":
                    pin_local(opt)
                rec, wall, _, _ = drive_round(opt, f"sym study {label}")
                ang = pose_error(opt, q_true, SYM_GROUP)
                row[label] = dict(median_deg=float(np.median(ang)),
                                  under5=float(np.mean(ang < 5)),
                                  shell=rec["res_shell"], s=wall)
            log("sym study: " + json.dumps(row))
            out.append(row)
            del opt
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
    return out


# ------------------------------------------------ path F: the MKB insert

class MkbExact:
    """Wraps ``engine.add_rows`` (the MKB insert's row adds) while a round
    runs: half 0's table (the first table added to) is kept, and every
    row set added to it is also added in float64 to a table of its own
    shape: the exact sum of the same f32 rows."""

    def __init__(self):
        from thunder_tpu_torch.parallel import engine

        self.engine = engine
        self.real = engine.add_rows
        self.tab = self.t64 = None
        self.calls = 0

    def __call__(self, tab, idx, rows):
        self.real(tab, idx, rows)
        if self.tab is None:
            import torch

            self.tab = tab
            self.t64 = torch.zeros(tab.shape, dtype=torch.float64,
                                   device=tab.device)
        if tab is self.tab:
            self.t64.index_add_(0, idx, rows.double())
            self.calls += 1

    def __enter__(self):
        self.engine.add_rows = self
        return self

    def __exit__(self, *exc):
        self.engine.add_rows = self.real

    def check(self, label):
        """Half 0's table, the rows the fold reads (the last row, out of
        band, is dropped), against the float64 sum at MKB_TOL of its
        peak."""
        import torch

        mc = round((self.tab.shape[0] - 1) ** (1 / 3))
        a, b = self.tab[:-1], self.t64[:-1]
        err = float(torch.amax(torch.abs(a.double() - b))
                    / torch.amax(torch.abs(b)))
        out = dict(mc=mc, rows=int(a.shape[0]), row_sets=self.calls,
                   max_rel_err=err)
        log(f"{label}: MKB half-0 table against its exact f64 sum: "
            + json.dumps(out))
        self.tab = self.t64 = None
        if not err < MKB_TOL:
            raise AssertionError(f"{label}: MKB table off its exact sum "
                                 f"{out}")
        return out


def mkb_grid_f64(coords, fv, tv, mc, a, alpha, step=1 << 20):
    """The MKB gridding of N samples done anew in float64, voxel by voxel:
    each sample at centered coords u (..., 3) (z, y, x; padded voxels)
    adds I0(alpha sqrt(1 - (r/a)^2)) / I0(alpha) x (Re fv, Im fv, tv) to
    each voxel v of [floor(u) - 1, floor(u) + 2]^3 at distance r = |u - v|
    <= a, except where v's 2^3 block of the support (start floor(u) - 1
    + {0, 2} per axis) does not lie inside the (mc,)^3 grid, which the
    JAX package drops. Returns (mc, mc, mc, 3) float64: Re F, Im F, T."""
    import torch

    dev = coords.device
    u = coords.reshape(-1, 3).double()
    vals = torch.stack([fv.real, fv.imag, tv], -1).reshape(-1, 3).double()
    offs = torch.stack(torch.meshgrid(*[torch.arange(4, device=dev)] * 3,
                                      indexing="ij"), -1).reshape(64, 3)
    i0_alpha = torch.special.i0(torch.tensor(alpha, dtype=torch.float64))
    out = torch.zeros((mc ** 3 + 1, 3), dtype=torch.float64, device=dev)
    for s0 in range(0, u.shape[0], step):
        us = u[s0:s0 + step, None, :]
        base = torch.floor(us) - 1
        v = base + offs                                       # (B, 64, 3)
        r = torch.sqrt(torch.sum((us - v) ** 2, -1))
        w = torch.where(
            r <= a, torch.special.i0(alpha * torch.sqrt(torch.clamp(
                1 - (r / a) ** 2, min=0.0))) / i0_alpha.to(dev),
            torch.zeros_like(r))
        start = (base + 2 * (offs // 2)).long() + mc // 2
        inside = torch.all((start >= 0) & (start <= mc - 2), -1)
        vi = v.long() + mc // 2
        idx = torch.where(inside, (vi[..., 0] * mc + vi[..., 1]) * mc
                          + vi[..., 2], torch.full_like(vi[..., 0], mc ** 3))
        out.index_add_(0, idx.reshape(-1),
                       (w[..., None] * vals[s0:s0 + step, None, :]
                        ).reshape(-1, 3))
    return out[:-1].reshape(mc, mc, mc, 3)


class MkbChunkCheck:
    """Wraps ``engine._insert_chunk_mkb`` while a K = 1 round runs and
    checks its first call (half 0's first chunk, into a table still all
    zero): the
    table it leaves, folded to voxels without the Hermitian mirror
    (``brick.fold_insert3``), against ``mkb_grid_f64`` of the chunk's own
    sample coordinates and values (read from ``brick.mkb_base`` and
    ``brick.insert_rows``) at MKB_F64_TOL of the peak."""

    def __init__(self):
        from thunder_tpu_torch.ops import brick
        from thunder_tpu_torch.parallel import engine

        self.brick, self.engine = brick, engine
        self.real = engine._insert_chunk_mkb
        self.out = None

    def __call__(self, tab, *args, **kw):
        if self.out is not None:
            return self.real(tab, *args, **kw)
        import torch

        seen = {}
        base, rows = self.brick.mkb_base, self.brick.insert_rows

        def mkb_base(coords, mc):
            seen.setdefault("coords", coords)
            return base(coords, mc)

        def insert_rows(w_c, fv, tv):
            seen.setdefault("vals", (fv, tv))
            return rows(w_c, fv, tv)

        if kw["k_classes"] != 1 or float(torch.count_nonzero(tab)):
            raise AssertionError("MKB chunk check: one class and an empty "
                                 "table are expected")
        self.brick.mkb_base, self.brick.insert_rows = mkb_base, insert_rows
        try:
            o_img = self.real(tab, *args, **kw)
        finally:
            self.brick.mkb_base, self.brick.insert_rows = base, rows
        sync = (torch.cuda.synchronize if tab.is_cuda else lambda: None)
        sync()
        t0 = time.perf_counter()
        mc = kw["mc"]
        want = mkb_grid_f64(seen["coords"], *seen["vals"], mc, kw["blob_a"],
                            kw["alpha"])
        f, t = self.brick.fold_insert3(tab[:mc ** 3 + 1], hermitian=False)
        got = torch.stack([f.real, f.imag, t], -1).double()
        err = float(torch.amax(torch.abs(got - want))
                    / torch.amax(torch.abs(want)))
        sync()
        self.out = dict(mc=mc, samples=int(seen["coords"][..., 0].numel()),
                        max_rel_err=err, f64_s=time.perf_counter() - t0)
        del want, got, f, t
        return o_img

    def __enter__(self):
        self.engine._insert_chunk_mkb = self
        return self

    def __exit__(self, *exc):
        self.engine._insert_chunk_mkb = self.real

    def check(self, label):
        log(f"{label}: first MKB chunk against the blob gridded anew in "
            f"float64: " + json.dumps(self.out))
        if self.out is None:
            raise AssertionError(f"{label}: no MKB chunk was inserted")
        if not self.out["max_rel_err"] < MKB_F64_TOL:
            raise AssertionError(f"{label}: MKB chunk off its float64 "
                                 f"gridding {self.out}")
        return self.out


def timed_insert(opt):
    """``Optimiser.reconstruct`` at the ladder's band with
    ``engine.insert_fold_reduce`` timed (synchronised): (its seconds, the
    reference maps)."""
    from thunder_tpu_torch.parallel import engine

    real, secs = engine.insert_fold_reduce, []

    def timed(*args, **kw):
        opt._sync()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        opt._sync()
        secs.append(time.perf_counter() - t0)
        return out

    engine.insert_fold_reduce = timed
    try:
        opt.reconstruct()
    finally:
        engine.insert_fold_reduce = real
    return sum(secs), opt.refs


def mkb_vs_trilinear(opt, label):
    """From the optimiser's present state, one reconstruction with the MKB
    insert and one with the trilinear insert, on the same insert draws;
    the state is restored after each. Holds their correlation above
    MKB_TRI_CORR_MIN (the JAX package's bar). Returns the readings."""
    import dataclasses

    para = opt.para
    saved = {k: getattr(opt, k, None) for k in (
        "refs", "fsc", "_w_warm", "insert_offsets", "half_maps",
        "reco_timing")}
    gen = opt.draws.gen.get_state()
    maps, secs = {}, {}
    try:
        for mkb in (True, False):
            opt.draws.gen.set_state(gen)
            for k, v in saved.items():
                setattr(opt, k, v)
            opt.para = dataclasses.replace(para, mkb_kernel=mkb)
            secs[mkb], maps[mkb] = timed_insert(opt)
    finally:
        opt.para = para
        opt.draws.gen.set_state(gen)
        for k, v in saved.items():
            setattr(opt, k, v)
    corr = map_corr(maps[True], maps[False])
    out = dict(mc=opt.insert_mc(), corr=corr, mkb_insert_s=secs[True],
               trilinear_insert_s=secs[False])
    log(f"{label}: MKB vs trilinear reference from one state: "
        + json.dumps(out))
    if not corr > MKB_TRI_CORR_MIN:
        raise AssertionError(f"{label}: MKB reference's correlation with "
                             f"the trilinear one {corr}")
    return out


def run_mkb_path(dev, n=160, b=N_PARTICLES):
    """Path F: the K = 1 refinement data of phase 5 with ``mkb_kernel``:
    a global round and a local round pinned at r = 40, each held to K1
    (global round only) and to K2 launched 0 times (the MKB insert adds
    rows with ``index_add_``, as the JAX package's XLA scatter), to the
    pose and resolution bars, and half 0's MKB table against the exact f64
    sum of its rows, and its first chunk against the blob gridded anew in
    float64 (``MkbChunkCheck``); between them the MKB and trilinear
    references from the post-global state; after them the MKB insert
    timed at the local band. Returns the launches per round."""
    import dataclasses

    opt, q_true = make_optimiser(
        dev, n, b, para=dataclasses.replace(bench_para(n), mkb_kernel=True))
    if opt._insert_kernel() != "mkb":
        raise AssertionError("path F: the optimiser does not insert with "
                             "the MKB kernel")
    per, readings = {}, {}
    for i, label in enumerate(("global", "local")):
        if i:
            pin_local(opt)
        with MkbExact() as exact, MkbChunkCheck() as chunk:
            rec, wall, per[f"mkb_path_{label}"], _ = drive_round(
                opt, f"path F {label} round")
        readings[f"{label}_s"] = wall
        expect_launches(f"path F {label} round", per[f"mkb_path_{label}"],
                        not i, 0)
        check_poses(opt, q_true, rec, f"path F {label} round", True)
        check_maps(opt, opt.n)
        readings[f"{label}_exact"] = exact.check(f"path F {label} round")
        readings[f"{label}_chunk_f64"] = chunk.check(f"path F {label} round")
        if not i:
            readings["mkb_vs_trilinear"] = mkb_vs_trilinear(
                opt, "path F after the global round")
    readings["local_band_mkb_insert_s"], _ = timed_insert(opt)
    readings["local_band_mc"] = opt.insert_mc()
    log("path F readings: " + json.dumps(readings))
    del opt
    return per


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import thunder_tpu_torch  # noqa: F401  (fails outside the repository)
    from thunder_tpu_torch import cuda_build

    if "--rank-run" in argv:
        rank_run(argv[argv.index("--rank-run") + 1:])
        return 0

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = cuda_build.build(verbose=True)
    cuda_build.library()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s ({lib.name}, "
        f"nvcc {cuda_build.build_seconds})")
    sass = sass_counts(lib)
    if sass is None:
        log("SASS of the global-scan kernel: not available (no cuobjdump)")
    else:
        log(f"SASS: global-scan tensor-core instructions "
            f"{sass['global_scan']} (HGMMA = wgmma, HMMA = mma.sync); "
            f"insert atomics {sass['insert_atomics']}")
    if "--cli" in argv:
        log(f"path D launches: {json.dumps(run_cli_path(dev, card))}")
        return 0
    if "--cli-study" in argv:
        cli_study(dev)
        return 0
    if "--mp-study" in argv:
        mp_study(dev, card)
        return 0
    if "--mp" in argv:
        ranks = (int(argv[argv.index("--ranks") + 1]) if "--ranks" in argv
                 else MP_RANKS)
        log(f"path G launches: "
            f"{json.dumps(run_mp_path(dev, card, ranks=ranks))}")
        return 0
    if "--sym" in argv:
        log(f"path E launches: {json.dumps(run_sym_path(dev))}")
        return 0
    if "--sym-study" in argv:
        sym_study(dev)
        return 0
    if "--mkb" in argv:
        log(f"path F launches: {json.dumps(run_mkb_path(dev))}")
        return 0
    k1 = check_k1(dev)
    k1_cls = check_k1_classes(dev)
    # the global round's insert call: 64 images x 100 draws x 2048 ring
    # pixels into the mc = 165 accumulator (r_u 34 -> table band 40)
    k2 = check_k2(dev, 64 * 100 * 2048, 165)
    launches = {"global_scan": None, "insert_update": None}
    per_path = {}
    if "--kernels" not in argv:
        opt, q_true, per_path["global_round"], call = run_round(dev)
        k2.update(k2_main_path(dev, call))
        del call
        local, peak = run_local_rounds(
            opt, q_true, on_half0=lambda c: k2.update(k2_local_table(dev, c)))
        per_path["local_round_1"], per_path["local_round_2"] = local
        log(f"peak device memory of a pinned local round (the second, no "
            f"capture): {peak:.3f} GiB")
        walls, med = time_local_rounds(opt)
        k2.update(local_round_walls_s=walls, local_round_median_s=med,
                  local_round_peak_gib=peak)
        del opt
        per_path.update(run_class3d(dev, k2))
        per_path.update(run_class2d(dev))
        per_path.update(run_ctf_path(dev, k2))
        per_path.update(run_cli_path(dev, card))
        per_path.update(run_mp_path(dev, card))
        per_path.update(run_sym_path(dev))
        per_path.update(run_mkb_path(dev))
        launches = {name: sum(p[name] for p in per_path.values())
                    for name in ("global_scan", "insert_update")}
    if "--data-study" in argv:
        for noise, symmetric in ((1.0, False), (1.0, True), (NOISE, False)):
            log(f"data study: noise {noise}, symmetric phantom {symmetric}")
            opt, q_true, _, _ = run_round(dev, noise=noise,
                                          symmetric=symmetric, bounds=False)
            if (noise, symmetric) == (1.0, False):  # bench.py's own data
                run_local_rounds(opt, q_true, bounds=False,
                                 label="data study: pinned local round")
            del opt
        ctf_study(dev)
        class_study(dev)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    k1_class_keys = {f"{label}_{key}": v for label, d in k1_cls.items()
                     for key, v in d.items()}
    paths = lambda name: {k: v[name] for k, v in per_path.items()}
    kernels = [
        dict(name="global_scan", route="cuda",
             source="thunder_tpu_torch/csrc/global_scan.cu",
             replaces="thunder_tpu/ops/pallas_likelihood.py:42",
             launches=launches["global_scan"],
             launches_per_path=paths("global_scan"),
             **{k: k1[k] for k in keys + (
                 "device_ms", "ms_b1024", "device_ms_b1024",
                 "library_ms_b1024", "bound_ms_b1024")},
             **k1_class_keys,
             tensor_core_sass=None if sass is None else sass["global_scan"]),
        dict(name="insert_update", route="cuda",
             source="thunder_tpu_torch/csrc/insert.cu",
             replaces="thunder_tpu/ops/pallas_insert.py:59",
             launches=launches["insert_update"],
             launches_per_path=paths("insert_update"),
             **{k: k2[k] for k in keys + tuple(
                 x for x in k2 if x.startswith(("main_path_", "local_round_",
                                                "class3d_", "final_band_")))}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)  # as nvidia-smi gives it, own line
    if "--kernels" in argv:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
