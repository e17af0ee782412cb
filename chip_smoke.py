#!/usr/bin/env python3
"""Smoke test of grid_tpu_torch, the PyTorch/CUDA port, on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero
before the last line):

1. device  — requires CUDA; prints the card's name and power limit.
2. build   — compiles the CUDA kernels (nvcc, sm_90a, one process per
             source) and the host library of the bed.gz reader and text
             writers (g++), all started together, into
             build/grid_tpu_torch/; prints the host library's path, build
             time and compiler, whether the machine has zlib's headers and
             libdeflate, and fails unless the port takes the native host
             route; prints ptxas' registers and spills and the launch shapes
             of the Gram and dipCN kernels and the column-statistics grid,
             and JIT-compiles the Triton kernels. The FP64 Gram's launch in
             its three modes at the step's shapes (the N=2504 triangle, the
             N=65,536 split and a 512-row panel: its mma shape, tiles and
             waves, stages, shared memory, registers) is held to
             ``tests/torch_plans.py``'s plan and fails on any spill.
3. kernels — each kernel against its plain PyTorch version on the card, at
             the shapes the cohort step gives it at 1000G scale (N=2504,
             R=2048) and at a ragged shape; dipCN also on forced ties, on
             all-equal distances and on a wide [64, 23170] row block; the
             column statistics must be bitwise equal on two calls; the Gram
             matrix must be exactly symmetric and within 2x the plain
             version's error against a float64 Gram. The sorted k-smallest
             selection (knn_select) must give bitwise the stable sort's
             values and positions, in the mode it picks, on the slice's d2,
             forced ties (k = 1, 20, W), all-equal distances, the wide rows,
             the ring merge's [best | d2] layout, and quantized rows at the
             widths where the cluster size and the mode change (8,192 and
             8,193 columns: one block a row and a cluster of 2; a panel's
             65,536 and the biobank's 100,000: 8; 460,000: past the widest
             row 8 blocks hold, keys in device memory), and at k = 16,384 on
             131,072 columns; its wide mode the same at the mode edges; the
             phasing sweeps
             (phase_sweeps) must agree with the plain sweeps within rtol
             1e-5 with the same NaNs, in every mode that takes the shape
             (the resident and the persistent mode; bitwise with each
             other),
             on the ring lists and random lists of 10; on 20
             bootstrap replicates, whose values decaying towards 0 keep no
             1e-5 relative accuracy in float32, its relative error against
             float64 sweeps must be at most twice the plain version's.
4. slice   — cohort_step at N=2504, R=2048, k=500, n_nbr=300, 100 phasing
             sweeps on the card; checks every kernel launched during it
             (knn_select and phase_sweeps once each) and that its outputs
             match the same call on CPU tensors (the plain route).
5. times   — CUDA-event medians of 20 runs: the slice, and each kernel
             beside its plain version (the Gram product also in TFLOP/s and
             beside torch.mm as its library call); each kernel also as 20
             back-to-back launches between two events, so the host's launch
             cost stops hiding a short kernel, with its bound (the larger of
             bytes over 3.35 TB/s and operations over the peak) and its
             share of that bound; dipCN's mode table: its resident and wide
             modes on the same 2,048 rows at widths 2,504 to 65,536 in
             float32, float64 and bfloat16, which must agree bitwise, with
             the resident mode's blocks an SM and the mode the rule picks
             (N=2504 resident in every dtype, 65,536 bf16 columns wide);
             the column statistics also at the
             genome-wide 100 x 3,000,000. knn_select beside the stable
             torch.sort (its library yardstick) and torch.topk, and its wide
             mode; CohortParams.dipcn_lists (dipCN from knn_select's lists,
             tensor code on the card): the same validity as dipcn_select's
             route, dipCN within 1e-6 relative, the step with the flag
             launching the list route once and no dipcn_select, the route
             timed beside dipcn_select; phase_sweeps
             beside the Python loop of sweeps (the wrapper's call, and the
             kernel alone by torch.profiler), its modes on lists of 2 and
             of 10 slots and on 20 bootstrap replicates, the resident
             kernel with the list walk alone and with the exchange alone,
             at 100 sweeps and at one,
             and the floor of a launch a sweep (100 empty launches back
             to back); its bound counts its inputs read once and its output
             written once.
6. profile — the slice's device time per step under torch.profiler, by
             kernel, and its share of the step time of phase 5.
7. panels  — the row-panel branch: cohort_step at N=65,536, R=1024, k=500,
             n_nbr=300, 100 sweeps with the default 2 GiB d2 budget (128
             panels of 512 rows). Checks that it launched the split, the
             panel Gram, the wide-row dipCN and the column statistics, and
             prints its peak device memory; holds each kernel against its
             plain version on the card at the panel shapes (knn_select, a
             cluster of 8 blocks a row, and its wide mode bitwise a flat
             stable sort), and the step against the
             plain route on the card (torch.mm with TF32 off, stable sorts,
             plain dipCN per panel; normalize on the CPU); times the step,
             each kernel per panel beside its plain version (the selection
             also beside the stable sort, torch.topk and its wide mode; the
             phasing's one persistent launch beside 100 empty launches and
             the Python loop), and profiles the
             step's device time by kernel: no sort may run once per panel.
8. branches — the resident and the panel branch on the same N=16,384
             cohort (the panel run with d2_budget_bytes lowered): they must
             agree, and both step times are printed.

9. pipeline — the fused WGS pipeline from files, at the full width of the 1000
             Genomes cohort: a synthetic cohort on disk in a temporary
             directory (2504 samples x 2049 bins of 1 kb, 2% of the lines
             missing, read counts, IBS neighbors; ``make_synthetic_cohort``),
             then ``run_wgs_pipeline`` on a config dict that names no
             platform (k=500, n_nbr=300, 10 haplotype neighbors, 100
             sweeps, ``device: {fused: true}``), on the native host route
             (the C++ reader and writers) with no file falling back to the
             Python reader. Checks that the call launched the column
             statistics twice and the Gram and dipCN kernels once, that the
             four artifacts and step_timings.json exist, and prints for
             every run the four spans (stage, device, phase, write),
             fused_steps_4_7 and the host's share of it.
             The fused steps quantize z to 0.01 (``quantize=True``), and two
             float32 routes to z put a cell that lies on a rounding boundary
             one quantum apart, so the card's files cannot be held to a CPU
             run's under phase 4's rule. Instead: (a) step 4 on its own terms
             against a third run with ``device.platform: cpu`` (float64):
             the same samples and NA cells, every z and scale within one
             quantum, and the cells that differ counted and bounded (at most
             1 in 500 z cells, 1 in 100 scales); (b) steps 5-7 rebuilt on
             the CPU by the plain route FROM THE CARD'S OWN written z, scales
             and dipCN: each row of the card's neighbor file, with its
             columns' distances taken from the rebuilt d2, must equal the
             rebuilt list except ties within 1e-5 of the row's k-th distance,
             its written distances must be those at %.2f, dipCN must agree
             within rtol 1e-5 on rows whose input sets agree, and the haploid
             table within one quantum of 100 plain sweeps over the card's
             dipCN. A shuffled row, a wrong column or a wrong distance fails.
             (c) card runs on the first 256 samples (a cut for the time
             limit), on the native and on the Python host route (the host
             library hidden from the port by a patch of its module
             attribute): the Python route's staged arrays must equal the
             native route's bitwise, and its four artifacts the native
             run's after decompression where the card step is bitwise
             repeatable (card runs 1 and 2 agree);
             where it is not, the native run's outputs rewritten by the
             Python writers must equal its native files instead. (d) a card
             run of the row-panel branch (d2_budget_bytes lowered below the
             [N, N] float32 matrix by a patch of the fused step's
             CohortParams): launches 2 column statistics, 1 split, 5 panel
             Grams and 5 dipCN calls; its step 4 file must equal the
             resident run's, and its neighbor and dipCN files the resident
             run's under the tie rule (distances from the rebuilt d2).

10. files — the pipeline in file mode on phase 9's cohort: ``run_wgs_pipeline``
             on the repo's default config (``device.fused`` unset, no platform
             named, defaults applied), native host route, with a console that
             keeps every line. Steps 4-7 run one after another on the card,
             each reading the previous step's file. Fails on any line logged
             at danger or warning, on a bed.gz file that falls back, unless
             step_timings.json holds the four steps and no fused step, and
             unless the call launched the column statistics twice, the split
             once, the panel Gram once per 512 rows (5), the resident Gram and
             dipCN kernels never. Step 4's file must equal the fused card run's
             after decompression or differ in counted cells one quantum apart
             (reported); steps 5-7 are held to the plain route rebuilt from
             this run's own files, as in phase 9, and steps 5-6 to the fused
             run's files under the tie rule (a row's tolerance grows by twice
             the most its distances moved between the two runs' z; dipCN on
             rows whose input sets and scales agree). A second call, with
             ``exact_phasing`` and 20 bootstrap replicates and ``resume: true``
             (steps 4-6 skipped, no kernel launched), writes both haploid
             files; its rows are finite where the Jacobi run's are. Prints each
             step's seconds, each span, the reference's Python readers' share
             and the host share beside the fused run's.

11. multilocus — the multi-locus sweep from files on phase 9's cohort:
             one counts file for each of the 492 distinct genes of the
             bundled VNTR catalog (the cohort's counts times a per-locus
             factor in [0.5, 1.5]; half the loci lack the same 2% of the
             samples, so the loci fall in two usability groups; 3 pairs of
             genes share their first GENE member and so one artifact name,
             as in grid_tpu), then ``steps.multilocus.run_multi_locus`` over
             all 492 in file mode with no platform named and step 7 off.
             Fails on any logged failure and unless the call launched the
             column statistics twice, the split once, 5 panel Grams (the
             shared steps 4-5), one resident Gram and one multi-weight
             dipcn_select per group, and no binary dipcn_select. Holds the
             multi kernel on the sweep's own d2 to the plain multi form on
             the card (ok equal, rtol 1e-5), every written .GENE dipCN table
             to it at its written precision, and for 8 loci (the first, the
             last, 6 drawn from the seed) to the binary kernel per locus and
             to the float64 plain route on the CPU from the run's own
             normalized file under the tie rule (rows whose input sets
             differ counted and left out). A second call takes 3 loci with
             step 7 on and resume (steps 4-5 skipped): their dipCN tables
             must stay bitwise as they were, a haploid table is written for
             each. The batched step again on the panel branch
             (D2_BUDGET_BYTES one byte short of N^2*4; 2 splits, 10 panel
             Grams, 10 multi launches) must agree with the resident run
             under the tie rule. Times the multi kernel at N=2504 for L = 1,
             32 and 492 (device and back-to-back time, bound and share, the
             plain form, and torch.mm of the [N, N] float32 take mask by W
             with TF32 off as the sum part alone). Then, at N=65,536 on
             phase 7's prepared z with 492 seeded loci and 2% unusable
             columns, the sweep's panel route (1 split, 128 Gram panels, 128
             wide-mode multi launches) against the binary wide panel route
             for loci 0, 246 and 491: its time, time per panel, the kernel
             alone per panel and the peak memory above the inputs, which
             must stay O(512 N + N L).

12. alignments — host steps 1-3 from BAM/CRAM in front of steps 4-7
             (``alignment_phase``). (a) A 1000 Genomes-shaped BAM cohort
             from the port's ``make_synthetic_cohort_with_alignments`` in the
             shape of scripts/bench_e2e_1000g.py (N=128, a cut of its 2504
             for the time limit, seed 9, mean_depth
             4.0, 100 bp reads, the window chr6:160,605,000-160,615,000 and
             10 flank bins of 1 kb each side; ~3,000 reads a sample), its
             fabrication timed apart (it stands in for the download); k=500,
             n_nbr=300, ``threads`` = the machine's cores, no platform named.
             Run 1 creates the .bai files (``index.run: true``, steps 2-7
             off); run 2 is the whole ``wgs`` with the index check and
             ``device: {fused: true}``: the one-pass ingest (batch route)
             feeds the fused step on the card (launches 2 / 1 / 1); run 3 the
             same in file mode (2 column statistics, 1 split, 2 panel Grams);
             run 4 the sequential steps 2-3 (``fused_ingest: false``, steps
             4-7 off) on the first ALIGN_SEQ_N samples (their step 3 parses
             each genome-wide bed.gz in Python: the whole cohort would not
             fit the time limit). Fails unless: the counts and coverage TSVs
             of runs 2 and 3 are byte-identical and equal run 4's on its
             samples (rows compared sorted: they come in completion order),
             run 4's bed.gz files equal run 2's after decompression, the
             staged bins handed to step 4 equal the bed.gz files read back
             (per sample, and as the staged matrix) bitwise, steps 4-7 from
             run 2's written files with steps 1-3 off equal run 2's
             artifacts (or, where not bitwise, under phase 9's rules), the
             read counts correlate with the fabricated dip_cn x base_depth
             (r >= 0.9), the host library is native, every one-pass run took
             the batch route, and nothing fell back or logged a failure.
             Prints every run's step times, spans and host share and the
             one-pass ingest alone on 1 thread and on all cores (samples/s,
             reads/s). (b) The CRAM route at N=16 (indel_frac 0.1),
             fabricated as BAM and as CRAM from one seed: counts, coverage
             and bed.gz files from the native CRAM reader, from cramlite
             (the plain version, in spawned processes) and from the BAMs
             must be equal; the native and cramlite routes are timed.
13. wes    — the exome path (``sw_kernel_phase``, ``wes_phase``). (a) The
             Smith-Waterman kernel against its plain scan on the card, int32
             equal, on tests/torch_sw_cases.py's cases
             (8,192 reads of 150 on exons of 160/182/182; Q=1 and Lq=1;
             all-pad reads and reads with N; Lr of 45 and 97; Lr=700, the
             shared-memory mode; Lq > Lr; scores (3, -2, -3) and gap 0; two
             identical references; Lr = G*S - 1, G*S, G*S + 1 at each edge
             of the lane-group chooser; Lr below G; a ragged unit count; a
             positive gap; scores past a byte; reads with codes past 4), on
             int8, uint8 and int8 reads against uint8 references; the main,
             positive-gap and codes-past-4 cases again at each G the chooser
             may take at Lr=182, in each form the scores allow (int32, and
             the packed 16x2 form where ops/gpu_align.py:packed_fits holds),
             and ACGT reads against sw_score_host; the launch shapes of every
             instance of the register mode's table in both forms, none of
             which may spill, the waves at Q = 8,192 and 32,768, and the
             instructions a cell of the wavefront loops in the library's
             SASS (cuobjdump). (b) Its times at Q = 8,192 and 32,768 at the
             chooser's shape and form (packed, G=8) and at G = 8 and 16 in
             both forms (CUDA events: median and 20 back to back, two rounds
             in turns), the plain scan's, cell updates per second and the
             bound of the form launched, at the SMs' issue limit, 4 warp
             instructions a clock, at nvidia-smi's maximum SM clock: the
             packed form's 2.25 instructions a cell (two cells a register:
             their substitutions' prmt, three 16x2 DPX max-adds and half a
             three-way max), the int32 form's 6 (the recurrence's 9 integer
             operations in Hopper's fused DPX forms), also stated for the
             packed form; and at Q = 1,024 the packed form at G = 8, 16
             and 32.
             (c) A WES-shaped cohort of 128 BAMs (a cut forced by the time
             limit) of ~8,000 reads of 150 bases in the KIV-2 window, drawn
             from the three exons at seeded per-sample proportions beside
             random background reads, an exon FASTA and 200 neighbors a
             sample; ``python -m grid_tpu_torch.cli wes`` on it in this
             process (all cores as threads, no platform named). Fails unless
             the kernel launched once per sample, the counts equal the
             fabrication's truth (every background read unclassified, every
             exon read to its label), the counts of 16 samples equal the
             plain scan's on the card byte for byte, and all three later
             artifacts are written; prints the spans, the host share and one
             sample's time by part.
14. ibs    — compute_ibs: the engine, the pipeline with a phased panel (on
             phase 9's cohort) and the alignment tools.
15. ring   — the sharded step (``grid_tpu_torch.parallel``) on W spawned
             ranks of the one card (``ring_phase``, run after phase 8; (d)
             inside phase 9). (a) ``sharded_cohort_step`` at phase 8's
             N=16,384, R=1024, k=500, n_nbr=300 over 4 ranks (gloo: the
             ranks share the card; 2 and 3 ranks run in the CPU tests
             only, for the time limit); (b) the same over 1 rank, through
             NCCL (one card has room for no second NCCL rank). Each must log
             its transport, each rank must have launched the column
             statistics twice, the split once and the Gram kernel's cross
             mode W times, and the step is held to phase 8's flat step: z and
             the column statistics within 1e-5 of their largest entry,
             region_used equal, the neighbor lists and dipCN under the tie
             rule. The cross mode at W=2 and 4 against its plain version
             (1e-5) and bitwise against zprep_gram_panel's entries for the
             same rows, and timed per [B, B] block beside torch.mm (TF32 off)
             with its bound. (c) N=65,536, R=1024 over 4 ranks: the call's
             host time, each rank's step, spans and peak device memory, and
             the lists and dipCN held to phase 7's flat step; the cross mode
             timed at B=16,384. (d) ``run_wgs_pipeline`` on phase 9's cohort
             with ``device: {fused: true, mesh_shape: [4], dispatch: ring}``:
             2 column statistics, 1 split and 4 cross launches per rank, and
             the four artifacts held to card run 1's under phase 9's rules.
             Times from W ranks on one card say nothing of scaling across
             cards.
16. last   — the last modules (``auto_phase`` after phase 15 (a-c);
             ``stage_phase`` and ``cache_phase`` inside phase 9). (a)
             ``auto_sharded_cohort_step``, the gather form, at phase 8's
             N=16,384 over 1 (NCCL) and 4 (gloo) ranks: each logs its
             transport; each rank launches the column statistics twice, the
             split once, and ceil(B/512) panel Grams and dipCN selections,
             no cross Gram; the step is held to phase 8's flat step as in
             phase 15, and its lists, distances and dipCN bitwise to the
             flat panel loop (``_panel_knn_dipcn``) run here on its own z;
             at W=4 the gathered split is bitwise ``zprep_split`` of the
             whole returned z. (b) N=65,536 over 4 ranks, held to phase 7's
             flat step: the call's host time, each rank's step, spans and
             peak memory, beside phase 15 (c)'s ring and phase 7's step.
             (c) ``stage_cohort_sharded`` over 2 ranks on phase 9's files
             equals the one-rank stage bitwise, and
             ``staged_sharded_cohort_step`` over 2 ranks is held to
             ``sharded_cohort_step`` from that stage's host arrays (indices
             equal, dipCN rtol 1e-6); each rank's passes, host buffer and
             peak RSS. (d) ``python -m grid_tpu_torch.cli wgs`` on phase 9's
             fused config with ``device.compilation_cache`` a fresh
             directory: cold (nvcc, g++ and Triton build there) and warm
             with ``GRID_TPU_PROFILE_DIR``: the libraries and Triton's
             cache in the directory, build/grid_tpu_torch/ unchanged, a trace
             per outermost step, the fused step's naming ``fused.device`` and
             the hand kernels' device events, the artifacts equal.
17. float64 — ``device.dtype: float64`` on the card (``float64_phase``
             and ``float64_slice_phase`` after phases 7-8; (d), (h) and
             (i)'s pipeline and stager inside phase 9). (f) Float64 is
             taken with ``device.mesh_shape`` and for the multi-locus sweep;
             float64 past 8,192 neighbors is refused up
             front. Then phases 3-7 run again in float64 (the
             same functions, ``kernels_phase`` and ``panel_phase``, at the
             float64 bounds of ``TOL``): (a) each float64 kernel against its
             float64 plain version on the card at N=2504 (the column
             statistics at rtol 1e-12, the FP64 Gram within 1e-12 of max|G|
             and exactly symmetric, knn_select bitwise the stable sort in
             every case of phase 3, its shared mode one block a row and
             wider rows in the wide mode, dipcn_select at rtol 1e-12, the
             sweeps at rtol 1e-12 and the bootstrap replicates at 1e-10,
             every mode bitwise) and at the panel shapes, each timed beside
             its plain version with its bound at the FP64 peaks (67 TFLOP/s
             tensor for the Gram, 34 otherwise) and its library call (DGEMM,
             stable torch.sort and torch.topk in float64), the Gram with the
             bytes its tiles read from L2 a call, estimated from the tile
             count (not measured, and printed only), and the rate they imply
             at its time (the N=2504 triangle and one panel); (b) the float64
             N=2504 step against the port's float64 CPU route: z within
             1e-12 of max|z|, neighbor lists equal but for ties within 1e-12
             of the row's k-th distance (counted), dipCN within 1e-9 where
             the input sets agree, its time and device busy share; (c) the
             float64 panel step at N=65,536 against the float64 plain route
             on the card under (b)'s rules, its launches, peak memory and
             time. (d) ``run_wgs_pipeline`` fused and in file mode with
             ``device.dtype: float64`` on phase 9's cohort, held to phase
             9's float64 CPU run: normalized byte-identical, neighbors under
             the tie rule (counted), dipCN within 1e-9 where the input sets
             agree, haploid byte-identical where none differs. (e) No card
             run of either dtype reaches a plain version (a count on each
             plain version the wrappers would take), and every kernel
             launched. (g) The float64 multi-weight dipcn_select against
             its float64 plain version (ok exact, rtol 1e-9) on the (h)
             sweep's float64 d2 at N=2504 for all 492 loci's weights (per
             usability group; three loci a group against the float64
             binary kernel at 1e-12), timed at L = 1, 32 and 492, and on 2
             panels at N=65,536 with 492 loci (its wide mode), timed, each
             beside torch.mm of the float64 take mask by W and its bound by
             bytes; the FP64 Gram's cross mode on x R=1024 blocks of phase
             7's z in float64: (i)'s ring blocks, [8192, 8192] at offsets
             (0, 8192) and a rank's own (0, 0), whose diagonal tiles the
             panel mode mirrors; the fused ring's [1252, 1252] at (0, 0)
             and (1252, 0); [4096, 4096] at (12288, 100). Each bitwise
             zprep_gram_panel's entries for the same rows (one launch: the
             FP64 products are symmetric bit for bit), within 1e-12 of its
             plain version, its launch the plan's,
             timed beside torch.mm float64 with its bound by operations
             (2*Ba*Bb*R at 67 TFLOP/s). (h) ``run_multi_locus`` with
             ``device.dtype: float64`` over 2 catalog loci, LPA among
             them, step 7 on, on phase 9's cohort with phase 11's counts:
             its launches (the multi form once per usability group, no
             plain version reached), its normalized file byte for byte
             (d)'s file mode's, its dipCN and haploid tables held to the
             port's float64 CPU sweep on the same loci from that file (ties
             within 1e-12 counted, dipCN at 1e-9 where the input sets
             agree, haploid byte-identical where none differs). (i) The
             ring and the gather form in float64 over 2 gloo ranks at
             phase 8's N=16,384, R=1024, each held to the flat
             float64 step on the card (z at 1e-12 of max|z|, lists under
             the tie rule at 1e-12, dipCN at 1e-9); ``run_wgs_pipeline``
             fused with ``mesh_shape: [2], dispatch: ring`` in float64 on
             phase 9's files, held to phase 9's float64 CPU run as (d);
             ``staged_sharded_cohort_step`` in float64 over 2 ranks on
             phase 9's files (the sharded stager's float64 buffers), held
             to the flat float64 step from the stage its ranks made; every
             rank's launches checked.
18. bfloat16 — ``device.dtype: bfloat16`` on the card (``bfloat16_phase``
             after phase 17 (g, i); (c) and (f) inside phase 9). bfloat16
             is taken without ``device.mesh_shape`` and with it, in both
             forms (steps 4-6 in bf16, the reads and the steps grid_tpu
             runs without a dtype in float32). (a) Phases 3-6 in bf16 at N=2504
             (``kernels_phase``): the bf16 forms of the column statistics
             (Triton) within one bf16 ulp of their plain versions, the Gram
             (csrc/zprep_gram16.cu) within one ulp of each entry or 2^-16 of
             max|G| (its split pass's norms within one ulp) and its panels
             bitwise the triangle's rows, its launch shape, and under the
             same rule against float32 sums on the CPU at N=2504 and on a
             panel, R=1024 and 2048 (beside torch.mm bf16 and an IEEE
             float32 product on the card, the share of G's entries apart
             from the CPU's); knn_select bitwise
             the stable sort of the int16 keys in every case of phase 3 (its
             widest bf16 row 131,072 columns), dipcn_select bitwise its plain
             version; the N=2504 step against the port's bf16 CPU route
             (z within 2^-7 of max|z|, lists under the tie rule at 2^-7 of
             the k-th distance, dipCN within rtol 2^-7 where the input sets
             agree), every kernel launched (the sweeps in float32) and no
             plain version reached; each bf16 kernel timed beside its plain
             version, its bound at 3.35 TB/s and 989 TFLOP/s (dense bf16)
             and its library call (torch.mm in bf16, the stable torch.sort
             and torch.topk); the step's device time by kernel. (b) The bf16
             panel step at N=65,536, R=1024 on phase 7's cohort (8 GiB of
             bf16 d2: the panel branch): launches, 3 panels held against the
             plain route on the card, the step timed once, each kernel at
             the panel shapes (the Gram's b2b and device time beside
             torch.mm bf16, with its launch; dipcn_select's two modes and
             the one the rule picks). (c) ``run_wgs_pipeline`` fused and in file
             mode with ``device.dtype: bfloat16`` on phase 9's cohort, each
             held to the port's bf16 CPU route of the same form under (a)'s
             rules, and ``run_multi_locus`` in bf16 over 2 loci (step 4 in
             bf16, its normalized file the file mode's; the batched dipCN
             in float32). (d) The bf16 Gram's cross mode on phase 7's z
             rounded to bf16 (R=1024) at the blocks the runs use: the
             ring's [8192] at offsets (0, 8192) and (0, 0), the fused
             ring's [1252] and a [4096] off a tile, each bitwise
             zprep_gram_panel's entries, within the bf16 Gram rule of its
             plain version, its launch the plan's, timed beside torch.mm
             bf16 with its bound at 989 TFLOP/s. (e) The ring and the
             gather form in bf16 over 2 gloo ranks at phase 8's N=16,384:
             the ring's lists held to a whole-row knn_select on the
             panel-mode Gram of its own prepared z under the tie rule at
             tol 0, its dipCN float32; the gather form held to the flat
             bf16 panel step on the card at the bf16 contract. (f)
             ``run_wgs_pipeline`` with ``mesh_shape: [2], dispatch: ring``
             in bf16 on phase 9's files against the port's CPU ring of the
             same config, and ``staged_sharded_cohort_step`` in bf16 over
             2 ranks there, bitwise the ring from the stage its ranks made.

The last three lines are the kernels' JSON object (the panel-mode numbers
at N=65,536; each entry's "slice_2504" holds phase 5's, "pipeline_2504"
the launches of phase 9's pipeline call, "pipeline_files_2504" those of
phase 10's, "multilocus_2504" those of phase 11's sweep and "alignments_128"
those of phase 12's fused call from BAMs and, under "files", its file-mode
call; the multi-weight
form's row has the sweep's launches and its times at L=492; the
Smith-Waterman row phase 13's, its launches those of the ``wes`` call; the
column statistics' and Gram rows' "ring" entries phase 15's launches per
rank and of its pipeline call, and a row of its own for the Gram kernel's
cross mode, its launches those of phase 15 (a)'s four ranks; the column
statistics', Gram and dipCN rows' "auto" entries phase 16's launches per
rank; the knn_select and phase_sweeps rows likewise, with their "ring" and
"auto" launches per rank; the five float64 forms a row each, named
"<kernel>[float64]", their launches those of phase 17 (b)'s step, with
the panel numbers under "panel_65536", phase 17 (d)'s launches and, under
"step", the float64 steps' times and tie counts; the float64 multi-weight
form's row, its launches those of phase 17 (h)'s sweep and its numbers at
L=492 on that sweep's d2, the panels' under "panels_65536"; the FP64 cross
mode's row, its launches those of phase 17 (i)'s ring at N=16,384 over 2
ranks and its numbers at that ring's visiting block, [8192, 8192], the
other blocks' under "other_blocks"; the four bf16 forms a row each, named
"<kernel>[bfloat16]", their launches those of phase 18 (a)'s step, the
panel numbers under "panel_65536", (c)'s launches and tie counts and the
sweep's launches beside them, and (e)'s and (f)'s launches per rank, the
Gram's row with the cross mode under "cross"; the bf16 cross mode's row,
its launches those of (e)'s ring over 2 ranks and its numbers at that
ring's visiting block, [8192, 8192]), the card's name and power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import ctypes
import gzip
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

N, R, K, N_NBR, N_ITERS = 2504, 2048, 500, 300, 100
RAGGED = (97, 70)
REPS = 20
PROFILE_STEPS = 5
ZMAX = 2.0
WIDE = (64, 23170)  # the widest rows the default 2 GB d2 budget admits
GENOME = (100, 3_000_000)  # the genome-wide normalize shape
PANEL_N, PANEL_R = 65536, 1024  # a biobank cohort, past the 2 GiB d2 budget
# phase 5: the widths and rows of dipcn_select's mode table (the slice's
# N, the sharded forms' 16,384 and the panels' 65,536: the widths the paths
# run; PR 22's table, recorded in PERF.md, also timed 8,192, 12,288, 23,170
# and 32,768, a cut that leaves time for phase 18 (d)-(f)), in float32,
# float64 and bfloat16
MODE_TABLE_W = (2504, 16384, 65536)
MODE_TABLE_ROWS = 2048
PANEL_REPS = 3
BRANCH_N = 16384  # both branches run: N*N*4 = 1 GiB
# knn_select: the widest row one block holds (kSliceTarget), the biobank
# width (grid_tpu's scripts/bench_biobank.py), a width past the widest row
# 8 blocks' shared memory holds at k=500, and the largest list (2^14
# entries) on rows too wide for the shared mode at that k
KNN_SLICE, BIOBANK_N, KNN_WIDE_W = 8192, 100_000, 460_000
KNN_MAX_K, KNN_MAX_K_W = 16384, 131072
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
TF32_FLOP_PER_S = 495e12  # dense TF32 tensor-core peak, the same sheet
# two float32 Gram routes may swap neighbors this close (of the row's k-th
# distance): see the slice phase
TIE_RTOL = 1e-5
# phase 9: the 1000 Genomes cohort on disk, 43 window bins + 2 x 1003 flank
# bins = 2049 bins of 1 kb, and what one pipeline call must launch
PIPELINE_N, PIPELINE_FLANK, PIPELINE_SEED = 2504, 1003, 2504
PY_HOST_N = 256  # phase 9 (c)'s samples: the Python host route, cut for the time limit
PIPELINE_LAUNCHES = {"masked_column_stats": 2, "zprep_gram": 1, "dipcn_from_distances_gpu": 1}
QUANTUM = 0.01001  # one %.2f step, with room for the last digit of a float
# phase 10: the file-mode steps, their spans, and the split's and panels'
# launches beside the three wrappers'
FILE_STEPS = ("normalize", "neighbors", "compute_diploid_genotypes", "compute_haploid_genotypes")
FILE_SPANS = ("normalize.stage", "normalize.device", "neighbors.read", "neighbors.device",
              "dipcn.read", "dipcn.stage", "dipcn.device", "haploid.phase")
FILE_DEVICE_SPANS = ("normalize.device", "neighbors.device", "dipcn.device", "haploid.phase")
BOOT_REPLICATES = 20
# phase 11: the multi-locus sweep's seed, its loci at N=65,536, the L its
# kernel is timed at, and the float32 peak outside the tensor cores
MULTI_SEED = 11
MULTI_L = 492  # the bundled catalog's distinct genes
MULTI_TIMED_L = (1, 32, MULTI_L)
FP32_FLOP_PER_S = 67e12  # NVIDIA's data sheet, H100 SXM
# phase 12: the alignment cohorts (the shape of scripts/bench_e2e_1000g.py)
# and the least correlation of read counts with the fabricated truth
# (128 samples, the CRAM route at 16, the sequential steps at 16: cuts
# of 256 and 64 that leave room in the time limit for phase 16, of 128 for
# the selection and phasing kernels' checks, of 2,504, 64 and 32 for
# phase 17, of 1,024 and 512 for phase 18, and of 128 and 16 for the
# margin a slower host needs; k is cut to N - 1 there)
ALIGN_N, ALIGN_SEED, ALIGN_DEPTH, ALIGN_CRAM_N = 128, 9, 4.0, 16
ALIGN_MIN_CORR = 0.9
# the samples the sequential steps 2-3 run on: their step 3 parses each
# genome-wide bed.gz (160,625 lines here) in Python, 0.36 s a file on the
# card's host (45.968 s for 128 files on 8 threads), so the whole cohort
# (~900 s) would not fit the time limit
ALIGN_SEQ_N = 16
# phase 13: the WES path. The kernel's bound: a cell of the recurrence is 9
# integer operations (the substitution's compare and select, three adds,
# three maxes with the zero clamp, the running best); Hopper's DPX forms do
# up + gap, the max with diag + sub and the clamp in one instruction and
# left + gap with its max in another, so 6 instructions a cell, at the SM's
# issue limit of 4 warp instructions a clock (integer work can reach it
# split between the ALU and the FMA pipe). The cohort is the KIV-2 window
# at ~30x (~8,000 reads of 150 bases a sample), 128 samples (a cut forced
# by the time limit: 256 until a slower host needed the margin), 16 of them
# again on the plain scan (64 until the selection and phasing kernels'
# checks needed the time, 32 until phase 17)
SW_OPS_PER_CELL = 6
# the packed form's least: a register holds two cells, which take the
# prmt of their substitutions from the column's profile, the 16x2 max-adds
# of up + gap (with the clamp), diag + sub and left + gap, and half a
# three-way max into the best: 4.5 instructions for two cells
SW_PACKED_OPS_PER_CELL = 4.5 / 2
SW_LANES_PER_SM = 4 * 32
SW_SEED = 10
SW_TIMED_Q = (8192, 32768)
SW_SMALL_Q = 1024  # a few reads: the chooser takes more lanes a unit
WES_N, WES_PLAIN_N, WES_READS, WES_SEED = 128, 16, 8000, 13
WES_READ_LEN = 150
WES_WINDOW = ("chr6", 160_605_062, 160_647_661)
WES_CHROM_LEN = 170_805_979
WES_NEIGHBORS = 200
WES_BREAKDOWN_N = 16
WES_MIN_SCORE = 180  # 60% of a perfect 150-base read; random reads must stay below


# phase 14: compute_ibs and the tools. The engine's shape is the JAX
# package's own engine record (2,504 samples, 20,000 sites, k=200: a cut of a
# whole chromosome); the cut the numpy engine finishes in seconds; the panel
# of scripts/bench_e2e_1000g.py (400 sites, 20 neighbors, haplotypes grouped
# by quartiles of the true haplotype CN); tests/test_ibs.py's criterion; and
# the tools' cohorts, cut from phase 12's
IBS_ENGINE = (2504, 20_000, 200)
IBS_CHECK = (512, 2_000, 20)
IBS_SEED, IBS_PANEL_SITES, IBS_K, IBS_MIN_RHO = 14, 400, 20, 0.5
TOOLS_BAM_N, TOOLS_CRAM_N = 64, 16
TOOLS_WINDOW = ("chr6", 160_605_000, 160_615_000)  # the alignment cohorts' VNTR window


# phase 17: device.dtype float64 on the card. The FP64 peaks (NVIDIA's H100
# SXM data sheet) and the float64 bounds: sums of the same terms in another
# order, bootstrap replicates decaying over 100 sweeps, and how close two
# float64 Gram routes may put two neighbors that they order differently
FP64_TENSOR_FLOP_PER_S = 67e12  # dense FP64 tensor-core peak
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak, the same sheet
BF16_RTOL, BF16_ULPS = 2.0 ** -7, 1  # tests/torch_parity.py's bf16 contract
FP64_FLOP_PER_S = 34e12  # FP64 outside the tensor cores
F64_RTOL = 1e-12
F64_BOOT_RTOL = 1e-10
F64_TIE_RTOL = 1e-12
# each dtype's bounds, which phases 3-7 and 17 hold the card to: the kernels
# against their plain versions (sums: the column statistics, elementwise;
# gram: of max|G|; dipcn; sweeps; boot: the bootstrap replicates, None for
# float32's rule against float64 sweeps), a step against another route (z
# of max|z|, ties of the row's k-th distance, dipCN where the input sets
# agree), and the peaks of the bounds (the Gram's, the other kernels')
TOL = {
    torch.float32: SimpleNamespace(
        sums=1e-5, gram=1e-5, dipcn=1e-6, sweeps=1e-5, boot=None, z=1e-5, ties=TIE_RTOL,
        step_dipcn=1e-5, gram_peak=TF32_FLOP_PER_S, peak=FP32_FLOP_PER_S),
    torch.float64: SimpleNamespace(
        sums=F64_RTOL, gram=F64_RTOL, dipcn=F64_RTOL, sweeps=F64_RTOL, boot=F64_BOOT_RTOL,
        z=F64_RTOL, ties=F64_TIE_RTOL, step_dipcn=1e-9, gram_peak=FP64_TENSOR_FLOP_PER_S,
        peak=FP64_FLOP_PER_S),
    # phase 18: the kernels against their plain versions within BF16_ULPS
    # (the column statistics and the Gram) or bitwise (dipcn: 0), a step
    # against another route at the bf16 contract (tests/torch_parity.py)
    torch.bfloat16: SimpleNamespace(
        sums=None, gram=None, dipcn=0.0, sweeps=1e-5, boot=None, z=BF16_RTOL, ties=BF16_RTOL,
        step_dipcn=BF16_RTOL, gram_peak=BF16_FLOP_PER_S, peak=FP32_FLOP_PER_S),
}
# the five kernels of the cohort step: (route, source, the TPU kernel or XLA
# loop it replaces), for float32 and float64
SOURCES = {
    "masked_column_stats": ("triton", "grid_tpu_torch/ops/gpu_kernels.py",
                            "grid_tpu/ops/pallas_kernels.py:168"),
    "zprep_gram": ("cuda", "grid_tpu_torch/csrc/zprep_gram.cu",
                   "grid_tpu/ops/pallas_kernels.py:93"),
    "dipcn_from_distances_gpu": ("cuda", "grid_tpu_torch/csrc/dipcn_select.cu",
                                 "grid_tpu/ops/pallas_select.py:130"),
    "sorted_smallest_k_gpu": ("cuda", "grid_tpu_torch/csrc/knn_select.cu",
                              "grid_tpu/models/cohort.py:189 (lax.approx_max_k; also "
                              "grid_tpu/ops/knn.py:168-199 and grid_tpu/parallel/pknn.py:84; "
                              "no pallas_call)"),
    "phase_sweeps_gpu": ("cuda", "grid_tpu_torch/csrc/phase_sweeps.cu",
                         "grid_tpu/ops/phasing.py:94 (lax.scan, no pallas_call)"),
}
BF16_SOURCES = {  # the bf16 forms live in the float32 forms' sources, but the Gram's
    **{name: SOURCES[name] for name in ("masked_column_stats", "dipcn_from_distances_gpu",
                                        "sorted_smallest_k_gpu")},
    "zprep_gram": ("cuda", "grid_tpu_torch/csrc/zprep_gram16.cu",
                   "grid_tpu/ops/pallas_kernels.py:93"),
}
F64_SOURCES = {
    **SOURCES,
    "zprep_gram": ("cuda", "grid_tpu_torch/csrc/zprep_gram64.cu",
                   "grid_tpu/ops/pallas_kernels.py:93"),
    "sorted_smallest_k_gpu": ("cuda", "grid_tpu_torch/csrc/knn_select.cu",
                              "grid_tpu/models/cohort.py:189 (lax.approx_max_k; also "
                              "grid_tpu/ops/knn.py:168-199; no pallas_call)"),
}

# the wrappers of the selection and phasing kernels, which phases 4, 7, 15
# and 16 count beside the three wrappers of the earlier kernels
SELECTION = ("sorted_smallest_k_gpu", "phase_sweeps_gpu")


def phasing_modes(n: int, k: int, dev, dtype=torch.float32) -> list:
    """Every mode of phase_sweeps that takes n samples with lists of k
    slots of ``dtype`` values: the resident mode where it fits and can be
    scheduled, and the persistent mode."""
    from grid_tpu_torch.ops.phasing import phase_sweeps_info

    resident = phase_sweeps_info(n, k, dev, "resident", dtype=dtype)["clusters"] > 0
    return ["resident"] * resident + ["persistent"]


def hap_start(irrs, nbr_valid, min_nbr: int = 1):
    """The sweeps' starting values [2N] of phase_haplotypes."""
    deg = nbr_valid.sum(dim=1).reshape(-1, 2)
    phased = (deg[:, 0] >= min_nbr) & (deg[:, 1] >= min_nbr) & torch.isfinite(irrs)
    return torch.where(phased, irrs / 2, torch.nan).repeat_interleave(2)


def random_hap_lists(n: int, k: int, dev, seed: int):
    """Padded haplotype neighbor lists [2N, K] on ``dev``: degrees 0..K
    (every 11th list empty), neighbors and weights drawn with numpy."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, k + 1, 2 * n)
    deg[::11] = 0
    valid = np.arange(k)[None, :] < deg[:, None]
    idx = np.where(valid, rng.integers(0, 2 * n, (2 * n, k)), 0).astype(np.int32)
    w = np.where(valid, rng.uniform(0.1, 1.0, (2 * n, k)), 0).astype(np.float32)
    return [torch.tensor(a, device=dev) for a in (idx, w, valid)]


def check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def median_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median over ``reps`` runs of fn's device time, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def back_to_back_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Device time per call of ``reps`` calls issued back to back between
    two CUDA events: the host's launch cost overlaps the device's work."""
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(n_bytes: float, flop: float = 0.0, flop_per_s: float = TF32_FLOP_PER_S):
    """(least time in ms, "bytes" or "operations"): the larger of the bytes
    over the HBM rate and the operations over the peak."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flop / flop_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def sweeps_bound_ms(hap, irrs, idx, w, valid, n_iters: int,
                    flop_per_s: float = FP32_FLOP_PER_S):
    """phase_sweeps' bound on its inputs: each read once (the start
    vector, irrs, the lists as given, the validity bytes) and [B, 2N]
    values written once; 3 operations a valid slot (a product, two sums)
    and 9 a sample (divisions, sums and products of the update) in each
    sweep, counted over the samples whose values are not both NaN at the
    start (the others walk no list), at ``flop_per_s`` (the float32 peak
    unless told)."""
    reps = idx.shape[0] if idx.dim() == 3 else 1
    n_bytes = (sum(t.numel() * t.element_size() for t in (hap, irrs, idx, w, valid))
               + hap.element_size() * reps * hap.numel())
    live = ~hap.isnan().reshape(-1, 2).all(dim=1)
    slots = int(valid.reshape(live.numel(), -1)[live].sum())
    return bound_ms(n_bytes, n_iters * reps * (3 * slots + 9 * int(live.sum())), flop_per_s)


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def content(path) -> bytes:
    """A file's bytes, decompressed where it is gzipped."""
    return gzip.open(path).read() if str(path).endswith(".gz") else Path(path).read_bytes()


@contextmanager
def patched(module, attrs: dict):
    """Set ``module``'s attributes to ``attrs`` for the ``with`` block only."""
    saved = {name: getattr(module, name) for name in attrs}
    for name, value in attrs.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(module, name, value)


class Recorder:
    """A console that keeps every line the pipeline logs, with its style."""

    def __init__(self):
        self.lines = []

    def print(self, msg, style=None):
        self.lines.append((str(msg), style))

    def failures(self) -> list:
        return [(msg, style) for msg, style in self.lines if style in ("danger", "warning")]

    def styled(self, *styles) -> list:
        return [msg for msg, style in self.lines if style in styles]


def host_phase(build_s: float) -> None:
    """The host library of the port's bed.gz reader and text writers, built
    by g++ beside the kernels: its path, build time and compiler, and what
    the machine has of zlib's headers and libdeflate. Fails unless the port
    takes the native host route."""
    from grid_tpu_torch import native_host

    route = native_host.route()
    check(route == "native", f"the host library did not load: {route}")
    path = native_host.library_path()
    gxx = subprocess.run([native_host.CXX, "--version"], capture_output=True, text=True)
    zlib_h = subprocess.run([native_host.CXX, "-x", "c++", "-fsyntax-only", "-"],
                            input="#include <zlib.h>\n", capture_output=True, text=True)
    deflate = None
    for name in ("libdeflate.so.0", "libdeflate.so"):  # what bedwrite.h opens, in its order
        try:
            ctypes.CDLL(name)
        except OSError:
            continue
        deflate = name
        break
    compiler_out = path.with_suffix(".log").read_text().strip()
    print(f"[host] route {route}: {path} built in {build_s:.1f} s by "
          f"{gxx.stdout.splitlines()[0]} ({native_host.CXX} {' '.join(native_host.CXX_FLAGS)} "
          f"... {' '.join(native_host.LD_FLAGS)}); compiler warnings: "
          f"{compiler_out.count(chr(10)) + 1 if compiler_out else 0} lines", flush=True)
    print(f"[host] zlib.h {'found' if zlib_h.returncode == 0 else 'NOT found'}; libdeflate "
          f"{'found as ' + deflate if deflate else 'not found (zlib inflates and deflates)'}",
          flush=True)
    if compiler_out:
        print(f"[host] the compiler said:\n{compiler_out}", flush=True)


def ptxas_functions(log: str) -> list:
    """Each kernel function of an ``nvcc -Xptxas -v`` log, demangled where
    c++filt is on the PATH: its registers a thread, the rest of ptxas'
    usage line (barriers, static shared memory) and its spill bytes."""
    found, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers,? ?(.*)", line)
        if m and name:
            found.append({"function": name, "registers": int(m.group(1)),
                          "usage": m.group(2).strip(), "spill_bytes": spill})
            name = None
    if found and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(f["function"] for f in found),
                               text=True, capture_output=True).stdout.splitlines()
        if len(names) == len(found):
            for f, demangled in zip(found, names):
                f["function"] = demangled
    return found


def device_us(evt) -> float:
    """A profiler entry's own device time in µs (``self_cuda_time_total``
    in older PyTorch)."""
    us = getattr(evt, "self_device_time_total", None)
    return evt.self_cuda_time_total if us is None else us


def ring_neighbors(n: int):
    """Two haplotype neighbors per haplotype on a ring, padded."""
    from grid_tpu_torch.io.hap_neighbors import pad_hap_neighbors

    ring = [[((h + 2) % (2 * n), 1.0), ((h - 2) % (2 * n), 0.5)] for h in range(2 * n)]
    return pad_hap_neighbors(ring, 2)


def check_against(got, want, usable, n_nbr: int, label: str, dtype=torch.float32,
                  counts: dict | None = None) -> str:
    """Hold a cohort step's neighbor lists and dipCN to another route's
    under the rule of tests/torch_parity.py, at ``dtype``'s bounds (TOL):
    distances within the tie bound of the row's k-th distance, lists equal
    but for ties within it, dipcn_valid exact, dipCN within its rtol where
    the input sets agree. Puts the rows differing by ties and the rows
    whose dipCN input sets differ into ``counts``; returns a summary."""
    from torch_parity import dipcn_sets_differ, neighbor_rows_differing

    tol = TOL[dtype]
    ties = tol.ties * want.nbr_sq_dists[:, -1].astype(np.float64)
    row_err = np.max(np.abs(got.nbr_sq_dists.astype(np.float64) - want.nbr_sq_dists), axis=1)
    ratio = float(np.max(row_err / ties))
    check(ratio <= 1, f"{label}: neighbor distances, worst row at {ratio:.3f} of its tolerance")
    differ = neighbor_rows_differing(got.nbr_idx, got.nbr_sq_dists, want.nbr_idx,
                                     want.nbr_sq_dists, tol=ties)
    sets_differ = dipcn_sets_differ(got.nbr_idx, want.nbr_idx, usable, n_nbr)
    at_k = int((np.sort(got.nbr_idx, axis=1) != np.sort(want.nbr_idx, axis=1)).any(axis=1).sum())
    check(np.array_equal(got.dipcn_valid, want.dipcn_valid), f"{label}: dipcn_valid differs")
    same = got.dipcn_valid & ~sets_differ
    check(np.allclose(got.dipcn[same], want.dipcn[same], rtol=tol.step_dipcn, atol=0),
          f"{label}: dipCN differs beyond rtol {tol.step_dipcn:g}")
    if counts is not None:
        counts.update(ties=int(differ.size), sets=int(sets_differ.sum()))
    n = got.nbr_idx.shape[0]
    return (f"neighbor distances: max |diff| {float(row_err.max()):.3e}, worst row at "
            f"{ratio:.3f} of its tolerance ({tol.ties:g} of the row's k-th distance); nbr_idx "
            f"identical on {n - differ.size} of {n} rows, the other {differ.size} differ only by "
            f"ties within tol ({at_k} of them at the k-th neighbor); {int(sets_differ.sum())} "
            f"rows change a dipCN input set; dipcn_valid exact; dipCN within rtol "
            f"{tol.step_dipcn:g} on {int(same.sum())} rows")


def plain_panel_route(values_np, mask_np, reads_np, reads_valid_np, params, dev,
                      dtype=torch.float32):
    """The panel step's kNN and dipCN by the plain route in ``dtype``:
    normalize by the plain versions (CPU tensors), then on the card per row
    panel torch.mm of the prepared rows (TF32 off), the epilogue, stable
    sorts of the rows and the plain dipcn_from_distances. Returns the
    outputs it computes, as numpy arrays in a dict."""
    from grid_tpu_torch.ops.gpu_kernels import zprep_gram_panel_plain, zprep_split_plain
    from grid_tpu_torch.ops.knn import (
        panel_d2, prepare_z, region_filter_mask, sorted_smallest_k,
    )
    from grid_tpu_torch.ops.normalize import normalize_cohort, select_high_variance_mask
    from grid_tpu_torch.ops.select import dipcn_from_distances

    values = torch.tensor(values_np, dtype=dtype)
    mask = torch.tensor(mask_np)
    norm = normalize_cohort(values, mask)
    selected = select_high_variance_mask(norm.var_ratio, params.top_frac)
    ratios_seen = torch.where(selected, norm.var_ratio, torch.nan)
    region = selected & region_filter_mask(ratios_seen, params.frac_r, params.sigma2_max,
                                           n_written=selected.sum())
    sample_ok = norm.mask.any(dim=1)
    reads_valid = torch.tensor(reads_valid_np) & sample_ok
    w = torch.tensor(reads_np, dtype=dtype) / norm.row_means_raw
    zp = prepare_z(norm.z.to(dev), norm.mask.to(dev), params.zmax, region.to(dev))
    split = zprep_split_plain(zp, None, None, float("inf"))
    sample_ok, reads_valid, w = sample_ok.to(dev), reads_valid.to(dev), w.to(dev)
    n, k = zp.shape[0], params.num_neighbors
    found = []
    for i0 in range(0, n, params.row_block):
        rows = min(params.row_block, n - i0)
        d2 = panel_d2(zprep_gram_panel_plain(split, i0, rows), split.norms, i0, sample_ok)
        vals, idx = sorted_smallest_k(d2, k)
        dip, ok = dipcn_from_distances(d2, w[i0:i0 + rows], w, reads_valid,
                                       reads_valid[i0:i0 + rows], k=k, n_nbr=params.n_nbr)
        found.append((vals, idx, dip, ok))
    cat = [torch.cat(parts).cpu().numpy() for parts in zip(*found)]
    return {"z": norm.z.numpy(), "z_mask": norm.mask.numpy(), "region_used": region.numpy(),
            "nbr_sq_dists": cat[0], "nbr_idx": cat[1], "dipcn": cat[2], "dipcn_valid": cat[3]}


def panel_phase(dev, card: str, dtype=torch.float32) -> tuple:
    """Phase 7 in ``dtype`` (float64: phase 17 (a, c)): the row-panel
    branch at N=65,536, each kernel at its shapes against its plain version
    at TOL[dtype], the step against the plain route on the card. Returns,
    per kernel, its JSON fields at the panel shapes, the prepared z (phase
    11; float32 only) and the cohort with the step's outputs, time and tie
    counts (phase 15)."""
    from grid_tpu_torch.synth import make_matrix
    from grid_tpu_torch.convert import inputs_to_torch, outputs_to_numpy
    from grid_tpu_torch.models.cohort import CohortParams, cohort_step, d2_resident
    from grid_tpu_torch.ops.gpu_kernels import (
        masked_column_stats, masked_column_stats_plain, zprep_gram_panel,
        zprep_gram_panel_plain, zprep_split, zprep_split_plain,
    )
    from grid_tpu_torch.ops.gpu_select import (
        _knn_launch, dipcn_from_distances_gpu, dipcn_select_info, knn_select_info,
        sorted_smallest_k_gpu,
    )
    from grid_tpu_torch.ops.knn import panel_d2, prepare_z, sorted_smallest_k
    from grid_tpu_torch.ops.masked import masked_mean
    from grid_tpu_torch.ops.phasing import (
        _sweeps_launch, phase_sweeps, phase_sweeps_gpu, phase_sweeps_info,
    )
    from grid_tpu_torch.ops.select import dipcn_from_distances
    from torch_parity import assert_close_to_max
    from torch_plans import zprep_gram64_l2_bytes

    f32, tol, e = dtype == torch.float32, TOL[dtype], torch.finfo(dtype).bits // 8
    tag = "" if f32 else " f64"
    kind = str(dtype).removeprefix("torch.")
    n, r = PANEL_N, PANEL_R
    params = CohortParams(num_neighbors=K, n_nbr=N_NBR, n_iters=N_ITERS, quantize=False)
    check(not d2_resident(params, n, e), f"N=65,536 must take the panel branch in {kind}")
    b = params.row_block
    n_panels = -(-n // b)
    t0 = time.perf_counter()
    values_np, mask_np, reads_np = make_matrix(n, r)
    reads_valid_np = np.ones(n, bool)
    hap = ring_neighbors(n)
    inputs = inputs_to_torch(values_np, mask_np, reads_np, reads_valid_np, *hap, dev, dtype)
    print(f"[panels{tag}] set-up: {n}x{r} cohort made and copied to the card in "
          f"{time.perf_counter() - t0:.1f} s (host clock)", flush=True)

    # ---- the step, with its launches and its peak memory -----------------
    counted = step_wrappers()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with plain_calls_counted() as plains:
        out = cohort_step(*inputs, params)
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated() - base
    print(f"[panels{tag}] cohort_step {kind} N={n} R={r} k={K} on "
          f"{torch.cuda.get_device_name(0)}: first call {first_s:.2f} s; kernel launches "
          f"{launches}; plain versions reached {dict(plains)}", flush=True)
    want_launches = {"masked_column_stats": 2, "zprep_gram": 0, "zprep_split": 1,
                     "zprep_gram_panel": n_panels, "dipcn_from_distances_gpu": n_panels,
                     "sorted_smallest_k_gpu": n_panels, "phase_sweeps_gpu": 1}
    check(launches == want_launches, f"panel-branch launches {launches} != {want_launches}")
    check(not plains, f"the {kind} panel step reached a plain version: {dict(plains)}")
    panel_bytes = b * n * e
    print(f"[panels{tag}] peak device memory {peak / 2**30:.3f} GiB above the "
          f"{base / 2**30:.3f} GiB of inputs ({peak / panel_bytes:.1f}x one {b}x{n} {kind} panel "
          f"of {panel_bytes / 2**20:.0f} MiB; an [N, N] {kind} matrix would be "
          f"{n * n * e / 2**30:.0f} GiB)", flush=True)
    check(peak < 32 * panel_bytes, "the panel branch's peak memory is not O(row_block * N)")
    got = outputs_to_numpy(out)
    check(got.nbr_idx.shape == (n, K) and got.nbr_idx.dtype == np.int32, "nbr_idx shape, dtype")
    check(got.z.dtype.itemsize == e and got.dipcn.dtype.itemsize == e, f"{kind} outputs")
    check(np.isfinite(got.dipcn[got.dipcn_valid]).all(), "non-finite dipCN on a valid row")
    check(np.isfinite(got.hap_irrs[np.repeat(got.phased, 2)]).all(), "non-finite phased hap")

    # ---- the plain route on the card ------------------------------------
    t0 = time.perf_counter()
    want = SimpleNamespace(**plain_panel_route(values_np, mask_np, reads_np, reads_valid_np,
                                               params, dev, dtype))
    plain_s = time.perf_counter() - t0
    check(np.array_equal(got.region_used, want.region_used), "panel step: region_used differs")
    z_err = assert_close_to_max(got.z, want.z, tol.z)
    usable = reads_valid_np & want.z_mask.any(axis=1)
    ties_found = {}
    summary = check_against(got, want, usable, N_NBR, f"{kind} panel step vs plain route", dtype,
                            ties_found)
    print(f"[panels{tag}] vs the plain route on the card ({plain_s:.1f} s): z within {tol.z:g} "
          f"of max|z| (max abs err {z_err:.3e}); {summary}; {int(got.phased.sum())} phased",
          flush=True)
    del want

    # ---- each kernel at the panel shapes, against its plain version ------
    z, zmask, region = out.z, out.z_mask, out.region_used
    sample_ok = zmask.any(dim=1)
    reads_valid = inputs[3] & sample_ok
    w = inputs[2] / out.scales
    rm = masked_mean(inputs[0], inputs[1], axis=1)
    good = torch.isfinite(rm) & (rm != 0)
    cs = (inputs[0], inputs[1] & good[:, None], torch.where(good, 1 / torch.where(good, rm, 1), 0))
    mu = out.col_means.nan_to_num()
    cnt, s_, sq = masked_column_stats(*cs, mu)
    pcnt, ps, psq = masked_column_stats_plain(*cs, mu)
    check(torch.equal(cnt, pcnt), f"masked_column_stats {kind} panel shape: counts differ")
    check(torch.allclose(s_, ps, rtol=tol.sums, atol=0)
          and torch.allclose(sq, psq, rtol=tol.sums, atol=0),
          f"masked_column_stats {kind} panel shape: sums")
    errs = {"masked_column_stats": max(max_abs(s_, ps), max_abs(sq, psq))}

    split = zprep_split(z, zmask, region, ZMAX)
    plain_split = zprep_split_plain(z, zmask, region, ZMAX)
    if not f32:
        check(split.p.dtype == dtype and split.p.shape[0] == 1, "f64 split: P itself, [1, N, R_pad]")
    norm_err = assert_close_to_max(split.norms.cpu(), plain_split.norms.cpu(), tol.gram)
    p64 = plain_split.p.double() if f32 else None
    last = n - (n - 1) % b - 1
    gram_err = 0.0
    for i0 in (0, last):
        rows = min(b, n - i0)
        g, pg = zprep_gram_panel(split, i0, rows), zprep_gram_panel_plain(plain_split, i0, rows)
        gram_err = max(gram_err, assert_close_to_max(g.cpu(), pg.cpu(), tol.gram))
        gate = ""
        if f32:
            g64 = p64[i0:i0 + rows] @ p64.T
            err64, plain64 = max_abs(g, g64), max_abs(pg, g64)
            check(err64 <= 2 * plain64, f"zprep_gram panel {i0}: error vs float64 {err64:.3e} > "
                                        f"2x the plain version's {plain64:.3e}")
            gate = (f", vs a float64 Gram: kernel {err64:.3e}, plain {plain64:.3e} "
                    f"({err64 / plain64:.3f}x, gate 2x)")
            del g64
        print(f"[panels{tag}] zprep_gram panel rows [{i0}, {i0 + rows}): within {tol.gram:g} of "
              f"max|G|{gate}; norms within {tol.gram:g} of max (max abs err {norm_err:.3e})",
              flush=True)
    del p64
    errs["zprep_gram"] = max(gram_err, norm_err)
    g0 = zprep_gram_panel(split, 0, b)
    d2 = panel_d2(g0, split.norms, 0, sample_ok)
    dip_args = (d2, w[:b].contiguous(), w, reads_valid, reads_valid[:b].contiguous())
    dip, ok = dipcn_from_distances_gpu(*dip_args, k=K, n_nbr=N_NBR)
    pdip, pok = dipcn_from_distances(*dip_args, k=K, n_nbr=N_NBR)
    check(torch.equal(ok, pok), f"dipcn {kind} wide panel: ok differs")
    check(torch.allclose(dip[ok], pdip[ok], rtol=tol.dipcn, atol=0),
          f"dipcn {kind} wide panel: values")
    errs["dipcn_from_distances_gpu"] = max_abs(dip[ok], pdip[ok])
    dinfo = dipcn_select_info(n, K, dev, dtype=dtype)
    print(f"[panels{tag}] dipcn_select [{b}, {n}] in its {dinfo['mode']} mode: ok exact "
          f"({int(ok.sum())} rows), within rtol {tol.dipcn:g} (max abs err "
          f"{errs['dipcn_from_distances_gpu']:.3e}); {dinfo['smem_bytes']} B dynamic + "
          f"{dinfo['static_smem_bytes']} B static shared memory, {dinfo['blocks_per_sm']} blocks "
          f"per SM, {dinfo['registers']} registers, {dinfo['spill_bytes']} B spilled", flush=True)
    check(dinfo["mode"] == "wide" and dinfo["spill_bytes"] == 0, "dipcn_select wide mode shape")
    # knn_select (float32: a cluster of 8 blocks a row; float64: the wide
    # mode) against one flat stable sort of the panel, and its wide mode
    # (the keys in device memory) bitwise
    vals_k, idx_k = sorted_smallest_k_gpu(d2, K)
    vals1, idx1 = sorted_smallest_k(d2, K)
    check(torch.equal(vals_k, vals1) and torch.equal(idx_k, idx1),
          f"knn_select {kind} differs from a flat stable sort of the panel")
    check(all(torch.equal(a, c) for a, c in zip(_knn_launch("wide", d2, K), (vals_k, idx_k))),
          f"knn_select {kind}: its wide mode differs from its mode on the panel")
    errs["sorted_smallest_k_gpu"] = max_abs(vals_k, vals1)
    kinfo = knn_select_info(n, K, dev, dtype=dtype)
    check((kinfo["mode"], kinfo["cluster_blocks"]) == (("cluster", 8) if f32 else ("wide", 1))
          and kinfo["spill_bytes"] == 0, f"knn_select {kind} panel mode {kinfo}")
    print(f"[panels{tag}] knn_select [{b}, {n}] k={K} in its {kinfo['mode']} mode: values and "
          f"positions bitwise a flat stable sort's, the wide mode's the same; "
          f"{kinfo['cluster_blocks']} block(s) a row, {kinfo['slice']} columns a block, "
          f"{kinfo['smem_bytes']} B dynamic + {kinfo['static_smem_bytes']} B static shared "
          f"memory, {kinfo['blocks_per_sm']} blocks per SM, {kinfo['clusters']} clusters at "
          f"once, {kinfo['registers']} registers, {kinfo['spill_bytes']} B spilled; {card}",
          flush=True)
    del vals1, idx1, vals_k, idx_k
    # phase_sweeps at N=65,536 (the persistent mode) against the plain sweeps
    step_irrs = torch.where(out.dipcn_valid, out.dipcn, torch.nan)
    step_lists = inputs[4:7]
    step_hap0 = hap_start(step_irrs, step_lists[2])
    sweeps = phase_sweeps_gpu(step_hap0, step_irrs, *step_lists, N_ITERS)
    plain_sweeps = phase_sweeps(step_hap0, step_irrs, *step_lists, N_ITERS)
    nan = sweeps.isnan()
    check(torch.equal(nan, plain_sweeps.isnan())
          and torch.allclose(sweeps[~nan], plain_sweeps[~nan], rtol=tol.sweeps, atol=0),
          f"phase_sweeps {kind} at the panel step: beyond rtol {tol.sweeps:g} of the plain "
          f"sweeps or NaNs differ")
    errs["phase_sweeps_gpu"] = max_abs(sweeps[~nan], plain_sweeps[~nan])
    pinfo = phase_sweeps_info(n, step_lists[0].shape[1], dev, dtype=dtype)
    check(pinfo["mode"] == "persistent" and launches["phase_sweeps_gpu"] == 1,
          f"phase_sweeps at N={n}: {pinfo['mode']} mode, {launches['phase_sweeps_gpu']} "
          f"launches a step; the persistent mode's one launch expected")
    print(f"[panels{tag}] phase_sweeps N={n}, {N_ITERS} sweeps in its {pinfo['mode']} mode (one "
          f"cooperative launch of {pinfo['grid_blocks']} blocks of {pinfo['threads']} threads, "
          f"{pinfo['registers']} registers, {pinfo['spill_bytes']} B spilled): within rtol "
          f"{tol.sweeps:g} of the plain sweeps (max abs err {errs['phase_sweeps_gpu']:.3e}), "
          f"NaN cells identical; {card}", flush=True)
    del sweeps, plain_sweeps

    # ---- times ------------------------------------------------------------
    step_ms = [median_ms(lambda: cohort_step(*inputs, params), reps=PANEL_REPS, warmup=1)
               for _ in range(2)]
    print(f"[times{tag}] panel cohort_step {kind} N={n} R={r} k={K} n_iters={N_ITERS}: "
          f"{min(step_ms):.1f} ms (better of two medians of {PANEL_REPS}: "
          f"{step_ms[0]:.1f}, {step_ms[1]:.1f}); {card}", flush=True)
    p_panel = plain_split.p[:b]
    timed = {
        "masked_column_stats": (lambda: masked_column_stats(*cs, mu),
                                lambda: masked_column_stats_plain(*cs, mu), None),
        "zprep_gram": (lambda: zprep_gram_panel(split, 0, b),
                       lambda: zprep_gram_panel_plain(plain_split, 0, b),
                       lambda: torch.mm(p_panel, plain_split.p.T)),
        "dipcn_from_distances_gpu": (
            lambda: dipcn_from_distances_gpu(*dip_args, k=K, n_nbr=N_NBR),
            lambda: dipcn_from_distances(*dip_args, k=K, n_nbr=N_NBR), None),
        "sorted_smallest_k_gpu": (
            lambda: sorted_smallest_k_gpu(d2, K), lambda: sorted_smallest_k(d2, K),
            lambda: torch.sort(d2, dim=1, stable=True).values[:, :K]),
    }
    r_pad = split.p.shape[-1]
    bounds = {
        "masked_column_stats": bound_ms(n * r * (e + 1) + e * n + e * r + 3 * e * r),
        # P [N, R] in, read once, the panel out; 2*B*N*R operations (a panel
        # needs every product) at the Gram's peak (TF32: the kernel's split
        # halves are its design, not the work's)
        "zprep_gram": bound_ms(n * r * e + b * n * e, 2 * b * n * r, tol.gram_peak),
        # one panel of d2 read once, the vectors, dipcn and ok out
        "dipcn_from_distances_gpu": bound_ms(b * n * e + 2 * e * b + e * n + n + 2 * b),
        # one panel of d2 read once, k values and positions a row out
        "sorted_smallest_k_gpu": bound_ms(b * n * e + (e + 4) * b * K),
    }
    shapes = {"masked_column_stats": f"[{n}, {r}], 2 calls per step",
              "zprep_gram": f"split [{n}, {r}] once per step, then panels [{b}, {n}]",
              "dipcn_from_distances_gpu": f"wide mode, panels [{b}, {n}]",
              "sorted_smallest_k_gpu": f"{kinfo['mode']} mode ({kinfo['cluster_blocks']} block(s) "
                                       f"a row), panels [{b}, {n}], k={K}"}
    rows = {}
    for name, (kernel_fn, plain_fn, lib_fn) in timed.items():
        p1, k1, k2, p2 = (back_to_back_ms(f, reps=5, warmup=1)
                          for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
        kernel_ms, plain_ms = min(k1, k2), min(p1, p2)
        lib_ms = None if lib_fn is None else min(back_to_back_ms(lib_fn, reps=5, warmup=1)
                                                 for _ in range(2))
        least, by = bounds[name]
        calls = launches[name] if name != "zprep_gram" else launches["zprep_gram_panel"]
        lib = "" if lib_ms is None else (
            f", the stable torch.sort sliced to k {lib_ms:.4f} ms"
            if name == "sorted_smallest_k_gpu" else f", torch.mm of the panel {lib_ms:.4f} ms")
        if name == "zprep_gram" and not f32:  # reckoned from the tiles, not measured
            l2_bytes = zprep_gram64_l2_bytes(n, b, "panel", r_pad)
            lib += (f"; the tiles read {l2_bytes / 1e9:.3f} GB from L2 a panel (estimated from "
                    f"the tile count), {l2_bytes / kernel_ms / 1e9:.2f} TB/s at this time")
        print(f"[times{tag}] {name} {kind} at {shapes[name]}: kernel {kernel_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms{lib} per call (5 back to back, better of two); bound "
              f"{least:.4f} ms by {by}, {100 * least / kernel_ms:.1f}% of it; {calls} calls per "
              f"step: {calls * kernel_ms:.1f} ms; {card}", flush=True)
        rows[name] = {"launches": calls, "max_abs_err": errs[name], "ms": kernel_ms,
                      "plain_ms": plain_ms, "bound_ms": least, "bound_by": by,
                      "library_ms": lib_ms, "shape": shapes[name]}
    split_ms = min(back_to_back_ms(lambda: zprep_split(z, zmask, region, ZMAX), reps=5, warmup=1)
                   for _ in range(2))
    if f32:  # the split writes both halves and computes the 128-row diagonal tiles
        split_bound, split_by = bound_ms(n * r * 5 + r + 2 * n * r_pad * 4 + 4 * n,
                                         2 * n * 128 * r)
    else:  # the prep writes P, the diagonal tiles give the norms
        split_bound, split_by = bound_ms(n * r * 9 + r + n * r_pad * 8 + 8 * n, 2 * n * r,
                                         tol.gram_peak)
    rows["zprep_gram"].update(split_launches=launches["zprep_split"], split_ms=split_ms)
    topk_ms = min(back_to_back_ms(lambda: torch.topk(d2, K, dim=1, largest=False, sorted=True),
                                  reps=5, warmup=1) for _ in range(2))
    knn_wide_ms = min(back_to_back_ms(lambda: _knn_launch("wide", d2, K), reps=5, warmup=1)
                      for _ in range(2))
    rows["sorted_smallest_k_gpu"].update(
        library=f"stable torch.sort of the panel's {kind} rows, sliced to k", topk_ms=topk_ms,
        wide_mode_ms_back_to_back=knn_wide_ms)
    rows["zprep_gram"]["library"] = f"torch.mm of the {kind} panel" + (
        ", TF32 off" if f32 else " (cuBLAS DGEMM)")
    epi_ms = min(back_to_back_ms(lambda: panel_d2(g0, split.norms, 0, sample_ok), reps=5,
                                 warmup=1) for _ in range(2))
    sel_ms = rows["sorted_smallest_k_gpu"]["ms"]
    print(f"[times{tag}] zprep_split once per step: {split_ms:.4f} ms, bound {split_bound:.4f} "
          f"ms by {split_by}; per panel: the epilogue (norms, -2G, clamp, self and invalid "
          f"columns) {epi_ms:.4f} ms, knn_select {sel_ms:.4f} ms (its wide mode, the keys in "
          f"device memory, {knn_wide_ms:.4f} ms; torch.topk {topk_ms:.4f} ms), i.e. "
          f"{n_panels * sel_ms:.1f} ms of selection and "
          f"{n_panels * epi_ms:.1f} ms of epilogue per step; {card}", flush=True)
    del d2, g0
    # the phasing's one launch beside the Python loop (kernel,
    # plain, plain, kernel)
    kern = lambda: phase_sweeps_gpu(step_hap0, step_irrs, *step_lists, N_ITERS)  # noqa: E731
    loop = lambda: phase_sweeps(step_hap0, step_irrs, *step_lists, N_ITERS)  # noqa: E731
    s1, p1, p2, s2 = (median_ms(f, reps=PANEL_REPS, warmup=1) for f in (kern, loop, loop, kern))
    sweep_ms, sweep_plain_ms = min(s1, s2), min(p1, p2)
    sweep_bound, sweep_by = sweeps_bound_ms(step_hap0, step_irrs, *step_lists, N_ITERS,
                                            flop_per_s=tol.peak)
    # the persistent launch back to back beside the floor of a launch a
    # sweep (N_ITERS empty launches back to back)
    out_sweep = torch.empty((1, 2 * n), dtype=dtype, device=dev)
    step_idx32 = step_lists[0].to(torch.int32)
    sweep_b2b = min(back_to_back_ms(lambda: _sweeps_launch(
        "persistent", step_hap0, step_irrs, step_idx32, *step_lists[1:], N_ITERS, out_sweep))
        for _ in range(2))
    floor_ms = N_ITERS * min(back_to_back_ms(lambda: torch.cuda._sleep(0), reps=10 * N_ITERS)
                             for _ in range(2))
    rows["phase_sweeps_gpu"] = {
        "launches": launches["phase_sweeps_gpu"], "max_abs_err": errs["phase_sweeps_gpu"],
        "ms": sweep_ms, "plain_ms": sweep_plain_ms, "bound_ms": sweep_bound,
        "bound_by": sweep_by, "library_ms": None, "ms_back_to_back": sweep_b2b,
        "launch_a_sweep_floor_ms": floor_ms,
        "shape": f"{pinfo['mode']} mode, N={n}, K={step_lists[0].shape[1]}, {N_ITERS} sweeps"}
    print(f"[times{tag}] phase_sweeps {kind} N={n}, {N_ITERS} sweeps "
          f"({launches['phase_sweeps_gpu']} launch(es), {pinfo['mode']} mode): the wrapper's call "
          f"{sweep_ms:.4f} ms, the Python loop {sweep_plain_ms:.3f} ms (medians of {PANEL_REPS}, "
          f"better of two); back to back (better of two rounds) {sweep_b2b:.4f} ms "
          f"({1e3 * sweep_b2b / N_ITERS:.2f} us a sweep); {N_ITERS} empty launches back to back "
          f"{floor_ms:.4f} ms; bound {sweep_bound:.4f} ms by {sweep_by}, "
          f"{100 * sweep_bound / sweep_b2b:.1f}% of it; {card}", flush=True)

    # ---- profile -------------------------------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cohort_step(*inputs, params)
        torch.cuda.synchronize()
    ops = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    if ops:
        dev_ms = sum(map(device_us, ops)) / 1e3
        print(f"[profile{tag}] panel cohort_step {kind}: device time {dev_ms:.1f} ms in one step "
              f"({100 * dev_ms / min(step_ms):.1f}% of the {min(step_ms):.1f} ms step), "
              f"{sum(ev.count for ev in ops)} device ops; {card}", flush=True)
        for ev in sorted(ops, key=device_us, reverse=True)[:14]:
            print(f"[profile{tag}]   {device_us(ev) / 1e3:9.3f} ms/step {ev.count:6d} calls/step  "
                  f"{ev.key[:80]}")
        # no sort over panel rows: what sorts is the R variance ratios, once
        sorts = [ev for ev in ops if "sort" in ev.key.lower()]
        print(f"[profile{tag}] panel cohort_step: {len(sorts)} sort kernels, "
              f"{sum(ev.count for ev in sorts)} calls, {sum(map(device_us, sorts)) / 1e3:.3f} ms "
              f"in one step: " + "; ".join(f"{ev.count} x {ev.key[:60]}" for ev in sorts),
              flush=True)
        check(all(ev.count < n_panels for ev in sorts),
              "the panel step still runs a sort once per panel")
    else:
        print(f"[profile{tag}] torch.profiler saw no device activity: device time not measured")
    zp = prepare_z(z, zmask, ZMAX, region) if f32 else None  # phase 11's geometry at this N
    del out, split, plain_split, inputs, z, zmask
    torch.cuda.empty_cache()
    # phase 15 (c) runs the ring on this cohort and holds it to this step
    cohort = SimpleNamespace(values=values_np, mask=mask_np, reads=reads_np, flat=got,
                             step_ms=min(step_ms), ties=ties_found["ties"],
                             sets=ties_found["sets"])
    return rows, zp, cohort


def branch_phase(dev, card: str):
    """Phase 8: the resident and the panel branch on one N=16,384 cohort.
    Returns the cohort and the resident (flat) step's outputs, which phase
    15 holds the ring to."""
    from grid_tpu_torch.synth import make_matrix
    from grid_tpu_torch.convert import inputs_to_torch, outputs_to_numpy
    from grid_tpu_torch.models.cohort import CohortParams, cohort_step, d2_resident

    n, r = BRANCH_N, PANEL_R
    resident = CohortParams(num_neighbors=K, n_nbr=N_NBR, n_iters=N_ITERS, quantize=False)
    panels = resident._replace(d2_budget_bytes=n * n * 4 - 1)
    check(d2_resident(resident, n, 4) and not d2_resident(panels, n, 4), "branch choice")
    values_np, mask_np, reads_np = make_matrix(n, r, seed=1)
    reads_valid_np = np.ones(n, bool)
    inputs = inputs_to_torch(values_np, mask_np, reads_np, reads_valid_np, *ring_neighbors(n), dev,
                             torch.float32)
    outs = {name: outputs_to_numpy(cohort_step(*inputs, p))
            for name, p in (("resident", resident), ("panels", panels))}
    usable = reads_valid_np & outs["resident"].z_mask.any(axis=1)
    summary = check_against(outs["panels"], outs["resident"], usable, N_NBR, "branches")
    # resident, panels, panels, resident: neither gets the warmer card
    t = [median_ms(lambda p=p: cohort_step(*inputs, p), reps=PANEL_REPS, warmup=1)
         for p in (resident, panels, panels, resident)]
    print(f"[branches] N={n} R={r} k={K}: panel branch vs resident branch: {summary}", flush=True)
    print(f"[branches] step time at N={n}: resident {min(t[0], t[3]):.1f} ms, panels "
          f"{min(t[1], t[2]):.1f} ms (better of two medians of {PANEL_REPS}; rounds "
          f"{', '.join(f'{x:.1f}' for x in t)}); {card}", flush=True)
    del inputs
    torch.cuda.empty_cache()
    return SimpleNamespace(values=values_np, mask=mask_np, reads=reads_np,
                           flat=outs["resident"])


RING_WORLDS = (1, 4)  # 1: NCCL (one rank per card); 4: gloo, sharing the card
RING_BIOBANK_WORLD = 4
RING_LAUNCHES = {"masked_column_stats": 2, "zprep_split": 1}  # per rank; W cross launches


def host_dtype(dtype) -> np.dtype:
    """The numpy dtype of ``dtype``'s outputs on the host: bfloat16 comes
    back as float32, which holds each of its values (``convert.to_numpy``)."""
    return np.dtype(np.float32) if dtype == torch.bfloat16 else torch.empty(
        (), dtype=dtype).numpy().dtype


def ring_run(label: str, world: int, cohort, params, card: str,
             dtype=torch.float32) -> tuple:
    """One ``sharded_cohort_step`` over ``world`` ranks of the card on
    ``cohort`` in ``dtype``, its launches checked rank by rank. Returns the
    unpadded outputs (numpy), the ranks' reports and the call's host
    seconds."""
    from grid_tpu_torch.convert import outputs_to_numpy
    from grid_tpu_torch.parallel import sharded_cohort_step
    from grid_tpu_torch.parallel.mesh import COUNTED, choose_transport
    from grid_tpu_torch.parallel.pcohort import ROW_FIELDS
    from grid_tpu_torch.parallel.pknn import MERGE_ROWS

    n = cohort.values.shape[0]
    hap = ring_neighbors(n)
    for fn in COUNTED.values():
        fn.launches = 0
    console, reports = Recorder(), []
    t0 = time.perf_counter()
    out = sharded_cohort_step(world, cohort.values, cohort.mask, cohort.reads, np.ones(n, bool),
                              *hap, params, dtype=dtype, console=console, reports=reports)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in COUNTED.items()}
    transport = choose_transport(world, "cuda")
    said = [msg for msg, _ in console.lines if msg.startswith("sharded step:")]
    check(said == [f"sharded step: {world} rank(s) on 1 card(s), transport {transport}"],
          f"ring {label}: transport line {said}")
    want = {name: 0 for name in COUNTED} | RING_LAUNCHES | {"zprep_gram_cross": world} | {
        "sorted_smallest_k_gpu": world * -(-(n // world) // MERGE_ROWS),
        "phase_sweeps_gpu": 1}
    for rank, rep in enumerate(reports):
        got = {name: rep[name] for name in COUNTED}
        check(got == want, f"ring {label}: rank {rank} launched {got}, expected {want}")
    check(launches == {name: world * count for name, count in want.items()},
          f"ring {label}: the parent's counts {launches}")
    got = outputs_to_numpy(out)
    got = got._replace(**{name: getattr(got, name)[:n] for name in ROW_FIELDS})
    check(got.nbr_idx.shape == (n, params.num_neighbors), f"ring {label}: nbr_idx shape")
    check(np.isfinite(got.dipcn[got.dipcn_valid]).all(), f"ring {label}: non-finite dipCN")
    check(got.z.dtype == got.nbr_sq_dists.dtype == host_dtype(dtype),
          f"ring {label}: outputs not in {dtype}")
    spans = {key: statistics.mean(rep[key] for rep in reports)
             for key in reports[0] if key.startswith("sharded.")}
    print(f"[ring] {label}: sharded_cohort_step over {world} rank(s) in {dtype}, transport "
          f"{transport}: "
          f"{wall:.2f} s for the call (host clock: spawn, the ranks' start on the card, the "
          f"step and the copies), {statistics.mean(rep['seconds'] for rep in reports):.3f} s "
          f"for the step in the ranks (mean; "
          + ", ".join(f"{key} {sec:.3f} s" for key, sec in spans.items())
          + f"); the ring {spans['sharded.ring'] / world * 1e3:.1f} ms per step (host clock, "
          f"mean of the ranks; {world} rank(s) on one card); peak device memory per "
          f"rank {', '.join('%.3f' % (rep['peak_bytes'] / 2**30) for rep in reports)} GiB; "
          f"launches per rank {want}; {card}", flush=True)
    return got, reports, wall


def ring_phase(dev, card: str, cohort_16384, cohort_65536, zp_65536) -> dict:
    """Phase 15 (a-c): the sharded step on W ranks of the one card. (a) At
    phase 8's N=16,384 (the crossover) over 4 gloo ranks, held to
    phase 8's flat step: z and the column statistics within 1e-5 of their
    largest entry, region_used equal, the neighbor lists and dipCN under
    the tie rule; the cross mode against its plain version and bitwise
    against zprep_gram_panel's entries, and timed per [B, B] block. (b) W=1
    through NCCL, held to the same. (c) N=65,536 over 4 ranks, held to
    phase 7's flat step, with each rank's peak memory. Returns the zprep_gram
    and masked_column_stats rows' ring entries for the JSON line."""
    from grid_tpu_torch.models.cohort import CohortParams
    from grid_tpu_torch.ops.gpu_kernels import (
        zprep_gram_cross, zprep_gram_cross_plain, zprep_gram_panel, zprep_split,
        zprep_split_plain,
    )
    from grid_tpu_torch.ops.knn import prepare_z
    from torch_parity import assert_close_to_max

    t_phase = time.perf_counter()
    params = CohortParams(num_neighbors=K, n_nbr=N_NBR, n_iters=N_ITERS, quantize=False)
    flat = cohort_16384.flat
    n, r = cohort_16384.values.shape
    usable = flat.z_mask.any(axis=1)
    runs = {}
    for world in RING_WORLDS:
        label = f"N={n} R={r} k={K}, W={world}"
        got, reports, wall = ring_run(label, world, cohort_16384, params, card)
        z_err = assert_close_to_max(got.z, flat.z, 1e-5)
        stat_err = max(assert_close_to_max(got.col_means, flat.col_means, 1e-5),
                       assert_close_to_max(got.col_vars, flat.col_vars, 1e-5))
        check(np.array_equal(got.region_used, flat.region_used), f"ring {label}: region_used")
        summary = check_against(got, flat, usable, N_NBR, f"ring {label} vs the flat step")
        print(f"[ring] {label} vs phase 8's flat step: z within 1e-5 of max|z| (max abs err "
              f"{z_err:.3e}), column means and variances within 1e-5 (max abs err "
              f"{stat_err:.3e}), region_used equal; {summary}", flush=True)
        runs[world] = (got, reports, wall)

    # ---- the cross mode at the ring's shapes, in this process ------------
    got4 = runs[4][0]
    zt = torch.tensor(got4.z, device=dev)
    zp = prepare_z(zt, torch.tensor(got4.z_mask, device=dev), ZMAX,
                   torch.tensor(got4.region_used, device=dev))
    whole = zprep_split(zp, None, None, math.inf)
    rows = {}
    for world in (2, 4):
        b = n // world
        blocks = [zprep_split(zp[i * b:(i + 1) * b].contiguous(), None, None, math.inf)
                  for i in range(world)]
        plain = [zprep_split_plain(zp[i * b:(i + 1) * b], None, None, math.inf)
                 for i in range(world)]
        err = 0.0
        for a in range(world):
            panel = zprep_gram_panel(whole, a * b, b)
            for o in range(world):
                g = zprep_gram_cross(blocks[a], blocks[o], a * b, o * b)
                check(torch.equal(g, panel[:, o * b:(o + 1) * b]),
                      f"zprep_gram_cross W={world} ({a}, {o}): not bitwise the panel's entries")
                err = max(err, assert_close_to_max(
                    g.cpu(), zprep_gram_cross_plain(plain[a], plain[o]).cpu(), 1e-5))
            del panel
        rows[world] = (b, blocks, plain, err)
        print(f"[ring] zprep_gram_cross at W={world}, B={b}: all {world * world} blocks bitwise "
              f"equal to zprep_gram_panel's entries for the same rows (own blocks with the "
              f"mirrored diagonal tiles), within 1e-5 of P_a P_b^T (max abs err {err:.3e}); "
              f"{card}", flush=True)
    del whole

    def time_cross(b, blocks, plain, label):
        """The cross mode per [B, B] block, off the diagonal and on it,
        beside its plain version and torch.mm (TF32 off)."""
        off = lambda: zprep_gram_cross(blocks[0], blocks[1], 0, b)  # noqa: E731
        own = lambda: zprep_gram_cross(blocks[0], blocks[0], 0, 0)  # noqa: E731
        pl = lambda: zprep_gram_cross_plain(plain[0], plain[1])  # noqa: E731
        pa, pb = plain[0].p, plain[1].p
        lib = lambda: torch.mm(pa, pb.T)  # noqa: E731  a yardstick the port never calls
        t = {name: [] for name in ("plain", "kernel", "own", "library")}
        for name in ("plain", "kernel", "own", "library", "library", "own", "kernel", "plain"):
            fn = {"plain": pl, "kernel": off, "own": own, "library": lib}[name]
            t[name].append(back_to_back_ms(fn, reps=10, warmup=2))
        best = {name: min(v) for name, v in t.items()}
        least, by = bound_ms(2 * b * r * 4 + b * b * 4, 2 * b * b * r)
        print(f"[times] zprep_gram_cross [{b}, {b}] x R={r} ({label}): kernel "
              f"{best['kernel']:.4f} ms off the diagonal, {best['own']:.4f} ms for a rank's "
              f"own block (with the mirrored tiles), plain {best['plain']:.4f} ms, torch.mm "
              f"(TF32 off) {best['library']:.4f} ms (10 back to back, better of two rounds in "
              f"turns); bound {least:.4f} ms by {by}, {100 * least / best['kernel']:.1f}% of it; "
              f"{2 * b * b * r / best['kernel'] / 1e9:.1f} TFLOP/s as 2*B^2*R; {card}",
              flush=True)
        return {"ms": best["kernel"], "own_block_ms": best["own"], "plain_ms": best["plain"],
                "library_ms": best["library"], "bound_ms": least, "bound_by": by,
                "shape": f"[{b}, {b}] x R={r}"}

    b4, blocks4, plain4, err4 = rows[4]
    cross_16384 = time_cross(b4, blocks4, plain4, f"N={n}, W=4")
    del rows, blocks4, plain4, zp, zt
    torch.cuda.empty_cache()

    # ---- (c) the biobank width over 4 ranks ------------------------------
    n65, r65 = cohort_65536.values.shape
    label = f"N={n65} R={r65} k={K}, W={RING_BIOBANK_WORLD}"
    got65, reports65, wall65 = ring_run(label, RING_BIOBANK_WORLD, cohort_65536, params, card)
    flat65 = cohort_65536.flat
    summary = check_against(got65, flat65, flat65.z_mask.any(axis=1), N_NBR,
                            f"ring {label} vs phase 7")
    print(f"[ring] {label} vs phase 7's flat (panel-branch) step: {summary}", flush=True)
    b65 = n65 // RING_BIOBANK_WORLD
    blocks = [zprep_split(zp_65536[i * b65:(i + 1) * b65].contiguous(), None, None, math.inf)
              for i in range(2)]
    plain = [zprep_split_plain(zp_65536[i * b65:(i + 1) * b65], None, None, math.inf)
             for i in range(2)]
    cross_65536 = time_cross(b65, blocks, plain, f"N={n65}, W={RING_BIOBANK_WORLD}")
    del blocks, plain
    torch.cuda.empty_cache()
    print(f"[ring] phase 15 (a-c) took {time.perf_counter() - t_phase:.1f} s (host clock); "
          f"times from several ranks on one card say nothing of scaling across cards, and "
          f"RING_CROSSOVER_N is not measured again here; {card}", flush=True)
    per_rank = lambda reports: {name: reports[0][name] for name in  # noqa: E731
                                ("masked_column_stats", "zprep_split", "zprep_gram_cross")}
    selection = lambda reports: {name: reports[0][name] for name in SELECTION}  # noqa: E731
    return {
        "selection": {f"launches_per_rank_16384_w{world}": selection(runs[world][1])
                      for world in RING_WORLDS} | {
                          "launches_per_rank_65536_w4": selection(reports65)},
        "zprep_gram": {"launches_per_rank_16384_w4": per_rank(runs[4][1]),
                       "launches_per_rank_65536_w4": per_rank(reports65),
                       "cross_16384_w4": cross_16384 | {"max_abs_err": err4},
                       "cross_65536_w4": cross_65536},
        "masked_column_stats": {"launches_per_rank_65536_w4": reports65[0]["masked_column_stats"]},
        "peak_bytes_per_rank_65536_w4": [rep["peak_bytes"] for rep in reports65],
        "cross_launches_16384_w4": sum(rep["zprep_gram_cross"] for rep in runs[4][1]),
        "seconds_65536_w4": wall65,
        "rank_seconds_65536_w4": [rep["seconds"] for rep in reports65],
    }


AUTO_WORLDS = (1, 4)  # 1: NCCL (one rank per card); 4: gloo, sharing the card
AUTO_BIOBANK_WORLD = 4
STAGE_WORLD = 2  # a cut from 4 for the time limit


@contextmanager
def keeping(module, rank_fn: str, keeper, keep_dir):
    """With ``keep_dir``, the ranks run ``keeper`` (a rank function of
    ``tests/torch_ranks.py`` that runs ``module.<rank_fn>`` and saves what it
    keeps to ``keep_dir``) in its place for the ``with`` block."""
    import torch_ranks

    if keep_dir is None:
        yield
        return
    saved = os.environ.get(torch_ranks.KEEP_ENV)
    os.environ[torch_ranks.KEEP_ENV] = str(keep_dir)
    try:
        with patched(module, {rank_fn: keeper}):
            yield
    finally:
        if saved is None:
            os.environ.pop(torch_ranks.KEEP_ENV)
        else:
            os.environ[torch_ranks.KEEP_ENV] = saved


def auto_run(label: str, world: int, cohort, params, card: str, platform: str = "cuda",
             keep_dir=None, dtype=torch.float32) -> tuple:
    """One ``auto_sharded_cohort_step`` call over ``world`` ranks of the card
    on ``cohort``, its transport and launches checked rank by rank. Returns
    the outputs (numpy), the ranks' reports and the call's host seconds.
    With ``keep_dir`` rank 0 saves the split it gathered there;
    ``platform="cpu"`` rehearses it on gloo ranks of the host."""
    import grid_tpu_torch.parallel.pcohort as pcohort
    import torch_ranks
    from grid_tpu_torch.convert import outputs_to_numpy
    from grid_tpu_torch.parallel import auto_sharded_cohort_step
    from grid_tpu_torch.parallel.mesh import COUNTED, choose_transport

    n = cohort.values.shape[0]
    b = n // world
    panels = -(-b // params.row_block)
    for fn in COUNTED.values():
        fn.launches = 0
    console, reports = Recorder(), []
    step = auto_sharded_cohort_step(world, params, platform=platform, dtype=dtype,
                                    console=console, reports=reports)
    with keeping(pcohort, "_rank_auto_step", torch_ranks.auto_rank_keeping_split, keep_dir):
        t0 = time.perf_counter()
        out = step(cohort.values, cohort.mask, cohort.reads, np.ones(n, bool),
                   *ring_neighbors(n), np.ones(n, bool))
        wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in COUNTED.items()}
    transport = choose_transport(world, platform)
    where = "the CPU" if platform == "cpu" else "1 card(s)"
    said = [msg for msg, _ in console.lines if msg.startswith("sharded step:")]
    check(said == [f"sharded step: {world} rank(s) on {where}, transport {transport}"],
          f"auto {label}: transport line {said}")
    want = {name: 0 for name in COUNTED} | {
        "masked_column_stats": 2, "zprep_split": 1, "zprep_gram_panel": panels,
        "dipcn_from_distances_gpu": panels, "sorted_smallest_k_gpu": panels}
    if platform != "cpu":
        want["phase_sweeps_gpu"] = 1
    for rank, rep in enumerate(reports):
        got = {name: rep[name] for name in COUNTED}
        check(got == want, f"auto {label}: rank {rank} launched {got}, expected {want}")
    check(launches == {name: world * count for name, count in want.items()},
          f"auto {label}: the parent's counts {launches}")
    got = outputs_to_numpy(out)
    check(got.nbr_idx.shape == (n, params.num_neighbors), f"auto {label}: nbr_idx shape")
    check(np.isfinite(got.dipcn[got.dipcn_valid]).all(), f"auto {label}: non-finite dipCN")
    check(got.z.dtype == got.nbr_sq_dists.dtype == host_dtype(dtype),
          f"auto {label}: outputs not in {dtype}")
    spans = {key: statistics.mean(rep[key] for rep in reports)
             for key in reports[0] if key.startswith(("sharded.", "auto."))}
    print(f"[auto] {label}: auto_sharded_cohort_step over {world} rank(s) in {dtype}, transport "
          f"{transport}: {wall:.2f} s for the call (host clock: spawn, the ranks' start on the "
          f"card, the step and the copies; {max(rep['start_seconds'] for rep in reports):.2f} s "
          f"from the spawn to the last rank's start), "
          f"{statistics.mean(rep['seconds'] for rep in reports):.3f} s for the step in the ranks "
          f"(mean; " + ", ".join(f"{key} {sec:.3f} s" for key, sec in spans.items())
          + f"); peak device memory per rank "
          f"{', '.join('%.3f' % (rep['peak_bytes'] / 2**30) for rep in reports)} GiB; launches "
          f"per rank {want}; {world} rank(s) on one card; {card}", flush=True)
    return got, reports, wall


def auto_phase(dev, card: str, cohort_16384, cohort_65536, ring: dict,
               platform: str = "cuda") -> dict:
    """Phase 16 (a, b): the gather form of the sharded step. (a) At phase
    8's N=16,384 over 1 (NCCL) and 4 (gloo) ranks, held to phase 8's
    flat step (z and the column statistics within 1e-5 of their largest
    entry, region_used equal, lists and dipCN under the tie rule) and,
    bitwise, to the flat panel loop run here on the step's own z; at W=4
    the split the step gathered is bitwise the split of the whole z. (b)
    N=65,536 over 4 ranks, held to phase 7's flat step, with each rank's
    spans and peak memory beside phase 15 (c)'s ring and phase 7's flat
    step. Returns the launches per rank for the JSON line."""
    from grid_tpu_torch.models.cohort import CohortParams, _panel_knn_dipcn
    from grid_tpu_torch.ops.gpu_kernels import zprep_split
    from torch_parity import assert_close_to_max

    t_phase = time.perf_counter()
    params = CohortParams(num_neighbors=K, n_nbr=N_NBR, n_iters=N_ITERS, quantize=False)
    flat = cohort_16384.flat
    n, r = cohort_16384.values.shape
    usable = flat.z_mask.any(axis=1)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="grid_tpu_torch_keep_") as keep_dir:
        for world in AUTO_WORLDS:
            label = f"N={n} R={r} k={K}, W={world}"
            got, reports, wall = auto_run(label, world, cohort_16384, params, card, platform,
                                          keep_dir if world == 4 else None)
            z_err = assert_close_to_max(got.z, flat.z, 1e-5)
            stat_err = max(assert_close_to_max(got.col_means, flat.col_means, 1e-5),
                           assert_close_to_max(got.col_vars, flat.col_vars, 1e-5))
            check(np.array_equal(got.region_used, flat.region_used),
                  f"auto {label}: region_used")
            summary = check_against(got, flat, usable, N_NBR, f"auto {label} vs the flat step")
            # the flat panel loop, here, on the step's own z: bitwise
            z, z_mask, region = (torch.tensor(a, device=dev) for a in (got.z, got.z_mask,
                                                                      got.region_used))
            sample_ok = z_mask.any(dim=1)
            w = torch.tensor(cohort_16384.reads, dtype=torch.float32, device=dev) / torch.tensor(
                got.scales, device=dev)
            d, idx, dip, ok = (t.cpu().numpy() for t in _panel_knn_dipcn(
                z, z_mask, region, sample_ok, w, sample_ok, params))
            check(np.array_equal(got.nbr_idx, idx) and np.array_equal(got.nbr_sq_dists, d),
                  f"auto {label}: the lists are not bitwise the flat panel loop's on the step's z")
            check(np.array_equal(got.dipcn_valid, ok) and np.array_equal(got.dipcn[ok], dip[ok]),
                  f"auto {label}: dipCN is not bitwise the flat panel loop's on the step's z")
            print(f"[auto] {label} vs phase 8's flat step: z within 1e-5 of max|z| (max abs err "
                  f"{z_err:.3e}), column means and variances within 1e-5 (max abs err "
                  f"{stat_err:.3e}), region_used equal; {summary}. Lists, distances and dipCN "
                  f"bitwise equal to the flat panel loop run here on the step's own z",
                  flush=True)
            if world == 4:  # the split the step gathered against the whole z's
                kept = torch.load(Path(keep_dir) / "split.pt")
                whole = zprep_split(z, z_mask, region, ZMAX)
                check(torch.equal(kept["p"], whole.p.cpu())
                      and torch.equal(kept["norms"], whole.norms.cpu()),
                      f"auto {label}: the gathered split is not bitwise zprep_split of the "
                      f"whole z")
                print(f"[auto] {label}: the split the step gathered (the halves "
                      f"{list(kept['p'].shape)} and the norms, saved by rank 0 after its step, "
                      f"so rank 0's step seconds above include the save) is bitwise "
                      f"zprep_split of the whole returned z", flush=True)
                del kept, whole
            del z, z_mask, region, w
            runs[world] = (got, reports, wall)
    torch.cuda.empty_cache()

    # ---- (b) the biobank width over 4 ranks -------------------------------
    n65, r65 = cohort_65536.values.shape
    label = f"N={n65} R={r65} k={K}, W={AUTO_BIOBANK_WORLD}"
    got65, reports65, wall65 = auto_run(label, AUTO_BIOBANK_WORLD, cohort_65536, params, card,
                                        platform)
    flat65 = cohort_65536.flat
    summary = check_against(got65, flat65, flat65.z_mask.any(axis=1), N_NBR,
                            f"auto {label} vs phase 7")
    step_s = statistics.mean(rep["seconds"] for rep in reports65)
    ring_s = statistics.mean(ring["rank_seconds_65536_w4"])
    split_gib = 2 * n65 * r65 * 4 / 2**30
    print(f"[auto] {label} vs phase 7's flat (panel-branch) step: {summary}", flush=True)
    print(f"[auto] {label}: the call {wall65:.2f} s (host clock); the step in the ranks "
          f"{step_s * 1e3:.1f} ms (mean of the ranks, host clock), beside this run's ring "
          f"{ring_s * 1e3:.1f} ms (phase 15 (c), mean of its ranks) and the flat panel "
          f"step's {cohort_65536.step_ms:.1f} ms (phase 7); the gathered split is "
          f"{split_gib:.3f} GiB a rank, peak device memory per rank "
          f"{', '.join('%.3f' % (rep['peak_bytes'] / 2**30) for rep in reports65)} GiB; "
          f"{AUTO_BIOBANK_WORLD} ranks on one card say nothing of scaling across cards; {card}",
          flush=True)
    print(f"[auto] phase 16 (a, b) took {time.perf_counter() - t_phase:.1f} s (host clock)",
          flush=True)
    per_rank = lambda reports: {name: reports[0][name] for name in (  # noqa: E731
        "masked_column_stats", "zprep_split", "zprep_gram_panel", "dipcn_from_distances_gpu",
        "zprep_gram_cross", *SELECTION)}
    return {"launches_per_rank_16384_w4": per_rank(runs[4][1]),
            "launches_per_rank_65536_w4": per_rank(reports65),
            "peak_bytes_per_rank_65536_w4": [rep["peak_bytes"] for rep in reports65],
            "step_s_65536_w4": step_s, "seconds_65536_w4": wall65}


def load_stage(out: Path, prefix: str, world: int) -> dict:
    """The blocks ``tests/torch_ranks.py`` saved for ``world`` ranks, in rank
    order, with the stage's fields (checked equal on every rank)."""
    blocks = [np.load(out / f"{prefix}.rank{rank}.npz") for rank in range(world)]
    metas = [json.loads((out / f"{prefix}.rank{rank}.json").read_text()) for rank in range(world)]
    check(all(m | {"row0": 0} == metas[0] | {"row0": 0} for m in metas),
          f"{prefix}: the ranks' stage fields differ")
    return {"values": np.concatenate([x["values"] for x in blocks]),
            "mask": np.concatenate([x["mask"] for x in blocks]),
            "regions": blocks[0]["regions"], "sample_rows": blocks[0]["sample_rows"],
            "sample_ids": metas[0]["sample_ids"], "n": metas[0]["n"]}


def stage_phase(card: str, tmp: Path, cohort: dict, base: dict, k: int, n_nbr: int,
                platform: str = "cuda") -> None:
    """Phase 16 (c): the sharded stager on phase 9's cohort on disk (its
    repeat mask applied). ``staged_sharded_cohort_step`` over STAGE_WORLD
    ranks: the
    stage its ranks made equals the one-rank stage bitwise, and the step is
    held to ``sharded_cohort_step`` from the one-rank stage's host arrays
    (neighbor indices equal, dipCN rtol 1e-6); each rank's passes, host
    buffer and peak RSS are printed."""
    import grid_tpu_torch.parallel.pcohort as pcohort
    import torch_ranks
    from grid_tpu_torch.convert import outputs_to_numpy
    from grid_tpu_torch.io.bed import load_repeat_mask, map_bed_gz_to_samples
    from grid_tpu_torch.io.formats import read_counts_tsv
    from grid_tpu_torch.models.cohort import CohortParams
    from grid_tpu_torch.parallel import run_ranks, sharded_cohort_step, staged_sharded_cohort_step
    from grid_tpu_torch.parallel.mesh import RankWorkspace, block_rows

    t_phase = time.perf_counter()
    world = STAGE_WORLD
    norm_cfg = base["mosdepth"]["normalize"]
    lo, hi = norm_cfg["min_depth"], norm_cfg["max_depth"]
    excluded = load_repeat_mask(norm_cfg["repeat_mask_file"])
    work = base["mosdepth"]["work_dir"]
    found = map_bed_gz_to_samples(work, cohort["ids"])
    pairs = [(sid, str(found[sid])) for sid in sorted(found)]
    ids = [sid for sid, _ in pairs]
    n = len(pairs)
    b = block_rows(n, world)

    # ---- the one-rank stage: the reference, and the host arrays -----------
    ref_dir = tmp / "stage16_w1"
    ref_dir.mkdir()
    t0 = time.perf_counter()
    with RankWorkspace() as ws:
        got = run_ranks(torch_ranks.stage_rank, 1,
                        ([("files", [("files", pairs, excluded)], lo, hi, torch.float32)],
                         str(ref_dir)), platform=platform, workspace=ws)
    one_s = time.perf_counter() - t0
    one = load_stage(ref_dir, "files", 1)
    r = one["values"].shape[1]
    check(one["sample_ids"] == ids and one["n"] == n and one["values"].shape == (n, r)
          and np.array_equal(one["sample_rows"], np.arange(n)), "the one-rank stage's layout")

    # ---- the staged step over `world` ranks, keeping each rank's stage ------
    counts = read_counts_tsv(cohort["counts_file"])
    params = CohortParams(num_neighbors=k, n_nbr=n_nbr, n_iters=N_ITERS, quantize=False)
    hap = ring_neighbors(n)
    reports = []
    keep_dir = tmp / "stage16_kept"
    keep_dir.mkdir()
    with keeping(pcohort, "_rank_staged_step", torch_ranks.staged_rank_keeping_stage, keep_dir):
        t0 = time.perf_counter()
        stage, staged = staged_sharded_cohort_step(
            world, work, cohort["ids"], counts, *hap, params, lo, hi, excluded=excluded,
            platform=platform, dtype=torch.float32, reports=reports)
        staged_s = time.perf_counter() - t0
    staged = outputs_to_numpy(staged)
    many = load_stage(keep_dir, "stage", world)
    check(many["values"].shape == (b * world, r), f"the {world}-rank stage's shape")
    check(many["sample_ids"] == stage.sample_ids == ids and stage.n == n, "stage sample_ids")
    check(np.array_equal(many["regions"], one["regions"])
          and np.array_equal(stage.regions, one["regions"]), "stage regions")
    check(np.array_equal(many["sample_rows"], one["sample_rows"])
          and np.array_equal(stage.sample_rows, one["sample_rows"]), "stage sample_rows")
    check(np.array_equal(many["values"][:n], one["values"]) and not many["values"][n:].any(),
          f"the {world}-rank stage's values are not bitwise the one-rank stage's")
    check(np.array_equal(many["mask"][:n], one["mask"]) and not many["mask"][n:].any(),
          f"the {world}-rank stage's mask differs from the one-rank stage's")
    print(f"[stage] staged_sharded_cohort_step over {world} ranks on phase 9's {n} files: "
          f"the stage its ranks made, [{b * world}, {r}] in blocks of {b}, equals "
          f"stage_cohort_sharded in one rank (values bitwise, mask, regions, sample_ids, "
          f"sample_rows; that call {one_s:.2f} s, its stage {got[0]['seconds']:.2f} s, started "
          f"{got[0]['start_seconds']:.2f} s after the spawn); {card}", flush=True)

    # ---- the staged step against the step from the stage's host arrays ------
    reads = np.array([counts.get(sid, 0.0) for sid in ids])
    reads_valid = np.array([sid in counts for sid in ids])
    t0 = time.perf_counter()
    want = outputs_to_numpy(sharded_cohort_step(world, one["values"], one["mask"], reads,
                                                reads_valid, *hap, params, platform=platform,
                                                dtype=torch.float32))
    host_s = time.perf_counter() - t0
    check(np.array_equal(staged.nbr_idx[:n], want.nbr_idx[:n]),
          "staged step: neighbor indices differ from the step from host arrays")
    check(np.array_equal(staged.dipcn_valid[:n], want.dipcn_valid[:n])
          and np.allclose(staged.dipcn[:n], want.dipcn[:n], rtol=1e-6, atol=0, equal_nan=True),
          "staged step: dipCN beyond rtol 1e-6 of the step from host arrays")
    nr_bytes = n * r * 4
    for rank, rep in enumerate(reports):
        print(f"[stage] rank {rank}: pass 1 {rep['stage.pass1']:.3f} s (with the merge), pass 2 "
              f"{rep['stage.pass2']:.3f} s (with the copy to the card); host buffer "
              f"[{rep['rows_per']}, {rep['r']}] float32 + mask + row_valid "
              f"{rep['host_buffer_bytes'] / 2**20:.2f} MiB beside {nr_bytes / 2**20:.2f} MiB for "
              f"[N, R] float32; peak RSS {rep['peak_rss_bytes'] / 2**30:.3f} GiB "
              f"(getrusage: the process, torch and CUDA included), resident "
              f"{rep['rss_bytes'] / 2**30:.3f} GiB at the step's end; started "
              f"{rep['start_seconds']:.2f} s after the spawn; the step's spans "
              + ", ".join(f"{key} {rep[key]:.3f} s" for key in rep if key.startswith("sharded."))
              + f" (its normalize compiles Triton's column statistics: the parent cannot, "
              f"R being known only after pass 1); {card}", flush=True)
    print(f"[stage] staged_sharded_cohort_step over {world} ranks: {staged_s:.2f} s (host clock, "
          f"spawn included; sharded_cohort_step from the host arrays {host_s:.2f} s): neighbor "
          f"indices equal to the step from host arrays on all {n} rows, dipCN within rtol 1e-6; "
          f"phase 16 (c) took {time.perf_counter() - t_phase:.1f} s; {card}", flush=True)


# the hand kernels' device functions, as torch.profiler names them
OWN_KERNELS = ("split_kernel", "gram_kernel", "dipcn_select_kernel", "colstats",
               "knn_select_kernel", "phase_resident_kernel")  # K=10 at N=2504: one launch


def cache_phase(card: str, tmp: Path, cohort: dict, base: dict, names: dict,
                warm_t: dict, device: dict | None = None) -> None:
    """Phase 16 (d): ``python -m grid_tpu_torch.cli wgs`` on phase 9's fused
    config in subprocesses, with ``device.compilation_cache`` a fresh
    directory: a cold call (nvcc, g++ and Triton build into it) and a warm
    one with ``GRID_TPU_PROFILE_DIR`` set (no unprofiled warm call, a cut
    for the time limit: ``warm_t``, phase 9's in-process card run 2 on the
    same config, is its unprofiled twin). Fails unless the
    libraries and Triton's cache are in the directory, the warm call built
    nothing, build/grid_tpu_torch/ gained nothing, every outermost step
    wrote a trace, the fused step's names ``fused.device`` and the hand
    kernels' device events, and the profiled call's four artifacts equal
    the cold call's. ``device`` adds keys to the config's device section
    (``{"platform": "cpu"}`` rehearses the calls on the host)."""
    from grid_tpu_torch import native

    repo = Path(__file__).resolve().parent
    cache = tmp / "build_cache16"
    listing = lambda d: sorted(str(p.relative_to(d)) for p in d.rglob("*")) if d.exists() else []  # noqa: E731
    build_before = listing(native.BUILD_DIR)
    env = {key: val for key, val in os.environ.items()
           if key not in ("GRID_TPU_COMPILE_CACHE", "TRITON_CACHE_DIR", "GRID_TPU_PROFILE_DIR")}

    def call(label: str, profile_dir: Path | None = None):
        out = tmp / f"cache16_{label}"
        out.mkdir()
        cfg = copy.deepcopy(base)
        cfg["output_dir"] = str(out)
        cfg["device"] = {"fused": True, "compilation_cache": str(cache), **(device or {})}
        (out / "read_counts.tsv").write_bytes(cohort["counts_file"].read_bytes())
        cfg_path = out / "config.yaml"
        cfg_path.write_text(json.dumps(cfg))  # JSON is YAML
        call_env = dict(env, **({"GRID_TPU_PROFILE_DIR": str(profile_dir)} if profile_dir else {}))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "grid_tpu_torch.cli", "wgs", str(cfg_path)],
                              cwd=repo, env=call_env, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"cache call {label} failed:\n{proc.stdout[-2000:]}\n"
                                    f"{proc.stderr[-4000:]}")
        check(all((out / name).exists() for name in names.values()),
              f"cache call {label}: an artifact is missing:\n{proc.stdout[-2000:]}")
        timings = json.loads((out / "step_timings.json").read_text())
        return out, timings, wall

    _, cold_t, cold_s = call("cold")
    built = listing(cache)
    for prefix in ("libzprep_gram-", "libdipcn_select-", "libknn_select-", "libphase_sweeps-",
                   "libgridhost-"):
        check(any(name.startswith(prefix) and name.endswith(".so") for name in built),
              f"the build cache holds no {prefix}*.so: {built}")
    triton_files = [name for name in built if name.startswith("triton/")]
    check(len(triton_files) > 0, f"the build cache holds no Triton cache: {built}")
    traces = tmp / "traces16"
    prof_out, prof_t, prof_s = call("profiled", traces)
    check(listing(cache) == built, "the warm call built something")
    check(listing(native.BUILD_DIR) == build_before,
          "build/grid_tpu_torch/ changed during the calls with a build cache")
    outer = sorted(name for name in prof_t if "." not in name)
    check(sorted(p.name for p in traces.iterdir()) == outer,
          f"traces {sorted(p.name for p in traces.iterdir())} != outermost steps {outer}")
    for step in outer:
        check((traces / step / "trace.json").exists(), f"no trace.json for {step}")
    events = json.loads((traces / "fused_steps_4_7" / "trace.json").read_text())["traceEvents"]
    found = {e.get("name", "") for e in events}
    check("fused.device" in found, "the fused step's trace does not name fused.device")
    device_names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    for kernel in OWN_KERNELS:
        check(any(kernel in name for name in device_names),
              f"the fused step's trace has no device event of {kernel}")
    cold_out = tmp / "cache16_cold"
    for name in names.values():
        check(content(prof_out / name) == content(cold_out / name),
              f"the profiled call's {name} differs from the cold call's")
    trace_mb = sum(p.stat().st_size for p in traces.rglob("*.json")) / 2**20
    print(f"[cache] python -m grid_tpu_torch.cli wgs on phase 9's fused config, "
          f"device.compilation_cache a fresh directory: cold call {cold_s:.2f} s "
          f"(fused.device {cold_t['fused.device']:.3f} s; nvcc of zprep_gram, dipcn_select, "
          f"knn_select and phase_sweeps, "
          f"g++ of the host library and Triton's column statistics all built into the "
          f"directory, none seeded: {len(built)} files, {len(triton_files)} of them Triton's); "
          f"build/grid_tpu_torch/ unchanged; host clock, each call a process of its own; {card}",
          flush=True)
    print(f"[cache] warm call with GRID_TPU_PROFILE_DIR: {prof_s:.2f} s, nothing built "
          f"(fused.device {prof_t['fused.device']:.3f} s, fused_steps_4_7 "
          f"{prof_t['fused_steps_4_7']:.3f} s against {warm_t['fused_steps_4_7']:.3f} s "
          f"unprofiled in phase 9's card run 2); one trace.json for each of {outer} "
          f"({trace_mb:.1f} MiB in all); the fused step's names fused.device and device events of "
          f"{', '.join(OWN_KERNELS)}; the four artifacts equal the cold call's byte for byte "
          f"(decompressed); {card}", flush=True)


def fabricated_reads(cohort: dict, cfg: dict, read_len: int = 100) -> int:
    """The reads the fabrication wrote, from its own depth model (as
    ``synth._make_cohort`` draws them)."""
    bin_size, w0, w1 = cfg["mosdepth"]["bin_size"], 160_605_000, 160_615_000
    total = 0
    for dip, base in zip(cohort["dip_cn"], cohort["base_depth"]):
        for bs in range(cfg["start_bp"], cfg["end_bp"], bin_size):
            be = bs + bin_size
            depth = base * (dip / 2 if bs >= w0 and be <= w1 else 1.0)
            total += max(int(round(depth * bin_size / read_len)), 0)
    return total


def tsv_rows(path) -> tuple:
    """(header, sorted rows) of a counts or coverage TSV: rows are appended
    as samples finish."""
    lines = Path(path).read_text().splitlines()
    return lines[0], sorted(lines[1:])


def cramlite_route(path: str, chrom: str, start: int, end: int, flags, min_mapq: int,
                   bed: str, bin_size: int) -> tuple:
    """One CRAM through cramlite (the plain version of the native reader):
    its window count, then its binned depth and window coverage integer.
    Module level, so a spawned worker can run it."""
    from grid_tpu_torch.io import cramlite
    from grid_tpu_torch.steps.coverage import compute_region_coverage

    count = cramlite.count_reads_region(path, None, chrom, start, end, set(flags), min_mapq)
    cramlite.binned_depth(path, bed, bin_size)
    return count, compute_region_coverage(bed, chrom, start, end)


def same_steps_4_7(tag: str, a: Path, b: Path, names: dict, n: int, n_nbr: int) -> str:
    """Hold run ``b``'s four artifacts to run ``a``'s: equal after
    decompression, or under phase 9's rules (z and scales within one
    quantum, the cells apart counted and bounded; neighbor lists equal but
    for ties within one quantum of the written distances; dipCN within
    rtol 1e-5 where the input sets agree; haploid values within one
    quantum). Returns what it found."""
    from grid_tpu_torch.io.formats import read_dipcn, read_neighbors, read_normalized_data
    from torch_parity import dipcn_sets_differ, neighbor_rows_differing

    differ = [key for key, name in names.items() if content(a / name) != content(b / name)]
    if not differ:
        return "the four artifacts identical after decompression"
    ids, ratios, z, scales = read_normalized_data(a / names["normalized"])
    ids_b, ratios_b, z_b, scales_b = read_normalized_data(b / names["normalized"])
    check(ids == ids_b and z.shape == z_b.shape, f"{tag}: step 4 rows or shape differ")
    check(np.array_equal(np.isnan(z), np.isnan(z_b)), f"{tag}: step 4 NA cells differ")
    z_diff = np.nan_to_num(np.abs(z - z_b))
    s_diff = np.array([abs(scales[s] - scales_b[s]) for s in ids])
    check(z_diff.max() <= QUANTUM and s_diff.max() <= QUANTUM, f"{tag}: step 4 beyond a quantum")
    cells = int((~np.isnan(z)).sum())
    z_apart = int((z_diff > 1e-9).sum())
    check(z_apart <= cells // 500 and int((s_diff > 1e-9).sum()) <= n // 100,
          f"{tag}: too many step 4 cells one quantum apart")
    nbrs, _ = read_neighbors(a / names["neighbors"])
    nbrs_b, _ = read_neighbors(b / names["neighbors"])
    row = {s: i for i, s in enumerate(ids)}
    idx, idx_b = (np.array([[row[m] for m, _, _ in lists[s]] for s in ids])
                  for lists in (nbrs, nbrs_b))
    d, d_b = (np.array([[dist for _, _, dist in lists[s]] for s in ids])
              for lists in (nbrs, nbrs_b))
    rows_apart = neighbor_rows_differing(idx_b, d_b, idx, d, tol=QUANTUM)
    dip_ids, dip, _ = read_dipcn(a / names["dipcn"])
    dip_ids_b, dip_b, _ = read_dipcn(b / names["dipcn"])
    check(dip_ids == dip_ids_b, f"{tag}: dipCN rows differ")
    usable = np.array([s in set(dip_ids) for s in ids])
    sets = dipcn_sets_differ(idx_b, idx, usable, n_nbr)[[row[s] for s in dip_ids]]
    check(np.allclose(np.asarray(dip_b)[~sets], np.asarray(dip)[~sets], rtol=1e-5, atol=0),
          f"{tag}: dipCN beyond rtol 1e-5 where the input sets agree")
    return (f"{', '.join(differ)} differ: {z_apart} of {cells} z cells one quantum apart, "
            f"{rows_apart.size} neighbor rows differ only by ties within a quantum, dipCN "
            f"within rtol 1e-5 on {int((~sets).sum())} rows whose input sets agree")


def alignment_phase(card: str, wrappers: dict, n: int = ALIGN_N, cram_n: int = ALIGN_CRAM_N,
                    seq_n: int = ALIGN_SEQ_N, k: int = K, n_nbr: int = N_NBR) -> dict:
    """Phase 12: host steps 1-3 from BAM/CRAM files in front of steps 4-7
    (see the module docstring). Returns the kernels' launches of the fused
    and the file-mode call fed from the BAMs. main() passes no size: the
    size arguments let the phase be rehearsed small."""
    import os
    import shutil
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    import grid_tpu_torch.pipeline as pipeline
    import grid_tpu_torch.steps.fused as fused
    import grid_tpu_torch.steps.ingest as ingest
    from grid_tpu_torch import native_host
    from grid_tpu_torch.io.bed import load_repeat_mask, read_regions_bed_gz
    from grid_tpu_torch.io.formats import read_samples
    from grid_tpu_torch.io.staging import stage_cohort
    from grid_tpu_torch.models.cohort import CohortParams
    from grid_tpu_torch.ops.gpu_kernels import zprep_gram_panel, zprep_split
    from grid_tpu_torch.pipeline import run_wgs_pipeline
    from grid_tpu_torch.steps.count_reads import count_reads
    from grid_tpu_torch.steps.coverage import compute_mosdepth, mosdepth_available
    from grid_tpu_torch.synth import make_synthetic_cohort_with_alignments

    check(native_host.route() == "native", f"the host library did not load: {native_host.route()}")
    names = {"normalized": "mosdepth_results_normalized.tsv.gz",
             "neighbors": f"neighbor_coverage.zMax{ZMAX:.1f}.tsv.gz",
             "dipcn": "diploid_genotypes.tsv", "haploid": "haploid_genotypes.tsv"}
    counted = {**wrappers, "zprep_split": zprep_split, "zprep_gram_panel": zprep_gram_panel}
    n_panels = -(-n // CohortParams().row_block)
    fused_launches = {**PIPELINE_LAUNCHES, "zprep_split": 0, "zprep_gram_panel": 0}
    file_launches = {"masked_column_stats": 2, "zprep_gram": 0, "dipcn_from_distances_gpu": 0,
                     "zprep_split": 1, "zprep_gram_panel": n_panels}
    spans = ("fused.stage", "fused.device", "fused.phase", "fused.write")
    threads = os.cpu_count() or 1
    step_files = ("read_counts.tsv", "mosdepth_results.tsv")

    with tempfile.TemporaryDirectory(prefix="grid_tpu_torch_align_") as tmp:
        tmp = Path(tmp)
        # ---- (a) the 1000G-shaped cohort from BAM -----------------------
        t0 = time.perf_counter()
        cohort = make_synthetic_cohort_with_alignments(
            tmp / "bam", n_samples=n, seed=ALIGN_SEED, mean_depth=ALIGN_DEPTH)
        fab_s = time.perf_counter() - t0
        base = copy.deepcopy(cohort["config"])
        base["threads"] = threads
        base["mosdepth"]["neighbors"]["num_neighbors"] = min(k, n - 1)
        base["compute_diploid_genotypes"]["n_nbr"] = n_nbr
        base["compute_haploid_genotypes"].update(max_neighbors=10, n_iters=N_ITERS)
        n_reads = fabricated_reads(cohort, base)
        n_bins = (base["end_bp"] - base["start_bp"]) // base["mosdepth"]["bin_size"]
        print(f"[align] BAM cohort: {n} samples, {n_reads} reads ({n_reads / n:.0f} per sample, "
              f"100 bp, {n_bins} bins of 1 kb, seed {ALIGN_SEED}, mean_depth {ALIGN_DEPTH} "
              f"clipped to the fabrication's floor of 10), fabricated in {fab_s:.1f} s by up to "
              f"{threads} processes (host clock; stands in for the download); mosdepth on PATH: "
              f"{mosdepth_available()}; {threads} threads", flush=True)

        batch_calls = []
        real_batch, real_ingest_step = ingest.ingest_batch, pipeline.run_fused_ingest
        seen = {}

        def counting_batch(*args, **kwargs):
            batch_calls.append(kwargs.get("threads"))
            return real_batch(*args, **kwargs)

        def keep_staged(*args, **kwargs):
            seen["ingest"] = real_ingest_step(*args, **kwargs)
            return seen["ingest"]

        def keep_stage(*args, **kwargs):
            seen["stage"] = real_stage(*args, **kwargs)
            return seen["stage"]

        real_stage = fused._stage

        def run(label: str, device: dict, index_run, fallbacks_allowed: bool = False, **cfg_edits):
            """One run_wgs_pipeline call in its own output and work
            directories; returns (output dir, timings, launches, wall s)."""
            cfg = copy.deepcopy({**base, **cfg_edits})
            out = tmp / label
            cfg["output_dir"] = str(out)
            cfg["mosdepth"]["work_dir"] = str(out / "work")
            cfg["device"] = device
            cfg["index"]["run"] = index_run
            console = Recorder()
            for fn in counted.values():
                fn.launches = 0
            native_host.fallbacks.clear()
            batch_calls.clear()
            seen.clear()
            t0 = time.perf_counter()
            with patched(ingest, {"ingest_batch": counting_batch}), \
                    patched(pipeline, {"run_fused_ingest": keep_staged}), \
                    patched(fused, {"_stage": keep_stage}):
                timings = run_wgs_pipeline(console=console, config=cfg)
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in counted.items()}
            check(not console.styled("danger"), f"align {label}: {console.styled('danger')[:3]}")
            check(not [m for m in console.styled("warning") if "failed" in m or "loop" in m],
                  f"align {label}: {console.styled('warning')}")
            if not fallbacks_allowed:
                check(not native_host.fallbacks,
                      f"align {label}: fallbacks {dict(native_host.fallbacks)}")
            return out, timings, launches, wall

        # run 1: index.run true builds the .bai files (steps 2-7 off)
        off = {"run": False}
        mos_off = {**base["mosdepth"], "run": False,
                   "normalize": {**base["mosdepth"]["normalize"], "run": False},
                   "neighbors": {**base["mosdepth"]["neighbors"], "run": False}}
        _, t1, l1, _ = run("index", {}, True, count_reads={**base["count_reads"], "run": False},
                           mosdepth=mos_off,
                           compute_diploid_genotypes={**base["compute_diploid_genotypes"], **off},
                           compute_haploid_genotypes={**base["compute_haploid_genotypes"], **off})
        bais = sorted(Path(base["directory_loc"]).glob("*.bam.bai"))
        check(len(bais) == n and set(t1) == {"create_index"} and not any(l1.values()),
              f"align run 1: {len(bais)} .bai files, timings {sorted(t1)}")
        # run 2: the full wgs, the index check, the one-pass ingest, fused
        out2, t2, l2, wall2 = run("fused", {"fused": True}, False)
        staged = seen["ingest"][2]
        stage2 = seen["stage"]
        check(l2 == fused_launches, f"align run 2 launches {l2} != {fused_launches}")
        check(batch_calls == [threads], f"align run 2: no batch route ({batch_calls})")
        check("check_index" in t2 and "fused_ingest_2_3" in t2 and "fused_steps_4_7" in t2
              and "count_reads" not in t2, f"align run 2 timings {sorted(t2)}")
        status = (out2 / "index_file_results.tsv").read_text()
        check(status.count("\tHas index\n") == n, "align run 2: the check found an index missing")
        # run 3: file mode; run 4: the sequential steps 2-3, fused steps 4-7
        out3, t3, l3, wall3 = run("files", {}, False)
        check(l3 == file_launches, f"align run 3 launches {l3} != {file_launches}")
        check(batch_calls == [threads], f"align run 3: no batch route ({batch_calls})")
        # run 4: the sequential steps 2-3 (steps 4-7 off) on the first
        # seq_n samples
        seq_ids = cohort["ids"][:seq_n]
        (tmp / "seq_samples.txt").write_text("".join(f"{s}\n" for s in seq_ids))
        mos_23 = {**mos_off, "run": True}
        out4, t4, l4, wall4 = run(
            "sequential", {"fused_ingest": False}, False, samples_file=str(tmp / "seq_samples.txt"),
            mosdepth=mos_23,
            compute_diploid_genotypes={**base["compute_diploid_genotypes"], **off},
            compute_haploid_genotypes={**base["compute_haploid_genotypes"], **off})
        check(not any(l4.values()), f"align run 4 launched {l4}")
        check(set(t4) == {"check_index", "count_reads", "mosdepth"},
              f"align run 4 timings {sorted(t4)}")

        # ---- checks ----------------------------------------------------------
        in_seq = set(seq_ids)
        for name in step_files:
            header, rows2 = tsv_rows(out2 / name)
            check(len(rows2) == n and "Error" not in (out2 / name).read_text(),
                  f"align: {name} lacks rows")
            rows_seq = [r for r in rows2 if r.split("\t")[0] in in_seq]
            check(tsv_rows(out4 / name) == (header, rows_seq),
                  f"align: {name} differs between the one-pass and the sequential steps")
            check((out2 / name).read_bytes() == (out3 / name).read_bytes(),
                  f"align: {name} differs between two one-pass runs")
        beds = sorted(p.name for p in (out2 / "work").iterdir())
        seq_beds = sorted(p.name for p in (out4 / "work").iterdir())
        check(len(beds) == n and seq_beds == [b for b in beds if b.split("_")[0] in in_seq],
              "align: the bed.gz files differ in name or number")
        for bed in seq_beds:
            check(content(out2 / "work" / bed) == content(out4 / "work" / bed),
                  f"align: {bed} differs between the one-pass and the sequential steps")
        excluded = load_repeat_mask(base["mosdepth"]["normalize"]["repeat_mask_file"])
        chrom, start, end = base["chrom"], base["start_bp"], base["end_bp"]
        for sample, arrays in staged.items():
            again = read_regions_bed_gz(out2 / "work" / f"{sample}_SYN.regions.bed.gz", chrom,
                                        start, end, excluded)
            check(all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
                      for a, b in zip(arrays, again)), f"align: {sample}'s staged bins differ")
        ncfg = base["mosdepth"]["normalize"]
        reread = stage_cohort(out2 / "work", read_samples(base["samples_file"]), chrom, start,
                              end, excluded, ncfg["min_depth"], ncfg["max_depth"], threads, None)
        for field in ("regions", "values", "mask"):
            a, b = getattr(stage2, field), getattr(reread, field)
            check(a.dtype == b.dtype and a.tobytes() == b.tobytes(),
                  f"align: the staged {field} differ from the bed.gz files' re-read")
        check(list(stage2.sample_ids) == list(reread.sample_ids), "align: staged sample order")
        # run 5: steps 4-7 from run 2's written files (steps 1-3 off)
        files_in = copy.deepcopy(base)
        out5 = tmp / "from_files"
        out5.mkdir()
        shutil.copy(out2 / "read_counts.tsv", out5 / "read_counts.tsv")
        files_in.update(output_dir=str(out5), device={"fused": True})
        files_in["index"]["run"] = None
        files_in["count_reads"]["run"] = False
        files_in["mosdepth"]["run"] = False
        files_in["mosdepth"]["work_dir"] = str(out2 / "work")
        for fn in counted.values():
            fn.launches = 0
        t5 = run_wgs_pipeline(console=None, config=files_in)
        check({name: fn.launches for name, fn in counted.items()} == fused_launches,
              "align run 5 launches")
        found = same_steps_4_7("align run 5 vs 2", out2, out5, names, n, n_nbr)
        print(f"[align] checks: counts and coverage TSVs byte-identical between the two one-pass "
              f"runs (2, 3), and on the first {seq_n} samples equal to the sequential steps' (run "
              f"4; rows in completion order, compared sorted); those {len(seq_beds)} bed.gz files "
              f"equal after decompression; the staged bins of "
              f"{len(staged)} samples and _stage's regions, values and mask bitwise equal to the "
              f"bed.gz files' re-read; steps 4-7 from those files (steps 1-3 off) vs run 2: "
              f"{found}", flush=True)

        # the read counts follow the fabricated truth
        counts = {s: float(c) for s, c in (line.split("\t") for line in tsv_rows(
            out2 / "read_counts.tsv")[1])}
        truth = {s: d * b for s, d, b in zip(cohort["ids"], cohort["dip_cn"], cohort["base_depth"])}
        corr = float(np.corrcoef([counts[s] for s in cohort["ids"]],
                                 [truth[s] for s in cohort["ids"]])[0, 1])
        check(corr >= ALIGN_MIN_CORR, f"align: read counts vs dip_cn x base_depth r={corr:.4f}")
        dips = np.asarray([float(line.split("\t")[1]) for line in
                           (out2 / names["dipcn"]).read_text().splitlines()[1:]])
        print(f"[align] read counts vs the fabricated dip_cn x base_depth: Pearson r = {corr:.4f} "
              f"(bound {ALIGN_MIN_CORR}); written dipCN median {np.median(dips):.3f}, range "
              f"{dips.min():.3f}-{dips.max():.3f} (this cohort's dipCN sits near 1 by design)",
              flush=True)

        # ---- times ---------------------------------------------------------
        for label, t, wall, launch in (("run 2, fused, one pass", t2, wall2, l2),
                                       ("run 3, file mode, one pass", t3, wall3, l3),
                                       (f"run 4, sequential steps 2-3 alone, {seq_n} samples",
                                        t4, wall4, l4)):
            device_s = t.get("fused.device", 0) + t.get("fused.phase", 0) + sum(
                t.get(s, 0) for s in FILE_DEVICE_SPANS)
            parts = ", ".join(f"{key} {value:.3f} s" for key, value in t.items())
            print(f"[align] {label}: {parts}; whole run_wgs_pipeline {wall:.3f} s (host clock); "
                  f"host share (all but the device spans) {100 * (1 - device_s / wall):.2f}%; "
                  f"launches {launch}; {card}", flush=True)
        print(f"[align] run 1 create_index {t1['create_index']:.3f} s for {n} .bai files; "
              f"{card}", flush=True)
        rates = {}
        for n_threads in sorted({1, threads}):
            cfg = copy.deepcopy(base)
            cfg.update(threads=n_threads, output_dir=str(tmp / f"rate{n_threads}"))
            cfg["mosdepth"]["work_dir"] = str(tmp / f"rate{n_threads}" / "work")
            native_host.fallbacks.clear()
            t0 = time.perf_counter()
            ingest.run_fused_ingest(cfg, None)
            rates[n_threads] = time.perf_counter() - t0
            check(not native_host.fallbacks, f"align rate run: {dict(native_host.fallbacks)}")
        print("[align] one-pass ingest alone (run_fused_ingest, batch route, host clock): "
              + "; ".join(f"{t} thread(s) {s:.3f} s = {n / s:.0f} samples/s, {n_reads / s:.0f} "
                          f"reads/s" for t, s in rates.items()) + f"; {card}", flush=True)

        # ---- (b) the CRAM route at N=cram_n --------------------------------
        crams = {}
        for ft in ("bam", "cram"):
            t0 = time.perf_counter()
            crams[ft] = make_synthetic_cohort_with_alignments(
                tmp / f"c_{ft}", n_samples=cram_n, seed=ALIGN_SEED, mean_depth=ALIGN_DEPTH,
                file_type=ft, indel_frac=0.1)
            print(f"[align] {cram_n}-sample {ft.upper()} cohort (indel_frac 0.1) fabricated in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        routes = {}
        for label, ft in (("bam", "bam"), ("native_cram", "cram")):
            cfg = copy.deepcopy(crams[ft]["config"])
            cfg.update(threads=threads, output_dir=str(tmp / f"r_{label}"))
            cfg["mosdepth"]["work_dir"] = str(tmp / f"r_{label}" / "work")
            native_host.fallbacks.clear()
            batch_calls.clear()
            t0 = time.perf_counter()
            with patched(ingest, {"ingest_batch": counting_batch}):
                counts_path, coverage_path, _ = ingest.run_fused_ingest(cfg, None)
            t_route = time.perf_counter() - t0
            check(not native_host.fallbacks and batch_calls == [threads],
                  f"align {label}: fallbacks {dict(native_host.fallbacks)}, batch {batch_calls}")
            work = sorted((tmp / f"r_{label}" / "work").iterdir())
            routes[label] = (tsv_rows(counts_path), tsv_rows(coverage_path),
                             {p.name: content(p) for p in work}, t_route)
        # cramlite, the plain version: the same count and coverage per file,
        # in spawned processes (pure Python: the interpreter lock would
        # serialise threads)
        cfg = crams["cram"]["config"]
        paths = sorted(Path(cfg["directory_loc"]).glob("*.cram"))
        (tmp / "r_cramlite").mkdir()
        t0 = time.perf_counter()
        with ProcessPoolExecutor(threads, mp_context=multiprocessing.get_context("spawn")) as pool:
            futures = [pool.submit(cramlite_route, str(p), cfg["chrom"], cfg["start_bp"],
                                   cfg["end_bp"], cfg["count_reads"]["flags"], 1,
                                   str(tmp / "r_cramlite" / f"{p.stem}_SYN.regions.bed.gz"), 1000)
                       for p in paths]
            lite = [f.result() for f in futures]
        t_lite = time.perf_counter() - t0
        header = routes["native_cram"][0][0]
        lite_counts = (header, sorted(f"{p.stem}\t{c}" for p, (c, _) in zip(paths, lite)))
        lite_cov = (header, sorted(f"{p.stem}\t{v}" for p, (_, v) in zip(paths, lite)))
        lite_beds = {p.name: content(p) for p in sorted((tmp / "r_cramlite").iterdir())}
        for label in ("bam", "native_cram"):
            check(routes[label][0] == lite_counts, f"align CRAM: {label} counts != cramlite's")
            check(routes[label][1] == lite_cov, f"align CRAM: {label} coverage != cramlite's")
        check(routes["native_cram"][2] == lite_beds == routes["bam"][2],
              "align CRAM: the bed.gz files differ between the routes")
        print(f"[align] CRAM route, {cram_n} samples: counts, coverage and {len(lite_beds)} bed.gz "
              f"files equal between the native CRAM reader, cramlite (forced) and the BAMs; the "
              f"one-pass ingest on {threads} threads: native CRAM "
              f"{routes['native_cram'][3]:.3f} s, "
              f"BAM {routes['bam'][3]:.3f} s; cramlite count + binned depth + coverage "
              f"{t_lite:.3f} s in {threads} processes (host clock); {card}", flush=True)
    check(not tmp.exists(), "the temporary directory was not removed")
    return {"fused": {name: l2[name] for name in counted},
            "files": {name: l3[name] for name in counted}}


def rebuild_from_files(tag: str, out, names: dict, ids, ratios, z, scales: dict, ibs_file, k: int,
                       n_nbr: int, fused: bool):
    """Steps 5-7 rebuilt on the CPU by the plain route from one run's own
    written files (its normalized matrix: ``ids``, ``ratios``, ``z``,
    ``scales``; its read counts; its dipCN table), and that run's neighbor,
    dipCN and haploid files held to them: each neighbor row, with its
    columns' distances taken from the rebuilt d2, equals the rebuilt list
    except ties within TIE_RTOL of the row's k-th distance; the written
    distances are those at %.2f; dipCN within rtol 1e-5 on rows whose input
    sets agree, the dipCN rows exactly the valid ones; the haploid table
    within %.2f rounding of N_ITERS plain sweeps over the written dipCN.
    ``fused`` names the step that wrote the lists: the fused step keeps rows
    without a valid cell out of every list and their reads out of every
    mean; the file-mode step (``steps/neighbors.py``) sees every written row.
    Returns the rebuilt and the read arrays in a namespace."""
    from grid_tpu_torch.io.formats import read_counts_tsv, read_dipcn, read_neighbors
    from grid_tpu_torch.io.hap_neighbors import load_ibs_neighbors, pad_hap_neighbors
    from grid_tpu_torch.ops.knn import d2_matrix, region_filter_mask, sorted_smallest_k
    from grid_tpu_torch.ops.phasing import compute_imputed, phase_haplotypes
    from grid_tpu_torch.ops.select import dipcn_from_distances
    from torch_parity import dipcn_sets_differ, neighbor_rows_differing

    n = len(ids)
    t0 = time.perf_counter()
    zt = torch.tensor(np.nan_to_num(z), dtype=torch.float32)
    zmask = torch.tensor(~np.isnan(z))
    region = region_filter_mask(torch.tensor(ratios, dtype=torch.float32), 1.0, 1000.0,
                                n_written=len(ratios))
    r_use = max(int(region.sum()), 1)
    sample_ok = zmask.any(dim=1)
    d2 = d2_matrix(zt, zmask, region, ZMAX, row_valid=sample_ok if fused else None)
    want_d, want_idx = (t.numpy() for t in sorted_smallest_k(d2, k))
    row_of = {sid: i for i, sid in enumerate(ids)}
    nbrs, own_scales = read_neighbors(out / names["neighbors"])
    check(list(nbrs) == ids and all(len(nbrs[s]) == k for s in ids),
          f"{tag} step 5: the neighbor file's rows or widths")
    check(own_scales == scales, f"{tag} step 5: scales differ from the normalized file's")
    got_idx = np.array([[row_of[nid] for nid, _, _ in nbrs[s]] for s in ids])
    written = np.array([[dist for _, _, dist in nbrs[s]] for s in ids])
    nbr_scale_ok = all(ns == scales[nid] for s in ids for nid, ns, _ in nbrs[s])
    check(nbr_scale_ok, f"{tag} step 5: a neighbor's scale is not that neighbor's")
    d2_np = d2.numpy()  # returned for the checks that follow
    got_d = d2_np[np.arange(n)[:, None], got_idx]
    tol = TIE_RTOL * want_d[:, -1].astype(np.float64)
    differ = neighbor_rows_differing(got_idx, got_d, want_idx, want_d, tol=tol)
    dist_err = np.abs(written - want_d.astype(np.float64) / (2 * r_use))
    dist_tol = 0.005 + 1e-6 + tol[:, None] / (2 * r_use)
    check((dist_err <= dist_tol).all(), f"{tag} step 5: a written distance is off by "
                                        f"{float((dist_err - dist_tol).max()):.3e} beyond %.2f")
    print(f"[{tag}] step 5, the card's neighbor file vs the plain route on the card's own "
          f"written z (r_use {r_use}): {n} rows compared, {n - differ.size} identical, "
          f"{differ.size} differ only by ties within {TIE_RTOL:g} of the row's k-th distance; "
          f"written distances equal d2/(2 r_use) at %.2f (max off {float(dist_err.max()):.4f})",
          flush=True)

    reads_map = read_counts_tsv(out / "read_counts.tsv")
    reads = torch.tensor([reads_map.get(s, float("nan")) for s in ids], dtype=torch.float32)
    usable = torch.tensor([s in reads_map for s in ids])
    if fused:
        usable &= sample_ok
    w = reads / torch.tensor([scales[s] for s in ids], dtype=torch.float32)
    want_dip, want_ok = (t.numpy() for t in dipcn_from_distances(d2, w, w, usable, usable,
                                                                 k=k, n_nbr=n_nbr))
    del d2
    dip_ids, dip_vals, _ = read_dipcn(out / names["dipcn"])
    check(dip_ids == [s for s, ok in zip(ids, want_ok) if ok], f"{tag} step 6: dipCN rows")
    sets_differ = dipcn_sets_differ(got_idx, want_idx, usable.numpy(), n_nbr)[want_ok]
    dip_vals = np.asarray(dip_vals)
    check(np.isfinite(dip_vals).all(), f"{tag} step 6: non-finite dipCN")
    check(np.allclose(dip_vals[~sets_differ], want_dip[want_ok][~sets_differ], rtol=1e-5, atol=0),
          f"{tag} step 6: dipCN differs beyond rtol 1e-5")
    print(f"[{tag}] step 6: {len(dip_ids)} dipCN rows, the plain route's valid rows; within "
          f"rtol 1e-5 on the {int((~sets_differ).sum())} rows whose input sets agree "
          f"({int(sets_differ.sum())} rows change a set by ties)", flush=True)

    # ---- step 7 rebuilt from the card's own dipCN --------------------
    hap_nbrs = load_ibs_neighbors(ibs_file, {s: i for i, s in enumerate(dip_ids)}, 10)
    hi, hw, hv = (torch.tensor(a) for a in pad_hap_neighbors(hap_nbrs, 10))
    res = phase_haplotypes(torch.tensor(dip_vals, dtype=torch.float32), hi, hw, hv, 1, N_ITERS)
    imp = compute_imputed(res.hap_irrs, hi, hw, hv, res.mean_irrs).numpy()
    hap = res.hap_irrs.numpy()
    want_hap = np.stack([dip_vals, hap[0::2], hap[1::2], imp[0::2], imp[1::2]], axis=1)
    lines = (out / names["haploid"]).read_text().splitlines()
    check(lines[0].split("\t")[0] == "ID" and [ln.split("\t")[0] for ln in lines[1:]] == dip_ids,
          f"{tag} step 7: haploid rows")
    got_hap = np.array([[float(v) for v in ln.split("\t")[1:]] for ln in lines[1:]])
    check(np.array_equal(np.isnan(got_hap), np.isnan(want_hap)), f"{tag} step 7: NaN cells")
    hap_err = np.nan_to_num(np.abs(got_hap - want_hap))
    check(hap_err.max() <= QUANTUM / 2 + 1e-4, f"{tag} step 7: off by {hap_err.max()}")
    print(f"[{tag}] step 7: {len(dip_ids)} haploid rows, {int(res.phased.sum())} phased; every "
          f"value within %.2f rounding of {N_ITERS} plain sweeps over the card's dipCN (max off "
          f"{float(hap_err.max()):.4f}); comparisons took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return SimpleNamespace(row_of=row_of, idx=got_idx, d=got_d, written=written, d2=d2_np,
                           usable=usable.numpy(), ok=want_ok, dip_ids=dip_ids, dip_vals=dip_vals,
                           d2_kth=want_d[:, -1])


def files_phase(card: str, counted: dict, tmp: Path, cohort: dict, base: dict, names: dict,
                fused, k: int, n_nbr: int) -> dict:
    """Phase 10: the pipeline in file mode on phase 9's cohort (see the
    module docstring). ``fused`` holds phase 9's resident card run: its
    output directory, warm timings, sample IDs, scales and the plain route
    rebuilt from its files. Returns the launches of the file-mode call."""
    import grid_tpu_torch.io.bed as port_bed
    from grid_tpu_torch.config import apply_defaults
    from grid_tpu_torch.models.cohort import CohortParams
    from grid_tpu_torch.pipeline import run_wgs_pipeline
    from grid_tpu_torch.io.formats import read_normalized_data
    from torch_parity import dipcn_sets_differ, neighbor_rows_differing

    n = len(fused.ids)
    out = tmp / "files"
    out.mkdir()
    (out / "read_counts.tsv").write_bytes(cohort["counts_file"].read_bytes())
    cfg = copy.deepcopy(base)
    cfg.pop("device", None)  # the repo's default: no fused path, no platform named
    cfg["output_dir"] = str(out)
    cfg = apply_defaults(cfg)  # every key set: validation has nothing to warn of

    def run(config, label):
        console = Recorder()
        for fn in counted.values():
            fn.launches = 0
        port_bed.native_fallbacks = 0
        timings = run_wgs_pipeline(console=console, config=config)
        launches = {name: fn.launches for name, fn in counted.items()}
        check(not console.failures(), f"files, {label}: logged {console.failures()[:3]}")
        check(port_bed.native_fallbacks == 0,
              f"files, {label}: {port_bed.native_fallbacks} bed.gz files fell back to Python")
        check(json.loads((out / "step_timings.json").read_text()) == timings,
              f"files, {label}: step_timings.json differs from the returned timings")
        check("fused_steps_4_7" not in timings, f"files, {label}: the fused step ran")
        return timings, launches, console

    t, launches, _ = run(cfg, "run 1")
    want = {"masked_column_stats": 2, "zprep_gram": 0, "dipcn_from_distances_gpu": 0,
            "zprep_split": 1, "zprep_gram_panel": -(-n // CohortParams().row_block)}
    print(f"[files] run_wgs_pipeline with the default config (device.fused unset, no platform "
          f"named), native host route: kernel launches {launches}, expected {want}; no line "
          f"logged at danger or warning; 0 bed.gz files fell back", flush=True)
    check(launches == want, f"file-mode launches {launches} != {want}")
    # the cohort's config has index.run: false, so step 1 checks the (absent)
    # alignment indexes first, as grid_tpu does
    check(set(t) == set(FILE_STEPS) | set(FILE_SPANS) | {"check_index"},
          f"file-mode timings {sorted(t)}")
    total = sum(t[name] for name in FILE_STEPS)
    device_s = sum(t[name] for name in FILE_DEVICE_SPANS)
    print(f"[files] steps (host clock): " + ", ".join(f"{name} {t[name]:.3f} s" for name in FILE_STEPS)
          + f", {total:.3f} s in all; spans: " + ", ".join(f"{name} {t[name]:.3f} s"
                                                         for name in FILE_SPANS)
          + f"; host share (all but {', '.join(FILE_DEVICE_SPANS)}) {100 * (1 - device_s / total):.2f}%"
          f" vs the fused run's {100 * fused.host_share:.2f}% of fused_steps_4_7 "
          f"{fused.t['fused_steps_4_7']:.3f} s (card run 2); {card}", flush=True)
    host_readers = t["neighbors.read"] + t["dipcn.read"] + t["dipcn.stage"]
    print(f"[files] the reference's Python readers: read_normalized_data {t['neighbors.read']:.3f} "
          f"s, read_counts_tsv + read_neighbors {t['dipcn.read']:.3f} s, step 6's N*k dict "
          f"lookups {t['dipcn.stage']:.3f} s: {host_readers:.3f} s, "
          f"{100 * host_readers / total:.1f}% of steps 4-7; {card}", flush=True)

    # ---- step 4 against phase 9's fused card run ---------------------------
    ids, ratios, z, scales = read_normalized_data(out / names["normalized"])
    if content(out / names["normalized"]) == content(fused.out / names["normalized"]):
        print("[files] step 4: the normalized file equals the fused card run's after "
              "decompression", flush=True)
    else:
        check(ids == fused.ids, "files step 4: sample IDs differ from the fused run's")
        check(z.shape == fused.z.shape and np.array_equal(np.isnan(z), np.isnan(fused.z)),
              "files step 4: shape or NA cells differ from the fused run's")
        check(np.array_equal(ratios, fused.ratios, equal_nan=True),
              "files step 4: variance ratios differ from the fused run's")
        z_diff = np.nan_to_num(np.abs(z - fused.z))
        s_diff = np.abs(np.array([scales[s] - fused.scales[s] for s in ids]))
        check(max(z_diff.max(), s_diff.max()) <= QUANTUM,
              f"files step 4: a cell differs from the fused run's by {max(z_diff.max(), s_diff.max())}")
        cells = int((~np.isnan(z)).sum())
        z_apart, s_apart = int((z_diff > 1e-9).sum()), int((s_diff > 1e-9).sum())
        check(z_apart <= cells // 500 and s_apart <= n // 100,
              "files step 4: too many cells one quantum from the fused run's")
        print(f"[files] step 4: the normalized file differs from the fused card run's in "
              f"{z_apart} of {cells} z cells and {s_apart} of {n} scales, each one %.2f quantum "
              f"apart (the fused step rounds z to 0.01 in float32 before writing), the same NA "
              f"cells and variance ratios", flush=True)

    # ---- steps 5-7 against the plain route from the run's own files --------
    own = rebuild_from_files("files", out, names, ids, ratios, z, scales, cohort["ibs_file"], k,
                             n_nbr, fused=False)

    # ---- steps 5-6 against the fused run ------------------------------------
    # both lists' distances from this run's rebuilt d2; a row's tolerance
    # grows by twice the most its distances moved between the two runs' z
    big = np.finfo(np.float32).max
    both = (own.d2 < big) & (fused.own.d2 < big)
    moved = np.where(both, np.abs(own.d2.astype(np.float64) - fused.own.d2), 0).max(axis=1)
    tol = TIE_RTOL * own.d2_kth.astype(np.float64) + 2 * moved
    rows = np.arange(n)[:, None]
    differ = neighbor_rows_differing(own.idx, own.d, fused.own.idx, own.d2[rows, fused.own.idx],
                                     tol=tol)
    check(own.dip_ids == fused.own.dip_ids, "files step 6: dipCN rows differ from the fused run's")
    same_scale = np.array([scales[s] == fused.scales[s] for s in ids])
    u = own.usable[own.idx]
    prefix = u & (np.cumsum(u, axis=1) <= n_nbr)
    comparable = (~dipcn_sets_differ(own.idx, fused.own.idx, own.usable, n_nbr) & same_scale
                  & (same_scale[own.idx] | ~prefix).all(axis=1))[own.ok]
    check(np.allclose(own.dip_vals[comparable], fused.own.dip_vals[comparable], rtol=1e-5, atol=0),
          "files step 6: dipCN differs from the fused run's beyond rtol 1e-5")
    print(f"[files] vs the fused card run: neighbor rows identical on {n - differ.size} of {n}, the "
          f"others differ only by ties (within {TIE_RTOL:g} of the k-th distance plus twice the "
          f"row's largest distance change between the two runs' z, at most "
          f"{float(moved.max()):.3e}); {len(own.dip_ids)} dipCN rows, the same; within rtol 1e-5 "
          f"on the {int(comparable.sum())} rows whose input sets and scales agree; {card}",
          flush=True)

    # ---- the second run: exact phasing and the bootstrap, steps 4-6 resumed -
    jacobi = (out / names["haploid"]).read_text().splitlines()
    cfg2 = copy.deepcopy(cfg)
    cfg2["resume"] = True
    cfg2["device"]["exact_phasing"] = True
    cfg2["compute_haploid_genotypes"]["bootstrap_replicates"] = BOOT_REPLICATES
    t2, launches2, console2 = run(cfg2, "run 2")
    skipped = [msg for msg, _ in console2.lines if msg.endswith("skipped (resume)")]
    check(skipped == [f"[{name}] up-to-date, skipped (resume)" for name in FILE_STEPS[:3]],
          f"files run 2: resumed {skipped}")
    check(not any(launches2.values()), f"files run 2 launched a kernel: {launches2}")
    exact = (out / names["haploid"]).read_text().splitlines()
    check(exact[0] == jacobi[0] and [ln.split("\t")[0] for ln in exact] ==
          [ln.split("\t")[0] for ln in jacobi], "files run 2: haploid rows differ from run 1's")
    ex = np.array([[float(v) for v in ln.split("\t")[1:]] for ln in exact[1:]])
    jac = np.array([[float(v) for v in ln.split("\t")[1:]] for ln in jacobi[1:]])
    check(np.array_equal(np.isfinite(ex), np.isfinite(jac)),
          "files run 2: the exact run's finite cells are not the Jacobi run's")
    boot_path = out / names["haploid"].replace(".tsv", "_bootstrap.tsv")
    boot = boot_path.read_text().splitlines()
    check(boot[0] == "ID\thap1_mean\thap1_sd\thap2_mean\thap2_sd"
          and [ln.split("\t")[0] for ln in boot[1:]] == [ln.split("\t")[0] for ln in exact[1:]],
          "files run 2: bootstrap table rows")
    bv = np.array([[float(v) for v in ln.split("\t")[1:]] for ln in boot[1:]])
    phased = np.isfinite(jac[:, 1])
    check(np.isfinite(bv[phased]).all() and (bv[phased][:, [1, 3]] >= 0).all(),
          "files run 2: bootstrap means or deviations not finite on phased rows")
    fin = np.isfinite(ex)
    print(f"[files] run 2 (exact_phasing, {BOOT_REPLICATES} bootstrap replicates, resume: steps "
          f"4-6 skipped, no kernel launched): haploid.phase (host Gauss-Seidel) "
          f"{t2['haploid.phase']:.3f} s, haploid.bootstrap {t2['haploid.bootstrap']:.3f} s, "
          f"compute_haploid_genotypes {t2['compute_haploid_genotypes']:.3f} s (host clock); "
          f"{len(exact) - 1} rows, finite where the Jacobi run's are, the exact and Jacobi tables "
          f"at most {float(np.abs(ex[fin] - jac[fin]).max()):.2f} apart; bootstrap table "
          f"{len(boot) - 1} rows, median sd {float(np.median(bv[phased][:, [1, 3]])):.3f}; {card}",
          flush=True)
    return launches


def multi_inputs(w, usable, dev, dtype=torch.float32):
    """(rnorm, nbr_w, col_usable, sample_valid) of the multi-weight dipCN,
    as the sweep passes them: the weights in ``dtype`` for both, and each
    row valid where its sample has a count."""
    w_t = torch.tensor(w, dtype=dtype, device=dev)
    u_t = torch.tensor(usable, device=dev)
    return w_t, w_t, u_t, u_t[:, None].expand(w_t.shape).contiguous()


def multilocus_phase(card: str, counted: dict, tmp: Path, cohort: dict, base: dict, k: int,
                     n_nbr: int) -> dict:
    """Phase 11: the multi-locus sweep from files on phase 9's cohort (see
    the module docstring). Returns its launches, the multi kernel's checks
    and its times at N, for the kernels' JSON line."""
    import math

    from grid_tpu_torch.config import apply_defaults
    from grid_tpu_torch.data.loci import load_vntr_catalog, resolve_locus
    from grid_tpu_torch.io.formats import read_counts_tsv, read_dipcn
    from grid_tpu_torch.ops.gpu_kernels import zprep_gram_panel, zprep_split
    from grid_tpu_torch.ops.gpu_select import (
        dipcn_from_distances_gpu, dipcn_from_distances_multi_gpu, dipcn_select_info,
    )
    from grid_tpu_torch.ops.knn import d2_matrix, panel_d2, sorted_smallest_k
    from grid_tpu_torch.ops.select import dipcn_from_distances_multi
    from grid_tpu_torch.steps import multilocus
    from grid_tpu_torch.steps.neighbors import load_neighbor_geometry
    from grid_tpu_torch.utils.timing import StepTimer
    from torch_parity import dipcn_sets_differ, neighbor_rows_differing

    counted = {**counted, "dipcn_from_distances_multi_gpu": dipcn_from_distances_multi_gpu}
    genes = list(dict.fromkeys(locus.gene for locus in load_vntr_catalog()))
    tag = {g: g.split(",")[0] for g in genes}  # the artifacts' suffix, as locus_config names it
    tags = list(dict.fromkeys(tag.values()))
    out = tmp / "multilocus"
    out.mkdir()
    # ---- per-locus counts: the cohort's, times a factor per locus; half
    # the loci lack the same 2% of the samples (two usability groups)
    rng = np.random.default_rng(MULTI_SEED)
    lines = cohort["counts_file"].read_text().splitlines()
    ids = [ln.split("\t")[0] for ln in lines[1:]]
    counts = np.array([float(ln.split("\t")[1]) for ln in lines[1:]])
    factor = rng.uniform(0.5, 1.5, len(tags))
    lacking = rng.permutation(len(tags)) < len(tags) // 2
    dropped = set(rng.choice(len(ids), size=len(ids) // 50, replace=False).tolist())
    t0 = time.perf_counter()
    for t, f, lack in zip(tags, factor, lacking):
        body = [f"{sid}\t{int(round(c * f))}" for i, (sid, c) in enumerate(zip(ids, counts))
                if not (lack and i in dropped)]
        (out / f"read_counts.{t}.tsv").write_text(lines[0] + "\n" + "\n".join(body) + "\n")
    print(f"[multilocus] {len(genes)} catalog loci ({len(tags)} artifact names: "
          f"{len(genes) - len(tags)} pairs of GENE entries share their first member, as in "
          f"grid_tpu), one counts file each written in {time.perf_counter() - t0:.1f} s; "
          f"{int(lacking.sum())} lack {len(dropped)} of {len(ids)} samples", flush=True)

    cfg = copy.deepcopy(base)
    cfg.pop("device", None)  # file mode, no platform named
    cfg["output_dir"] = str(out)
    cfg = apply_defaults(cfg)
    cfg["compute_haploid_genotypes"]["run"] = False

    # ---- the sweep over the whole catalog ---------------------------------
    console, timer = Recorder(), StepTimer()
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    multilocus.run_multi_locus(cfg, genes, console, timer=timer)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    failed = [msg for msg, style in console.lines if style == "danger" or "Failed to run" in msg]
    check(not failed, f"multilocus: logged {failed[:3]}")
    want = {"masked_column_stats": 2, "zprep_gram": 2, "dipcn_from_distances_gpu": 0,
            "zprep_split": 1, "zprep_gram_panel": -(-len(ids) // 512),
            "dipcn_from_distances_multi_gpu": 2}
    print(f"[multilocus] run_multi_locus over {len(genes)} loci (file mode, no platform named): "
          f"kernel launches {launches}, expected {want}; no failure logged", flush=True)
    check(launches == want, f"multilocus launches {launches} != {want}")
    batched = [msg for msg, _ in console.lines if msg.startswith("Batched dipCN")]
    check(batched == [f"Batched dipCN: {len(genes)} loci in 2 device call(s) (N={len(ids)}, "
                      f"k={k}, resident d2)"], f"multilocus: {batched}")
    t = timer.report()
    steps = json.loads((out / "step_timings.json").read_text())
    device_s = (t["batched.device"] + steps["normalize.device"] + steps["neighbors.device"])
    spans = ("multi_locus.shared", "batched_dipcn", "neighbors.read", "batched.read",
             "batched.device", "batched.write", "multi_locus.per_locus")
    print(f"[multilocus] {wall:.3f} s (host clock): "
          + ", ".join(f"{s} {t[s]:.3f} s" for s in spans)
          + f"; the shared steps normalize {steps['normalize']:.3f} s, neighbors "
          f"{steps['neighbors']:.3f} s; host share (all but normalize.device, neighbors.device, "
          f"batched.device) {100 * (1 - device_s / wall):.2f}%; {card}", flush=True)

    # ---- the same geometry and groups, again, beside the run ---------------
    sample_ids, zp, scales, _, k_geom = load_neighbor_geometry(cfg)
    dev = zp.device
    n = len(sample_ids)
    check(k_geom == k and n == len(ids), "multilocus: the geometry's k or N")
    reads = {t: read_counts_tsv(out / f"read_counts.{t}.tsv") for t in tags}
    groups = multilocus.usability_groups(sample_ids, scales, {g: reads[tag[g]] for g in genes})
    check(len(groups) == 2, f"multilocus: {len(groups)} usability groups")
    zp = zp.contiguous()
    ones = torch.ones(zp.shape, dtype=torch.bool, device=dev)
    d2 = d2_matrix(zp, ones, ones[0], math.inf)
    results, err = {}, 0.0
    for usable, names, w in groups:
        args = multi_inputs(w, usable, dev, zp.dtype)
        dip, ok = dipcn_from_distances_multi_gpu(d2, *args, k=k, n_nbr=n_nbr)
        pdip, pok = dipcn_from_distances_multi(d2, *args, k=k, n_nbr=n_nbr)
        check(torch.equal(ok, pok),
              "multilocus: the multi kernel's ok differs from the plain form's")
        check(torch.allclose(dip[ok], pdip[ok], rtol=1e-5, atol=0),
              "multilocus: the multi kernel differs from the plain form beyond rtol 1e-5")
        err = max(err, max_abs(dip[ok], pdip[ok]))
        for j, g in enumerate(names):
            results[g] = (dip[:, j].cpu().numpy(), ok[:, j].cpu().numpy(), args, j)
    # every written table is the in-memory result at its written precision
    for g in genes:
        dip, ok, _, _ = results[g]
        got_ids, got_vals, _ = read_dipcn(out / f"diploid_genotypes.{tag[g]}.tsv")
        check(got_ids == [s for s, o in zip(sample_ids, ok) if o] and
              np.array_equal(np.asarray(got_vals), dip[ok].astype(np.float64)),
              f"multilocus: diploid_genotypes.{tag[g]}.tsv is not the kernel's result")
    # the checked loci: the first, the last and 6 drawn from the seed
    picked = [0, len(genes) - 1, *sorted(rng.choice(np.arange(1, len(genes) - 1), 6,
                                                    replace=False).tolist())]
    checked = [genes[i] for i in picked]
    bin_err = 0.0
    for g in checked:
        dip, ok, (w_t, _, u_t, v_t), j = results[g]
        col = w_t[:, j].contiguous()
        bdip, bok = dipcn_from_distances_gpu(d2, col, col, u_t, v_t[:, j].contiguous(), k=k,
                                             n_nbr=n_nbr)
        bdip, bok = bdip.cpu().numpy(), bok.cpu().numpy()
        check(np.array_equal(bok, ok), f"multilocus {g}: ok differs from the binary kernel's")
        check(np.allclose(dip[ok], bdip[ok], rtol=1e-5, atol=0),
              f"multilocus {g}: the multi kernel differs from the binary kernel beyond rtol 1e-5")
        bin_err = max(bin_err, float(np.abs(dip[ok] - bdip[ok]).max()))
    print(f"[multilocus] the multi kernel on the sweep's d2 ({len(groups)} groups of "
          f"{', '.join(str(len(names)) for _, names, _ in groups)} loci): ok equal to the plain "
          f"multi form's on the card, values within rtol 1e-5 (max abs err {err:.3e}); every one "
          f"of the {len(tags)} written dipCN tables equal to it at its written precision; loci "
          f"{', '.join(checked)}: ok equal to the binary kernel's per locus, within rtol 1e-5 "
          f"(max abs err {bin_err:.3e})", flush=True)

    # ---- the float64 plain route on the CPU, from the run's own file -------
    t0 = time.perf_counter()
    ids64, zp64, _, _, _ = load_neighbor_geometry({**cfg, "device": {"platform": "cpu"}})
    check(ids64 == sample_ids and zp64.dtype == torch.float64, "multilocus: the CPU geometry")
    ones64 = torch.ones(zp64.shape, dtype=torch.bool)
    d2_64 = d2_matrix(zp64, ones64, ones64[0], math.inf)
    want_d, want_i = (x.numpy() for x in sorted_smallest_k(d2_64, k))
    got_d, got_i = (x.cpu().numpy() for x in sorted_smallest_k(d2, k))
    tol = TIE_RTOL * want_d[:, -1]
    differ = neighbor_rows_differing(got_i, got_d, want_i, want_d, tol=tol)
    sets_total, compared = 0, 0
    for usable, names, w in groups:
        mine = [g for g in checked if g in names]
        if not mine:
            continue
        cols = [names.index(g) for g in mine]
        w64 = torch.tensor(w[:, cols], dtype=torch.float64)
        u64 = torch.tensor(usable)
        v64 = u64[:, None].expand(w64.shape).contiguous()
        pdip, pok = (x.numpy() for x in dipcn_from_distances_multi(d2_64, w64, w64, u64, v64,
                                                                 k=k, n_nbr=n_nbr))
        sets = dipcn_sets_differ(got_i, want_i, usable, n_nbr)
        sets_total += int(sets.sum())
        for c, g in enumerate(mine):
            dip, ok, _, _ = results[g]
            check(np.array_equal(ok, pok[:, c]),
                  f"multilocus {g}: ok differs from the float64 route")
            same = ok & ~sets
            check(np.allclose(dip[same], pdip[same, c], rtol=1e-5, atol=0),
                  f"multilocus {g}: dipCN differs from the float64 route beyond rtol 1e-5")
            compared += int(same.sum())
    print(f"[multilocus] vs the float64 plain route on the CPU from the run's own normalized file "
          f"({time.perf_counter() - t0:.1f} s): neighbor lists identical on {n - differ.size} of "
          f"{n} rows, the others differ only by ties within {TIE_RTOL:g} of the k-th distance; "
          f"{sets_total} rows (summed over the groups) change a dipCN input set; the "
          f"{len(checked)} "
          f"checked loci: ok exact, within rtol 1e-5 on {compared} (row, locus) pairs whose sets "
          f"agree", flush=True)
    del d2_64, zp64

    # ---- a second call: 3 loci with step 7, the shared steps resumed ----
    three = [genes[0], genes[len(genes) // 2], genes[-1]]
    before = {g: (out / f"diploid_genotypes.{tag[g]}.tsv").read_bytes() for g in three}
    cfg2 = copy.deepcopy(cfg)
    cfg2["resume"] = True
    cfg2["compute_haploid_genotypes"]["run"] = True
    console2 = Recorder()
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    multilocus.run_multi_locus(cfg2, three, console2)
    wall2 = time.perf_counter() - t0
    launches2 = {name: fn.launches for name, fn in counted.items()}
    failed = [msg for msg, style in console2.lines if style == "danger" or "Failed to run" in msg]
    check(not failed, f"multilocus call 2: logged {failed[:3]}")
    skipped = [msg for msg, _ in console2.lines if msg.endswith("skipped (resume)")]
    check(skipped == ["[normalize] up-to-date, skipped (resume)",
                      "[neighbors] up-to-date, skipped (resume)"], f"multilocus call 2: {skipped}")
    n_groups2 = len({results[g][1].tobytes() for g in three})
    check(launches2["dipcn_from_distances_multi_gpu"] == n_groups2 == launches2["zprep_gram"]
          and not any(launches2[name] for name in ("masked_column_stats", "zprep_split",
                                                   "zprep_gram_panel", "dipcn_from_distances_gpu")),
          f"multilocus call 2 launches {launches2}")
    for g in three:
        # a locus's sums in the kernel do not depend on the other loci
        check((out / f"diploid_genotypes.{tag[g]}.tsv").read_bytes() == before[g],
              f"multilocus call 2: {g}'s dipCN table changed")
        hap = (out / f"haploid_genotypes.{tag[g]}.tsv").read_text().splitlines()
        dip, ok, _, _ = results[g]
        check([ln.split("\t")[0] for ln in hap[1:]] == [s for s, o in zip(sample_ids, ok) if o],
              f"multilocus call 2: {g}'s haploid rows")
        vals = np.array([[float(v) for v in ln.split("\t")[1:]] for ln in hap[1:]])
        check(np.isfinite(vals[:, 0]).all(), f"multilocus call 2: {g}'s haploid dipCN column")
    print(f"[multilocus] call 2 ({', '.join(three)}; step 7 on, resume): steps 4-5 skipped, "
          f"launches {launches2}; the three dipCN tables unchanged and a haploid table beside "
          f"each, its rows the dipCN rows; {wall2:.3f} s (host clock)", flush=True)

    # ---- the panel branch of the batched step, from the same files --------
    pcfg = copy.deepcopy(cfg)
    pcfg["compute_diploid_genotypes"]["output_file_prefix"] = "panel_diploid_genotypes"
    pcfgs = {g: multilocus.locus_config(pcfg, resolve_locus(g)) for g in genes}
    console3 = Recorder()
    for fn in counted.values():
        fn.launches = 0
    n_panels = -(-n // 512)
    with patched(multilocus, {"D2_BUDGET_BYTES": n * n * 4 - 1}):
        multilocus.run_batched_dipcn(cfg, pcfgs, console3)
    launches3 = {name: fn.launches for name, fn in counted.items()}
    want3 = {"masked_column_stats": 0, "zprep_gram": 0, "dipcn_from_distances_gpu": 0,
             "zprep_split": 2, "zprep_gram_panel": 2 * n_panels,
             "dipcn_from_distances_multi_gpu": 2 * n_panels}
    check(launches3 == want3, f"multilocus panel branch launches {launches3} != {want3}")
    split = zprep_split(zp, None, None, math.inf)
    pd2 = torch.cat([panel_d2(zprep_gram_panel(split, i0, min(512, n - i0)), split.norms, i0)
                     for i0 in range(0, n, 512)])
    pan_d, pan_i = (x.cpu().numpy() for x in sorted_smallest_k(pd2, k))
    pan_differ = neighbor_rows_differing(pan_i, pan_d, got_i, got_d, tol=TIE_RTOL * got_d[:, -1])
    pan_sets, pan_compared = 0, 0
    for usable, names, _ in groups:
        sets = dipcn_sets_differ(pan_i, got_i, usable, n_nbr)
        pan_sets += int(sets.sum())
        for g in names:
            dip, ok, _, _ = results[g]
            p_ids, p_vals, _ = read_dipcn(out / f"panel_diploid_genotypes.{tag[g]}.tsv")
            check(p_ids == [s for s, o in zip(sample_ids, ok) if o],
                  f"multilocus panel branch {g}: dipCN rows differ from the resident run's")
            same = ~sets[ok]
            check(np.allclose(np.asarray(p_vals)[same], dip[ok][same], rtol=1e-5, atol=0),
                  f"multilocus panel branch {g}: dipCN differs beyond rtol 1e-5")
            pan_compared += int(same.sum())
    print(f"[multilocus] the batched step on the panel branch (D2_BUDGET_BYTES {n * n * 4 - 1}): "
          f"launches {launches3}; neighbor lists of its d2 identical to the resident d2's on "
          f"{n - pan_differ.size} of {n} rows, the others ties; {pan_sets} rows change a set; "
          f"every table's rows the resident run's, within rtol 1e-5 on {pan_compared} (row, locus) "
          f"pairs whose sets agree; {card}", flush=True)
    del pd2, split

    # ---- times at N for L in MULTI_TIMED_L ---------------------------------
    info = dipcn_select_info(n, k, dev, multi=True)
    print(f"[multilocus] the multi form at W={n}, k={k}: {info['mode']} mode, "
          f"{info['smem_bytes']} B dynamic + {info['static_smem_bytes']} B static shared memory, "
          f"{info['blocks_per_sm']} blocks per SM, {info['registers']} registers, "
          f"{info['spill_bytes']} B spilled", flush=True)
    check(info["spill_bytes"] == 0, "the multi form spills to local memory")
    # all loci's weights on the larger group's usable columns
    usable_all = max((u for u, _, _ in groups), key=lambda u: int(u.sum()))
    w_all = np.concatenate([w for _, _, w in groups], axis=1)
    timed = {n_loci: time_multi(f"at N={n}, L={n_loci}", card, d2,
                                multi_inputs(w_all[:, :n_loci], usable_all, dev, d2.dtype), k,
                                n_nbr)
             for n_loci in MULTI_TIMED_L}
    del d2, zp
    torch.cuda.empty_cache()
    return {"launches": launches, "launches_call2": launches2, "launches_panels": launches3,
            "max_abs_err": err, "max_abs_err_binary": bin_err, "timed": timed,
            "seconds": wall, "spans": {s: t[s] for s in spans}}


def multilocus_wide_phase(card: str, zp, n_nbr: int = N_NBR, k: int = K) -> dict:
    """Phase 11 at N=65,536 on phase 7's prepared z: the panel route of the
    sweep's batched step with MULTI_L seeded loci (2% unusable columns),
    128 wide-mode multi launches, against the binary wide panel route for
    loci 0, L/2 and L-1; its time, time per panel and peak memory."""
    import math

    from grid_tpu_torch.ops.gpu_kernels import zprep_gram_panel, zprep_split
    from grid_tpu_torch.ops.gpu_select import (
        dipcn_from_distances_gpu, dipcn_from_distances_multi_gpu, dipcn_multi_panels_gpu,
        dipcn_select_info,
    )
    from grid_tpu_torch.ops.knn import panel_d2
    from grid_tpu_torch.ops.select import _take_set

    n, dev, b = zp.shape[0], zp.device, 512
    n_panels = -(-n // b)
    rng = np.random.default_rng(MULTI_SEED)
    usable = rng.random(n) > 0.02
    w = np.where(usable[:, None], rng.uniform(0.5, 2.0, (n, MULTI_L)), 0.0)
    args = multi_inputs(w, usable, dev, zp.dtype)
    row_valid = torch.ones(n, dtype=torch.bool, device=dev)
    def route():
        return dipcn_multi_panels_gpu(zp, *args, k=k, n_nbr=n_nbr, row_valid=row_valid)

    counted = (zprep_split, zprep_gram_panel, dipcn_from_distances_multi_gpu)
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dip, ok = route()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = tuple(fn.launches for fn in counted)
    check(launches == (1, n_panels, n_panels), f"multilocus N={n}: launches {launches}")
    bound = 32 * b * n * 4 + 8 * n * MULTI_L * 4
    check(peak < bound, f"multilocus N={n}: peak {peak} B is not O(512*N + N*L)")
    info = dipcn_select_info(n, k, dev, multi=True)
    check(info["mode"] == "wide" and info["spill_bytes"] == 0, f"multi form shape {info}")
    # the binary wide panel route for three loci, on the same panels
    three = (0, MULTI_L // 2, MULTI_L - 1)
    split = zprep_split(zp, None, None, math.inf)
    w_t, _, u_t, v_t = args
    err = 0.0
    for i0 in range(0, n, b):
        rows = slice(i0, min(i0 + b, n))
        d2 = panel_d2(zprep_gram_panel(split, i0, rows.stop - i0), split.norms, i0, row_valid)
        for j in three:
            col = w_t[:, j].contiguous()
            bdip, bok = dipcn_from_distances_gpu(d2, col[rows].contiguous(), col, u_t,
                                                 v_t[rows, j].contiguous(), k=k, n_nbr=n_nbr)
            check(torch.equal(bok, ok[rows, j]), f"multilocus N={n}: ok of locus {j} differs")
            check(torch.allclose(dip[rows, j][bok], bdip[bok], rtol=1e-5, atol=0),
                  f"multilocus N={n}: locus {j} differs from the binary route beyond rtol 1e-5")
            err = max(err, max_abs(dip[rows, j][bok], bdip[bok]))
    d2 = panel_d2(zprep_gram_panel(split, 0, b), split.norms, 0, row_valid)
    one = (d2, args[0][:b].contiguous(), args[1], u_t, v_t[:b].contiguous())
    del split, dip, ok
    # the first panel's bound: its d2, W, rnorm, valid and usable read once,
    # dipcn and ok written once, against the adds its take-sets need
    _, m_eff = _take_set(d2, u_t, k, n_nbr)
    least, by = bound_ms(4 * b * n + 4 * n * MULTI_L + n + b * MULTI_L * (4 + 1 + 4 + 1),
                         float(m_eff.sum()) * MULTI_L, FP32_FLOP_PER_S)
    step_ms = [median_ms(route, reps=3, warmup=1) for _ in range(2)]
    col0 = w_t[:, 0].contiguous()
    kern_ms = min(back_to_back_ms(lambda: dipcn_from_distances_multi_gpu(*one, k=k, n_nbr=n_nbr),
                                  reps=5, warmup=1) for _ in range(2))
    bin_ms = min(back_to_back_ms(lambda: dipcn_from_distances_gpu(
        d2, col0[:b].contiguous(), col0, u_t, v_t[:b, 0].contiguous(), k=k, n_nbr=n_nbr),
        reps=5, warmup=1) for _ in range(2))
    print(f"[multilocus] N={n}, R={zp.shape[1]}, L={MULTI_L}: the panel route (1 split, "
          f"{n_panels} Gram panels, {n_panels} multi launches in the {info['mode']} mode) "
          f"{min(step_ms):.1f} ms by CUDA events (better of two medians of 3: "
          f"{step_ms[0]:.1f}, {step_ms[1]:.1f}), {min(step_ms) / n_panels:.3f} ms per panel; "
          f"the multi kernel alone {kern_ms:.4f} ms per [{b}, {n}] panel (bound {least:.4f} ms "
          f"by {by}, {100 * least / kern_ms:.1f}% of it), the binary kernel "
          f"{bin_ms:.4f} ms; loci {', '.join(map(str, three))} against the binary wide route: ok "
          f"equal, within rtol 1e-5 (max abs err {err:.3e}); peak memory "
          f"{peak / 2**30:.3f} GiB above the inputs (gate {bound / 2**30:.2f} GiB: 32 panels + "
          f"8 [N, L] float32 arrays); {card}", flush=True)
    del d2, one
    torch.cuda.empty_cache()
    return {"launches": n_panels, "step_ms": min(step_ms), "panel_ms": min(step_ms) / n_panels,
            "kernel_ms_per_panel": kern_ms, "binary_ms_per_panel": bin_ms,
            "bound_ms_per_panel": least, "bound_by": by,
            "peak_gib": peak / 2**30, "max_abs_err_binary": err}


def pipeline_phase(card: str, wrappers: dict, n: int = PIPELINE_N, flank: int = PIPELINE_FLANK,
                 k: int = K, n_nbr: int = N_NBR) -> dict:
    """Phase 9: the fused WGS pipeline from files (see the module docstring).
    Returns the kernels' launches during the first pipeline call, phase
    10's, phase 11's results, phase 14's launches (its pipeline part runs
    on this cohort), phase 15 (d)'s (the ring from a config), phase 17
    (d)'s and (i)'s float64 pipeline runs, phase 17 (h)'s sweep and
    (i)'s stager ({"sweep": ..., "stage": ...}), and phase 18 (c)'s bf16
    runs and sweep ({"runs": ..., "sweep": ...}). main() passes no size:
    the size arguments let the phase be rehearsed small."""
    import grid_tpu_torch.io.bed as port_bed
    import grid_tpu_torch.steps.fused as fused
    from grid_tpu_torch import native_host
    from grid_tpu_torch.io.bed import load_repeat_mask, map_bed_gz_to_samples
    from grid_tpu_torch.io.formats import (
        read_dipcn, read_neighbors, read_normalized_data, read_samples,
    )
    from grid_tpu_torch.io.staging import scan_cohort_regions
    from grid_tpu_torch.models.cohort import CohortParams
    from grid_tpu_torch.ops.gpu_kernels import zprep_gram_cross, zprep_gram_panel, zprep_split
    from grid_tpu_torch.ops.gpu_select import dipcn_select_info
    from grid_tpu_torch.pipeline import run_wgs_pipeline
    from grid_tpu_torch.synth import make_synthetic_cohort
    from torch_parity import dipcn_sets_differ, neighbor_rows_differing

    names = {"normalized": "mosdepth_results_normalized.tsv.gz",
             "neighbors": f"neighbor_coverage.zMax{ZMAX:.1f}.tsv.gz",
             "dipcn": "diploid_genotypes.tsv", "haploid": "haploid_genotypes.tsv"}
    spans = ("fused.stage", "fused.device", "fused.phase", "fused.write")
    # the panel entry points are counted too: zero on the resident branch
    counted = {**wrappers, "zprep_split": zprep_split, "zprep_gram_panel": zprep_gram_panel}
    resident_launches = {**PIPELINE_LAUNCHES, "zprep_split": 0, "zprep_gram_panel": 0}
    n_panels = -(-n // CohortParams().row_block)
    panel_launches = {"masked_column_stats": 2, "zprep_gram": 0,
                      "dipcn_from_distances_gpu": n_panels, "zprep_split": 1,
                      "zprep_gram_panel": n_panels}
    panel_budget = n * n * 4 - 1  # one byte short of the float32 [N, N] distance matrix
    real_stage = fused._stage
    seen_writes = {}

    with tempfile.TemporaryDirectory(prefix="grid_tpu_torch_smoke_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        cohort = make_synthetic_cohort(tmp / "cohort", n_samples=n, flank_bins=flank,
                                       missing_frac=0.02, seed=PIPELINE_SEED)
        base = cohort["config"]
        base["mosdepth"]["neighbors"]["num_neighbors"] = k
        base["compute_diploid_genotypes"]["n_nbr"] = n_nbr
        base["compute_haploid_genotypes"].update(max_neighbors=10, n_iters=N_ITERS)
        n_bins = (base["end_bp"] - base["start_bp"]) // base["mosdepth"]["bin_size"]
        print(f"[pipeline] cohort on disk: {n} samples x {n_bins} bins of 1 kb, made in "
              f"{time.perf_counter() - t0:.1f} s (host clock)", flush=True)

        def run(label: str, device: dict, python_host: bool = False, panels: bool = False,
                samples: Path | None = None):
            """One run_wgs_pipeline call. ``python_host`` hides the host
            library from the port (its Python reader and writers run),
            ``panels`` lowers the d2 budget below the [N, N] matrix, each by
            a patch of the port's module attributes for this call only;
            ``samples`` names another samples file (a subset of the
            cohort's). Returns the output directory, the timings, the
            launches and the staged cohort."""
            cfg = copy.deepcopy(base)
            out = tmp / label
            out.mkdir()
            cfg["output_dir"] = str(out)
            cfg["device"] = device
            if samples is not None:
                cfg["samples_file"] = str(samples)
            (out / "read_counts.tsv").write_bytes(cohort["counts_file"].read_bytes())
            seen = {}

            def keep_stage(*args, **kwargs):
                seen["stage"] = real_stage(*args, **kwargs)
                return seen["stage"]

            def keep_write(name):
                writer = getattr(fused, name)

                def write(*args, **kwargs):
                    seen_writes.setdefault(label, {})[name] = (args, kwargs)
                    return writer(*args, **kwargs)
                return write

            fused_patch = {"_stage": keep_stage}
            for name in ("write_normalized_output", "write_neighbors_dense"):
                fused_patch[name] = keep_write(name)
            if panels:
                fused_patch["CohortParams"] = (
                    lambda **kw: CohortParams(**kw)._replace(d2_budget_bytes=panel_budget))
            host_patch = {"lib": lambda: None} if python_host else {}
            for fn in counted.values():
                fn.launches = 0
            port_bed.native_fallbacks = 0
            with patched(fused, fused_patch), patched(native_host, host_patch):
                timings = run_wgs_pipeline(config=cfg)
            launches = {name: fn.launches for name, fn in counted.items()}
            if not python_host:
                check(port_bed.native_fallbacks == 0, f"pipeline {label}: "
                      f"{port_bed.native_fallbacks} bed.gz files fell back to the Python reader")
            for name in (*names.values(), "step_timings.json"):
                check((out / name).exists(), f"pipeline {label}: {name} was not written")
            check(json.loads((out / "step_timings.json").read_text()) == timings,
                  f"pipeline {label}: step_timings.json differs from the returned timings")
            check("fused_steps_4_7" in timings and all(s in timings for s in spans),
                  f"pipeline {label}: timings {sorted(timings)}")
            return out, timings, launches, seen["stage"]

        def report(label: str, t: dict) -> None:
            total = t["fused_steps_4_7"]
            host = 1 - (t["fused.device"] + t["fused.phase"]) / total
            print(f"[pipeline] {label}: fused.stage {t['fused.stage']:.3f} s, fused.device "
                  f"{t['fused.device']:.3f} s, fused.phase {t['fused.phase']:.3f} s, fused.write "
                  f"{t['fused.write']:.3f} s, their sum {sum(t[s] for s in spans):.3f} s of "
                  f"fused_steps_4_7 {total:.3f} s (host clock); host share of fused_steps_4_7 "
                  f"(all but device and phase) {100 * host:.2f}%; {card}", flush=True)

        # ---- the card runs: no platform named, the native host route -----
        card_out, card_t, launches, _ = run("card", {"fused": True})
        print(f"[pipeline] run_wgs_pipeline with no platform named, native host route: kernel "
              f"launches {launches}; 0 bed.gz files fell back to the Python reader", flush=True)
        check(launches == resident_launches, f"pipeline launches {launches} != {resident_launches}")
        report("card run 1, native host route (its fused.device holds the kernels' first launches "
               "at these shapes)", card_t)
        card2_out, again_t, again, _ = run("card2", {"fused": True})
        check(again == resident_launches, f"pipeline launches, second run: {again}")
        report("card run 2, native host route", again_t)

        # ---- where the native route's stage and write go ----------------
        excluded = load_repeat_mask(base["mosdepth"]["normalize"]["repeat_mask_file"])
        beds = map_bed_gz_to_samples(base["mosdepth"]["work_dir"],
                                     read_samples(base["samples_file"]))
        t0 = time.perf_counter()
        raw = [Path(path).read_bytes() for path in beds.values()]
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        text_mb = sum(len(zlib.decompress(blob, wbits=47)) for blob in raw) / 1e6
        inflate_s = time.perf_counter() - t0
        raw_mb = sum(map(len, raw)) / 1e6
        del raw
        scan_s = {}
        for threads in sorted({1, base["threads"], 4}):
            t0 = time.perf_counter()
            scan_cohort_regions(beds, base["chrom"], base["start_bp"], base["end_bp"], excluded,
                                threads)
            scan_s[threads] = time.perf_counter() - t0
        write_s, sizes = {}, {}
        for name, (args, kwargs) in seen_writes["card2"].items():
            again_path = tmp / f"timed_{Path(args[0]).name}"
            t0 = time.perf_counter()
            getattr(fused, name)(again_path, *args[1:], **kwargs)
            write_s[name] = time.perf_counter() - t0
            sizes[name] = (again_path.stat().st_size / 1e6, len(content(again_path)) / 1e6)
        scans = ", ".join(f"{sec:.3f} s on {t} thread(s)" for t, sec in scan_s.items())
        print(f"[pipeline] native host route in parts (host clock, one call each after card run "
              f"2): reading the {len(beds)} bed.gz files' bytes {read_s:.3f} s ({raw_mb:.1f} MB), "
              f"inflating them in one thread (Python's zlib) {inflate_s:.3f} s ({text_mb:.1f} MB "
              f"of text); scanning them {scans} of fused.stage "
              f"{again_t['fused.stage']:.3f} s (the rest: the region universe, "
              f"the dense fill, the read counts); "
              + "; ".join(f"{name} {write_s[name]:.3f} s ({sizes[name][1]:.1f} MB of text, "
                          f"{sizes[name][0]:.1f} MB written)" for name in write_s)
              + f" of fused.write {again_t['fused.write']:.3f} s; {card}", flush=True)

        # ---- (a) step 4 against a CPU run, on its own terms --------------
        cpu_out, cpu_t, cpu_launches, _ = run("cpu", {"fused": True, "platform": "cpu"})
        check(not any(cpu_launches.values()), "the CPU run launched a kernel")
        report("CPU run (device.platform: cpu, float64, the plain versions; native host route)",
               cpu_t)
        ids, ratios, z_card, scales = read_normalized_data(card_out / names["normalized"])
        cpu_ids, cpu_ratios, z_cpu, cpu_scales = read_normalized_data(cpu_out / names["normalized"])
        check(ids == cpu_ids and len(ids) == n, "pipeline step 4: sample IDs differ")
        check(z_card.shape == z_cpu.shape, f"pipeline step 4: shapes {z_card.shape}, {z_cpu.shape}")
        check(np.array_equal(np.isnan(z_card), np.isnan(z_cpu)), "pipeline step 4: NA cells differ")
        check(np.allclose(ratios, cpu_ratios, rtol=1e-4, atol=2e-3, equal_nan=True),
              "pipeline step 4: variance ratios differ")
        z_diff = np.nan_to_num(np.abs(z_card - z_cpu))
        s_card = np.array([scales[s] for s in ids])
        s_diff = np.abs(s_card - np.array([cpu_scales[s] for s in ids]))
        check(z_diff.max() <= QUANTUM, f"pipeline step 4: z differs by {z_diff.max()}")
        check(s_diff.max() <= QUANTUM, f"pipeline step 4: a scale differs by {s_diff.max()}")
        cells = int((~np.isnan(z_card)).sum())
        z_apart, s_apart = int((z_diff > 1e-9).sum()), int((s_diff > 1e-9).sum())
        print(f"[pipeline] step 4, card vs CPU run: {len(ids)} samples x {z_card.shape[1]} written "
              f"bins, the same NA cells; {z_apart} of {cells} z cells one quantum apart (bound "
              f"{cells // 500}), {s_apart} of {n} scales (bound {n // 100}), none further",
              flush=True)
        check(z_apart <= cells // 500 and s_apart <= n // 100,
              "pipeline step 4: too many cells one quantum apart")
        del z_cpu, z_diff

        # ---- (b) steps 5-7 rebuilt from the card's own written files -----
        own = rebuild_from_files("pipeline", card_out, names, ids, ratios, z_card, scales,
                                 cohort["ibs_file"], k, n_nbr, fused=True)
        row_of, got_idx, got_d, written, d2_np = own.row_of, own.idx, own.d, own.written, own.d2
        usable, want_ok, dip_ids, dip_vals = own.usable, own.ok, own.dip_ids, own.dip_vals

        cpu_ids6, cpu_vals, _ = read_dipcn(cpu_out / names["dipcn"])
        check(cpu_ids6 == dip_ids, "pipeline: the CPU run's dipCN rows differ")
        rel = np.abs(dip_vals - np.asarray(cpu_vals)) / np.asarray(cpu_vals)
        print(f"[pipeline] for the record, card vs CPU run dipCN (other z cells, so other neighbor "
              f"sets): median relative difference {float(np.median(rel)):.2e}, max "
              f"{float(rel.max()):.2e}", flush=True)
        print(f"[pipeline] second card run: fused.device {again_t['fused.device']:.3f} s vs "
              f"{card_t['fused.device']:.3f} s in the first; {card}", flush=True)

        # ---- phase 17 (d): float64 on the card, fused and in file mode ----
        f64_runs = float64_pipeline_runs(card, tmp, cohort, base, names, cpu_out, k, n_nbr)
        # ---- phase 18 (c): bfloat16 on the card, fused and in file mode ---
        bf16_files = {"runs": bfloat16_pipeline_runs(card, tmp, cohort, base, names, k, n_nbr)}

        # ---- (c) the Python host route on the card, on a subset ----------
        subset = tmp / "samples_python_host.txt"
        subset.write_text("".join(f"{sid}\n"
                                  for sid in read_samples(base["samples_file"])[:PY_HOST_N]))
        sub_out, _, sub_launches, sub_stage = run("card_subset", {"fused": True}, samples=subset)
        py_out, py_t, py_launches, py_stage = run("card_python_host", {"fused": True},
                                                  python_host=True, samples=subset)
        check(py_launches == sub_launches == resident_launches,
              f"pipeline launches on {PY_HOST_N} samples, native {sub_launches}, Python host "
              f"route {py_launches}")
        report(f"card run 3, Python host route (the port's Python reader and writers) on the "
               f"first {PY_HOST_N} samples", py_t)
        check(py_stage.sample_ids == sub_stage.sample_ids, "staged sample IDs differ by route")
        for field in ("regions", "values", "mask"):
            a, b = getattr(sub_stage, field), getattr(py_stage, field)
            check(a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(),
                  f"staged {field} differ between the native and the Python host route")
        print(f"[pipeline] _stage's arrays from the two host routes on {PY_HOST_N} samples: "
              f"bitwise equal (regions {sub_stage.regions.shape}, values and mask "
              f"{sub_stage.values.shape})", flush=True)
        repeat_differs = [a for a, name in names.items()
                          if content(card_out / name) != content(card2_out / name)]
        if not repeat_differs:
            for artifact, name in names.items():
                check(content(py_out / name) == content(sub_out / name),
                      f"the {artifact} artifact differs between the host routes (decompressed)")
            print("[pipeline] the card step is bitwise repeatable (card runs 1 and 2 wrote the "
                  "same four artifacts, decompressed); the Python host route's four artifacts "
                  "equal the native route's after decompression", flush=True)
        else:
            # the step is not repeatable: hold the native writers to the
            # Python writers on one run's outputs instead
            for name in ("write_normalized_output", "write_neighbors_dense"):
                args, kwargs = seen_writes["card"][name]
                again_path = tmp / f"rewritten_{Path(args[0]).name}"
                with patched(native_host, {"lib": lambda: None}):
                    getattr(fused, name)(again_path, *args[1:], **kwargs)
                check(content(again_path) == content(args[0]),
                      f"{name}: the Python writer's bytes differ from the native writer's")
            print(f"[pipeline] the card step is NOT bitwise repeatable "
                  f"({', '.join(repeat_differs)} differ between card runs 1 and 2), so the host "
                  f"routes' artifacts are not compared; instead card run 1's outputs rewritten "
                  f"by the Python writers equal "
                  f"its native writers' files after decompression (the dipCN and haploid tables "
                  f"have Python writers only)", flush=True)

        # ---- (d) the row-panel branch from files -------------------------
        pan_out, pan_t, pan_launches, _ = run("card_panels", {"fused": True}, panels=True)
        dinfo = dipcn_select_info(n, k, torch.device("cuda"))
        print(f"[pipeline] panel branch from files (d2_budget_bytes {panel_budget} < {n}^2*4): "
              f"kernel launches {pan_launches}, expected {panel_launches} ({n_panels} panels of "
              f"at most {CohortParams().row_block} rows; dipcn_select in its {dinfo['mode']} mode "
              f"for {n} columns)", flush=True)
        check(pan_launches == panel_launches, f"panel launches {pan_launches} != {panel_launches}")
        report("card run 4, panel branch, native host route", pan_t)
        check(content(pan_out / names["normalized"]) == content(card_out / names["normalized"]),
              "panel branch: step 4 differs from the resident run's")
        pan_nbrs, pan_scales = read_neighbors(pan_out / names["neighbors"])
        check(list(pan_nbrs) == ids and pan_scales == scales, "panel branch: neighbor file rows")
        pan_idx = np.array([[row_of[nid] for nid, _, _ in pan_nbrs[s]] for s in ids])
        pan_written = np.array([[dist for _, _, dist in pan_nbrs[s]] for s in ids])
        pan_d = d2_np[np.arange(n)[:, None], pan_idx]
        res_tol = TIE_RTOL * got_d[:, -1].astype(np.float64)
        pan_differ = neighbor_rows_differing(pan_idx, pan_d, got_idx, got_d, tol=res_tol)
        written_off = float(np.abs(pan_written - written).max())
        check(written_off <= QUANTUM, f"panel branch: a written distance is {written_off} off")
        pan_dip_ids, pan_dip, _ = read_dipcn(pan_out / names["dipcn"])
        check(pan_dip_ids == dip_ids, "panel branch: dipCN rows differ from the resident run's")
        pan_sets = dipcn_sets_differ(pan_idx, got_idx, usable, n_nbr)[want_ok]
        pan_dip = np.asarray(pan_dip)
        check(np.allclose(pan_dip[~pan_sets], dip_vals[~pan_sets], rtol=1e-5, atol=0),
              "panel branch: dipCN differs from the resident run's beyond rtol 1e-5")
        print(f"[pipeline] panel branch vs the resident run's files: step 4 identical; neighbor "
              f"rows identical on {n - pan_differ.size} of {n}, the others differ only by ties "
              f"within {TIE_RTOL:g} of the k-th distance; written distances within "
              f"{written_off:.2f}; {len(pan_dip_ids)} dipCN rows, within rtol 1e-5 on the "
              f"{int((~pan_sets).sum())} rows whose input sets agree; {card}", flush=True)

        # ---- phase 15 (d): the ring from a config, on the same cohort -----
        zprep_gram_cross.launches = 0
        ring_out, ring_t, ring_launches, _ = run(
            "card_ring", {"fused": True, "mesh_shape": [RING_BIOBANK_WORLD], "dispatch": "ring"})
        ring_launches["zprep_gram_cross"] = zprep_gram_cross.launches
        w = RING_BIOBANK_WORLD
        want_ring = {"masked_column_stats": 2 * w, "zprep_gram": 0,
                     "dipcn_from_distances_gpu": 0, "zprep_split": w, "zprep_gram_panel": 0,
                     "zprep_gram_cross": w * w}
        print(f"[ring] run_wgs_pipeline with device: {{fused: true, mesh_shape: [{w}], dispatch: "
              f"ring}}: kernel launches {ring_launches} over the {w} ranks, expected "
              f"{want_ring}", flush=True)
        check(ring_launches == want_ring, f"ring pipeline launches {ring_launches}")
        report(f"card run 5, the ring over {w} ranks of the card (gloo)", ring_t)
        found = same_steps_4_7("ring pipeline", card_out, ring_out, names, n, n_nbr)
        print(f"[ring] the ring's four artifacts vs card run 1's (the flat step): {found}; "
              f"{card}", flush=True)

        # ---- phase 10: the pipeline in file mode, on the same cohort ------
        total = again_t["fused_steps_4_7"]
        fused_run = SimpleNamespace(
            out=card_out, t=again_t, ids=ids, ratios=ratios, z=z_card, scales=scales, own=own,
            host_share=1 - (again_t["fused.device"] + again_t["fused.phase"]) / total)
        files_launches = files_phase(card, counted, tmp, cohort, base, names, fused_run, k, n_nbr)

        # ---- phase 11: the multi-locus sweep, on the same cohort ----------
        multi = multilocus_phase(card, counted, tmp, cohort, base, k, n_nbr)

        # ---- phase 17 (h), (g) at N=2504: the float64 sweep ---------------
        f64_files = {"sweep": float64_sweep_phase(card, tmp, base, names, k, n_nbr)}
        # ---- phase 18 (c): the sweep in bfloat16 --------------------------
        bf16_files["sweep"] = bfloat16_sweep_run(card, tmp, base, names, k)

        # ---- phase 14 (b, c): compute_ibs in front of the fused steps -----
        ibs_launches = ibs_pipeline_phase(card, counted, tmp, cohort, base, names,
                                          resident_launches, k, n_nbr)

        # ---- phase 16 (c, d): the sharded stager, the build cache, traces --
        stage_phase(card, tmp, cohort, base, k, n_nbr)
        # ---- phase 17 (i): the sharded stager in float64 ------------------
        f64_files["stage"] = float64_stage_run(card, tmp, cohort, base, k, n_nbr)
        # ---- phase 18 (f): bf16 with mesh_shape, the ring from a config and
        # the sharded stager ----------------------------------------------
        bf16_files["sharded"] = bfloat16_sharded_runs(card, tmp, cohort, base, names, k, n_nbr)
        cache_phase(card, tmp, cohort, base, names, again_t)
    check(not tmp.exists(), "the temporary directory was not removed")
    return ({name: launches[name] for name in wrappers}, files_launches, multi,
            {name: ibs_launches[name] for name in wrappers}, ring_launches, f64_runs, f64_files,
            bf16_files)


def sm_clocks_mhz() -> tuple:
    """(current, maximum) SM clock in MHz, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True, check=True)
    now, top = (int(v) for v in out.stdout.strip().split(","))
    return now, top


def sw_bound_ms(cells: int, sms: int, clock_mhz: int, per_cell: float = SW_OPS_PER_CELL) -> float:
    """The least time of ``cells`` Smith-Waterman cell updates: ``per_cell``
    instructions each over sms x SW_LANES_PER_SM lanes at the SM clock."""
    return per_cell * cells / (sms * SW_LANES_PER_SM * clock_mhz * 1e6) * 1e3


def cuobjdump_sass(lib: Path) -> str | None:
    """``cuobjdump -sass`` of a library, or None where the toolkit has no
    cuobjdump."""
    tool = shutil.which("cuobjdump") or Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                             "bin", "cuobjdump")
    if not Path(tool).exists():
        return None
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout


def sass_loops(sass: str, function: str) -> list:
    """The loops of the one kernel whose mangled name holds ``function`` in
    a library's SASS (none where no kernel does): for each backward branch,
    the instructions from its target to it, the shuffles up among them (one
    a wavefront step) and their opcodes."""
    body = next((part for part in sass.split("Function : ")[1:]
                 if function in part.split("\n", 1)[0]), "")
    code = [(int(addr, 16), text.strip()) for addr, text in
            re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    loops = []
    for addr, text in code:
        target = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if target and int(target.group(1), 16) <= addr:
            inside = [t for a, t in code if int(target.group(1), 16) <= a <= addr]
            ops = Counter(re.sub(r"^@!?U?P[T0-9]+\s+", "", t).split()[0] for t in inside)
            loops.append({"instructions": len(inside), "shuffles": ops.get("SHFL.UP", 0),
                          "ops": dict(ops.most_common())})
    return loops


def sw_kernel_phase(dev, card: str) -> dict:
    """Phase 13 (a) and (b): the kernel against its plain version on the
    card, exactly, on tests/torch_sw_cases.py's cases (int8, uint8, and
    int8 reads against uint8 references) and the host oracle, at every lane
    count its chooser takes on the main path's references in both forms;
    the launch shapes, which must not spill, and the instructions a cell of
    the wavefront loops in the SASS; then its times at Q = 8,192 and 32,768
    beside its bounds, at the chosen shape and form and the others. Returns
    the kernels-line fields."""
    from grid_tpu_torch import native
    from grid_tpu_torch.ops import gpu_align
    from grid_tpu_torch.ops.align import encode_seqs, sw_score_host, sw_scores_plain
    from grid_tpu_torch.ops.gpu_align import sw_scores_gpu, sw_scores_info
    from torch_sw_cases import acgt_pairs, exon_refs, reads_from, sw_cases

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    step = gpu_align.STRIP_STEP
    for g, top in gpu_align.MAX_STRIP.items():  # every instance of the register mode's table
        for packed in (False, True):
            infos = {s: gpu_align._info(g * s, g, s, packed, dev)
                     for s in range(step, top + 1, step)}
            by_s = " ".join("{}:{}/{}/{}".format(s, i["registers"], i["blocks_per_sm"],
                                                 i["spill_bytes"]) for s, i in infos.items())
            print(f"[sw] register mode, {gpu_align.FORMS[packed]} form, G={g}: registers / "
                  f"blocks an SM / spill bytes by S: {by_s}", flush=True)
            check(all(i["spill_bytes"] == 0 for i in infos.values()),
                  f"sw_scores spills to local memory at G={g} ({gpu_align.FORMS[packed]})")
    lr_main = 182
    shapes = {}
    for n_q, lq, lr in ((SW_TIMED_Q[0], WES_READ_LEN, lr_main),
                        (SW_TIMED_Q[1], WES_READ_LEN, lr_main), (128, WES_READ_LEN, 700)):
        info = sw_scores_info(n_q, lq, 3, lr, dev)
        packed = info["form"] == "packed"
        n_units = gpu_align.units(n_q, 3, packed)
        blocks = -(-n_units // (info["pairs_per_block"] // (2 if packed else 1)))
        waves = blocks / (info["blocks_per_sm"] * sms)
        shapes[n_q] = (info["group_lanes"], info["columns_per_lane"])
        print(f"[sw] launch shape at Q={n_q}, Lq={lq}, T=3, Lr={lr}: {info['mode']} mode, "
              f"{info['form']} form, G={info['group_lanes']} lanes a unit ({n_units} units), "
              f"S={info['columns_per_lane']} columns a lane, {info['pairs_per_block']} pairs a "
              f"block, {info['smem_bytes']} B of dynamic shared memory, {info['registers']} "
              f"registers and {info['spill_bytes']} B of local memory a thread, "
              f"{info['blocks_per_sm']} blocks an SM: {blocks} blocks, {waves:.2f} waves on "
              f"{sms} SMs", flush=True)
        check(info["spill_bytes"] == 0, f"sw_scores spills to local memory at Lr={lr}")
    # the instructions a cell: the wavefront loops of the main path's shape in the SASS
    g_main, s_main = shapes[SW_TIMED_Q[0]]
    sass = cuobjdump_sass(native.build("sw_scores"))
    loops = []
    for g in (8, 16, 32) if sass else ():
        s = gpu_align.strip(lr_main, g)
        for kernel, form in (("sw_duo_kernel", "packed"), ("sw_group_kernel", "int32")):
            for loop in sass_loops(sass, f"{kernel}ILi{g}ELi{s}EE"):
                if not loop["shuffles"]:
                    continue  # a wavefront loop has one shuffle a step
                # the duo kernel's int32 loops score a warp's reads with codes past 4
                cells = 2 * s if form == "packed" and "PRMT" in loop["ops"] else s
                per_cell = loop["instructions"] / (cells * loop["shuffles"])
                kind = "packed" if cells > s else "int32"
                loops.append({"kernel": kernel, "form": kind, "g": g, "s": s, **loop,
                              "per_cell": per_cell})
                print(f"[sw] SASS of {kernel}<{g}, {s}>, its {kind} loop: {loop['instructions']} "
                      f"instructions, {loop['shuffles']} step(s) of {cells} cells: "
                      f"{per_cell:.2f} instructions a cell; {loop['ops']}", flush=True)
    if sass is None:
        print("[sw] no cuobjdump: the instructions a cell are not measured", flush=True)
    else:
        check(any((lp["g"], lp["s"], lp["form"]) == (g_main, s_main, "packed") for lp in loops),
              f"sw_scores: no packed wavefront loop of G={g_main}, S={s_main} in the SASS")
    # ---- (a) exact equality with the plain scan on the card ----
    err = 0.0
    cases = sw_cases()
    for label, q_np, r_np, (match, mismatch, gap) in cases:
        q, r = torch.as_tensor(q_np, device=dev), torch.as_tensor(r_np, device=dev)
        for qt, rt in ((q, r), (q.view(torch.uint8), r.view(torch.uint8)),
                       (q, r.view(torch.uint8))):
            want = sw_scores_plain(qt, rt, match=match, mismatch=mismatch, gap=gap)
            got = sw_scores_gpu(qt, rt, match=match, mismatch=mismatch, gap=gap)
            torch.cuda.synchronize()
            err = max(err, max_abs(got, want))
            check(torch.equal(got, want), f"sw_scores {label} ({qt.dtype} reads, {rt.dtype} "
                                          f"references): the kernel differs from the plain "
                                          f"version on {int((got != want).sum())} pairs")
        g, s, packed = gpu_align._choice(*q.shape, *r.shape, match, mismatch, gap)
        shape = (f"{gpu_align.FORMS[packed]} form, G={g}, S={s}" if g else "shared mode")
        print(f"[sw] {label}: Q={q.shape[0]} Lq={q.shape[1]} T={r.shape[0]} Lr={r.shape[1]} "
              f"scores ({match}, {mismatch}, {gap}), {shape}: kernel == plain exactly on int8, "
              f"uint8 and int8 against uint8 (int32; max score {int(want.max())})", flush=True)
    # every G the chooser may take at Lr=182, in every form the scores allow
    for label, q_np, r_np, (match, mismatch, gap) in cases:
        if label not in ("main", "gap+1", "codes-past-4"):
            continue
        q, r = torch.as_tensor(q_np, device=dev), torch.as_tensor(r_np, device=dev)
        want = sw_scores_plain(q, r, match=match, mismatch=mismatch, gap=gap)
        forms = (False, True) if gpu_align.packed_fits(q.shape[1], match, mismatch, gap) \
            else (False,)
        for g in (8, 16, 32):
            for packed in forms:
                got = gpu_align._launch(q, r, match, mismatch, gap, g,
                                        gpu_align.strip(r.shape[1], g), packed)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"sw_scores {label} at G={g} "
                                              f"({gpu_align.FORMS[packed]}): the kernel differs "
                                              f"from the plain version")
        print(f"[sw] {label} at G = 8, 16, 32 (forced), "
              f"{' and '.join(gpu_align.FORMS[f] for f in forms)}: kernel == plain exactly",
              flush=True)
    for read, ref in acgt_pairs():
        got = int(sw_scores_gpu(torch.as_tensor(encode_seqs([read]), device=dev),
                                torch.as_tensor(encode_seqs([ref]), device=dev))[0, 0])
        check(got == sw_score_host(read, ref), "sw_scores: the kernel differs from the host "
                                               "oracle on an ACGT read")
    print(f"[sw] {len(acgt_pairs())} ACGT reads equal sw_score_host", flush=True)

    # ---- (b) times at the main path's shape: the chooser's and the others ----
    clock_now, clock_max = sm_clocks_mhz()
    rng = np.random.default_rng(SW_SEED)
    exons = exon_refs(rng)
    refs = torch.as_tensor(encode_seqs(exons), device=dev)
    lr = refs.shape[1]
    timed = {}
    for n_q in SW_TIMED_Q:
        q = torch.as_tensor(encode_seqs(reads_from(rng, exons, n_q, WES_READ_LEN,
                                                   n_frac=0.002)), device=dev)
        chosen = gpu_align._choice(n_q, WES_READ_LEN, 3, lr, 2, -1, -2)
        want = sw_scores_plain(q, refs)
        kernels = {chosen: lambda q=q: sw_scores_gpu(q, refs)}
        for g in (8, 16):
            for packed in (True, False):
                shape = (g, gpu_align.strip(lr, g), packed)
                if shape != chosen:
                    kernels[shape] = lambda q=q, shape=shape: gpu_align._launch(
                        q, refs, 2, -1, -2, *shape)
        for shape, fn in kernels.items():
            check(torch.equal(fn(), want), f"sw_scores at Q={n_q}, {shape}: differs")
        plain = lambda q=q: sw_scores_plain(q, refs)  # noqa: E731
        reps = 5 if n_q > SW_TIMED_Q[0] else 10
        p1 = median_ms(plain, reps=reps)
        first = {k: (median_ms(fn), back_to_back_ms(fn)) for k, fn in kernels.items()}
        second = {k: (median_ms(fn), back_to_back_ms(fn)) for k, fn in reversed(kernels.items())}
        p2 = median_ms(plain, reps=reps)
        cells = n_q * refs.shape[0] * WES_READ_LEN * lr
        least_int32 = sw_bound_ms(cells, sms, clock_max)
        least_packed = sw_bound_ms(cells, sms, clock_max, SW_PACKED_OPS_PER_CELL)
        by_shape = {}
        for shape in kernels:
            g, s, packed = shape
            ms = min(first[shape][0], second[shape][0])
            b2b = min(first[shape][1], second[shape][1])
            least = least_packed if packed else least_int32
            name = f"{gpu_align.FORMS[packed]}-G{g}xS{s}"
            by_shape[name] = {"ms": ms, "ms_back_to_back": b2b, "bound_ms": least,
                              "bound_share": least / b2b, "int32_bound_share": least_int32 / b2b}
            print(f"[sw] times at Q={n_q} Lq={WES_READ_LEN} T={refs.shape[0]} Lr={lr} "
                  f"({cells / 1e9:.3f} G cells), {gpu_align.FORMS[packed]} form, G={g}, S={s}"
                  f"{' (the chooser)' if shape == chosen else ''}: kernel {ms:.4f} ms (median of "
                  f"{REPS}), {REPS} back to back {b2b:.4f} ms per call "
                  f"({cells / b2b / 1e6:.1f} G cell updates/s), {100 * least / b2b:.1f}% of its "
                  f"form's bound" + (f", {100 * least_int32 / b2b:.1f}% of the int32 bound"
                                     if packed else "") + f"; better of two rounds; {card}",
                  flush=True)
        top = by_shape[f"{gpu_align.FORMS[chosen[2]]}-G{chosen[0]}xS{chosen[1]}"]
        timed[n_q] = {"ms": top["ms"], "ms_back_to_back": top["ms_back_to_back"],
                      "plain_ms": min(p1, p2), "bound_ms": top["bound_ms"],
                      "bound_share": top["bound_share"], "int32_bound_ms": least_int32,
                      "int32_bound_share": top["int32_bound_share"], "cells": cells,
                      "gcups": cells / top["ms_back_to_back"] / 1e6,
                      "shape": {"form": gpu_align.FORMS[chosen[2]], "G": chosen[0],
                                "S": chosen[1]}, "by_shape": by_shape}
        print(f"[sw] Q={n_q}: plain {min(p1, p2):.3f} ms (median of {reps}, better of two "
              f"rounds); bounds by operations over {sms} SMs x {SW_LANES_PER_SM} issue lanes at "
              f"the {clock_max} MHz maximum SM clock ({clock_now} MHz now): the packed form's "
              f"{least_packed:.4f} ms ({SW_PACKED_OPS_PER_CELL} instructions a cell), the int32 "
              f"form's {least_int32:.4f} ms ({SW_OPS_PER_CELL} a cell); library: none; {card}",
              flush=True)
    # a small launch: where the chooser spreads few units over more lanes
    q = torch.as_tensor(encode_seqs(reads_from(rng, exons, SW_SMALL_Q, WES_READ_LEN,
                                               n_frac=0.002)), device=dev)
    chosen = gpu_align._choice(SW_SMALL_Q, WES_READ_LEN, 3, lr, 2, -1, -2)
    small = {}
    for g in (8, 16, 32):
        shape = (g, gpu_align.strip(lr, g), True)
        fn = lambda q=q, shape=shape: gpu_align._launch(q, refs, 2, -1, -2, *shape)  # noqa: E731
        small[f"packed-G{g}xS{shape[1]}"] = min(back_to_back_ms(fn), back_to_back_ms(fn))
        print(f"[sw] times at Q={SW_SMALL_Q} ({gpu_align.units(SW_SMALL_Q, 3, True)} units), "
              f"packed form, G={g}, S={shape[1]}{' (the chooser)' if shape == chosen else ''}: "
              f"{REPS} back to back {small[f'packed-G{g}xS{shape[1]}']:.4f} ms per call; {card}",
              flush=True)
    return {"max_abs_err": err, "timed": timed, "clock_mhz": (clock_now, clock_max),
            "sass": loops, "small_q": small}


_BAM_FIXED = np.dtype([("block", "<i4"), ("refid", "<i4"), ("pos", "<i4"), ("l_name", "u1"),
                       ("mapq", "u1"), ("bin", "<u2"), ("n_cigar", "<u2"), ("flag", "<u2"),
                       ("l_seq", "<i4"), ("next_refid", "<i4"), ("next_pos", "<i4"),
                       ("tlen", "<i4")])
_NIBBLE = np.full(256, 15, dtype=np.uint8)
_NIBBLE[np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)] = np.arange(16, dtype=np.uint8)


def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """io/bamlite.py's _reg2bin over arrays."""
    end = end - 1
    out = np.zeros(beg.shape, np.int64)
    done = np.zeros(beg.shape, bool)
    for shift, first in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & (beg >> shift == end >> shift)
        out[hit] = first + (beg[hit] >> shift)
        done |= hit
    return out


def bam_records(sid: str, pos: np.ndarray, seqs: np.ndarray, flag: int = 99) -> bytes:
    """The records io/bamlite.py:encode_record writes one at a time (flag
    99, MAPQ 60, one M of the read's length, reads named f"{sid}r{j:07d}"),
    for equal-length reads [n, L] of ASCII bases, all at once."""
    n, length = seqs.shape
    names = np.frombuffer("".join(f"{sid}r{j:07d}\0" for j in range(n)).encode(),
                          np.uint8).reshape(n, -1)
    fixed = np.zeros(n, _BAM_FIXED)
    packed = (length + 1) // 2
    fixed["block"] = _BAM_FIXED.itemsize - 4 + names.shape[1] + 4 + packed + length
    fixed["pos"] = fixed["next_pos"] = pos
    fixed["l_name"], fixed["mapq"], fixed["n_cigar"] = names.shape[1], 60, 1
    fixed["bin"] = _reg2bin(pos.astype(np.int64), pos.astype(np.int64) + length)
    fixed["flag"], fixed["l_seq"] = flag, length
    nib = _NIBBLE[seqs]
    if length % 2:
        nib = np.concatenate([nib, np.zeros((n, 1), np.uint8)], axis=1)
    cigar = np.full((n, 1), length << 4, "<u4").view(np.uint8)
    return np.concatenate([fixed.view(np.uint8).reshape(n, -1), names, cigar,
                           (nib[:, 0::2] << 4) | nib[:, 1::2],
                           np.full((n, length), 0xFF, np.uint8)], axis=1).tobytes()


def fabricate_wes(root: Path, n: int, reads: int = WES_READS, seed: int = WES_SEED):
    """A WES-shaped cohort: ``n`` BAMs of ~``reads`` reads of 150 bases in the
    KIV-2 window, drawn from three exons at seeded per-sample proportions
    (1A, and the two 1B variants, which differ only in bases 165-175: a 1B
    read starting at 0-10 never reaches them and ties, one starting at 25-32
    covers them and is decisive), plus background reads of random bases that
    must stay unclassified; an exon FASTA; a neighbors file of 200 neighbors
    a sample. Returns (config, truth counts by sample, total reads)."""
    from grid_tpu_torch.io.bamlite import encode_record, write_bam

    chrom, start, end = WES_WINDOW
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    one_a = bases[rng.integers(0, 4, 160)]
    kiv3 = bases[rng.integers(0, 4, 182)]
    kiv2 = kiv3.copy()
    kiv2[165:175] = bases[(np.searchsorted(bases, kiv3[165:175]) + 2) % 4]  # every base differs
    exons = {"1A": one_a, "1B_KIV3": kiv3, "1B_KIV2": kiv2}
    (root / "aln").mkdir(parents=True)
    fasta = root / "exons.fa"
    fasta.write_text("".join(f">{k}\n{v.tobytes().decode()}\n" for k, v in exons.items()))
    ids = [f"WES{i:04d}" for i in range(n)]
    (root / "samples.txt").write_text("".join(f"{s}\n" for s in ids))
    truth, payloads = {}, []
    n_total = 0
    for sid in ids:
        n_reads = int(rng.integers(int(reads * 0.95), int(reads * 1.05)))
        exon_share, a_share, kiv3_share = rng.uniform(0.3, 0.6), rng.uniform(0.1, 0.3), \
            rng.uniform(0.3, 0.7)
        kind = rng.random(n_reads)
        src = np.where(kind >= exon_share, -1,  # background
                       np.where(kind < exon_share * a_share, 0,
                                np.where(rng.random(n_reads) < kiv3_share, 1, 2)))
        offsets = np.where(src == 0, rng.integers(0, 11, n_reads),
                           np.where(rng.random(n_reads) < 0.5, rng.integers(0, 11, n_reads),
                                    rng.integers(25, 33, n_reads)))
        seqs = bases[rng.integers(0, 4, (n_reads, WES_READ_LEN))]
        for code, exon in enumerate(exons.values()):
            rows = np.nonzero(src == code)[0]
            seqs[rows] = exon[offsets[rows, None] + np.arange(WES_READ_LEN)]
        errs = (rng.random(seqs.shape) < 0.005) & (src >= 0)[:, None]
        seqs[errs] = bases[rng.integers(0, 4, int(errs.sum()))]
        seqs[rng.random(seqs.shape) < 0.002] = ord("N")
        pos = np.sort(rng.integers(start, end - WES_READ_LEN, n_reads))
        b = src >= 1
        tied = b & (offsets <= 10)
        truth[sid] = (int((src == 1)[~tied].sum()), int((src == 2)[~tied].sum()),
                      int(tied.sum()), int((src == 0).sum()))
        payloads.append((sid, pos, seqs))
        n_total += n_reads
    # the vectorised records are bamlite's, byte for byte, on a whole sample;
    # bamlite's encoder, one record at a time in Python, is what its time
    # here would cost the whole cohort
    sid, pos, seqs = payloads[0]
    t0 = time.perf_counter()
    want = b"".join(encode_record(0, int(p), 99, read_name=f"{sid}r{j:07d}",
                                  seq=seqs[j].tobytes().decode())
                    for j, p in enumerate(pos))
    t1 = time.perf_counter()
    check(bam_records(sid, pos, seqs) == want, "the vectorised BAM records differ from "
                                               "io/bamlite.py's")
    t2 = time.perf_counter()
    print(f"[wes] one sample's {len(pos)} BAM records: io/bamlite.py's encode_record "
          f"{t1 - t0:.3f} s (x {n} samples: {(t1 - t0) * n:.1f} s on one core), the vectorised "
          f"copy {t2 - t1:.4f} s, byte-equal (host clock)", flush=True)

    def write(item):
        sid, pos, seqs = item
        write_bam(root / "aln" / f"{sid}.bam", [(chrom, WES_CHROM_LEN)],
                  [bam_records(sid, pos, seqs)])

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:  # zlib runs outside the GIL
        list(pool.map(write, payloads))
    nbrs = root / "neighbors.tsv"
    with open(nbrs, "w") as f:
        for i, sid in enumerate(ids):
            others = rng.choice(n - 1, size=min(WES_NEIGHBORS, n - 1), replace=False)
            row = [sid, f"{rng.uniform(0.9, 1.1):.4f}"]
            for o in others:
                other = ids[o + (o >= i)]
                row += [other, f"{rng.uniform(0.9, 1.1):.4f}", f"{rng.uniform(0.01, 1):.4f}"]
            f.write("\t".join(row) + "\n")
    config = {
        "samples_file": str(root / "samples.txt"), "directory_loc": str(root / "aln"),
        "reference_genome": str(fasta), "output_dir": str(root / "results"),
        "threads": os.cpu_count() or 1, "file_type": "bam", "chrom": chrom,
        "start_bp": start, "end_bp": end, "output_file_type": "tsv",
        "index": {"run": False},
        "realign": {"run": True, "exon_fasta": str(fasta), "min_score": WES_MIN_SCORE,
                    "margin": 3, "output_file_prefix": "exon_counts"},
        "exon_dipcn": {"run": True, "neighbors_file": str(nbrs), "n_neighbors": WES_NEIGHBORS,
                       "output_file_prefix": "exon_dipcn"},
        "estimate_kiv": {"run": True, "output_file_prefix": "kiv2_estimates"},
    }
    return config, truth, n_total


def wes_phase(card: str, n: int = WES_N, plain_n: int = WES_PLAIN_N,
              reads: int = WES_READS) -> int:
    """Phase 13 (c): the WES pipeline on a fabricated cohort on the card,
    held to the fabrication's truth and, on ``plain_n`` samples, to the
    plain scan on the card. Returns the kernel's launches in the run. main()
    passes no size: the size arguments let the phase be rehearsed small."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import grid_tpu_torch.ops.align as align
    from grid_tpu_torch.config import WES_SCHEMA, apply_defaults
    from grid_tpu_torch.ingest.alignments import fetch_reads_region
    from grid_tpu_torch.models.realign import classify_window_reads, read_fasta, run_realignment
    from grid_tpu_torch.ops.align import encode_seqs, sw_scores_plain
    from grid_tpu_torch.utils.device import get_device
    from grid_tpu_torch.ops.gpu_align import sw_scores_gpu
    import yaml

    import grid_tpu_torch.cli as cli

    with tempfile.TemporaryDirectory(prefix="grid_tpu_torch_wes_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        config, truth, n_total = fabricate_wes(root, n, reads)
        fab_s = time.perf_counter() - t0
        print(f"[wes] cohort: {n} BAMs, {n_total} reads of {WES_READ_LEN} bases "
              f"({n_total / n:.0f} a sample) in {WES_WINDOW[0]}:{WES_WINDOW[1]:,}-"
              f"{WES_WINDOW[2]:,}, exons of 160/182/182, {WES_NEIGHBORS} neighbors a sample, "
              f"fabricated in {fab_s:.1f} s (host clock); {config['threads']} threads; "
              f"{n} samples is a cut forced by the time limit", flush=True)
        config = apply_defaults(config, schema=WES_SCHEMA)  # so validation warns of nothing
        config_file = root / "wes.yaml"
        config_file.write_text(yaml.safe_dump(config, sort_keys=False))
        # `python -m grid_tpu_torch.cli wes CONFIG`, in this process so its
        # launches are counted, its console a recorder; no platform named:
        # the card. The profiler gives the run's own device time: every
        # worker thread uses the one default stream, so its copies and
        # kernels do not overlap and their times add up
        console = Recorder()
        sw_scores_gpu.launches = 0
        with patched(cli, {"make_console": lambda: console}), \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cli.cli.main(args=["wes", str(config_file)], standalone_mode=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = sw_scores_gpu.launches
        check(not console.failures(), f"the WES run logged failures: {console.failures()}")
        check(launches == n, f"sw_scores launched {launches} times for {n} samples with reads")
        out = Path(config["output_dir"])
        rows = {line.split("\t")[0]: tuple(int(v) for v in line.split("\t")[1:])
                for line in (out / "exon_counts.tsv").read_text().splitlines()}
        wrong = sorted(s for s in truth if rows.get(s) != truth[s])
        check(not wrong, f"exon counts differ from the fabrication on {len(wrong)} samples, "
                         f"e.g. {wrong[:1]}: {[rows.get(s) for s in wrong[:1]]} vs "
                         f"{[truth[s] for s in wrong[:1]]}")
        classified = sum(sum(v) for v in rows.values())
        for name in ("exon_dipcn.1A.tsv", "exon_dipcn.1B.tsv", "kiv2_estimates.tsv"):
            lines = (out / name).read_text().splitlines()
            values = np.array([[float(v) for v in line.split("\t")[1:]] for line in lines[1:]])
            check(len(lines) == n + 1 and np.isfinite(values).all(),
                  f"{name}: {len(lines) - 1} rows for {n} samples, or non-finite values")
        spans = json.loads((out / "step_timings.json").read_text())
        ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if ops:
            device_s = sum(device_us(e) for e in ops) / 1e6
            own = [e for e in ops if "sw_" in e.key and "kernel" in e.key]
            share = (f"device time {device_s:.4f} s in {sum(e.count for e in ops)} device ops "
                     f"(torch.profiler over the run: the kernel {sum(e.count for e in own)} "
                     f"launches, {sum(device_us(e) for e in own) / 1e6:.4f} s; copies and fills "
                     f"the rest), host share {100 * (1 - device_s / wall):.2f}%")
        else:
            share = "torch.profiler saw no device activity: device time and host share not measured"
        print(f"[wes] `grid_tpu_torch.cli wes` on the card: {wall:.3f} s under the profiler; "
              f"step_timings.json "
              f"{', '.join(f'{k} {v:.3f} s' for k, v in sorted(spans.items()))}; sw_scores "
              f"launches {launches} (one a sample); {share}; {card}", flush=True)
        print(f"[wes] counts equal the fabrication's truth on all {n} samples: {classified} of "
              f"{n_total} reads classified, every background read unclassified, every decisive "
              f"1B read to its variant and every tied one to 1B_tied; both exon dipCN files and "
              f"the KIV-2 estimates written, finite, one row a sample", flush=True)

        # the same call on plain_n samples with the scores sent to the plain
        # scan on the card: the counts must be the same bytes
        sub = root / "aln_plain"
        sub.mkdir()
        for sid in sorted(truth)[:plain_n]:
            (sub / f"{sid}.bam").symlink_to(root / "aln" / f"{sid}.bam")
        plain_file = root / "plain_counts.tsv"
        sw_scores_gpu.launches = 0
        t0 = time.perf_counter()
        console = Recorder()
        with patched(align, {"sw_scores": sw_scores_plain}):
            run_realignment(sub, config["realign"]["exon_fasta"], config["chrom"],
                            config["start_bp"], config["end_bp"], plain_file,
                            min_score=WES_MIN_SCORE, margin=3, threads=config["threads"],
                            console=console, device="cuda")
        plain_s = time.perf_counter() - t0
        check(not console.failures(), f"the plain route logged failures: {console.failures()}")
        check(sw_scores_gpu.launches == 0, "the plain route launched the kernel")
        want = "".join(line + "\n" for line in (out / "exon_counts.tsv").read_text()
                       .splitlines() if line.split("\t")[0] in set(sorted(truth)[:plain_n]))
        check(plain_file.read_text() == want, "the plain route's counts differ from the "
                                              "kernel's")
        print(f"[wes] the plain scan on the card on {plain_n} of the samples: counts "
              f"byte-equal to the kernel run's rows; realignment {plain_s:.3f} s (host clock)",
              flush=True)

        # where a sample's time goes, on one thread (host clock)
        dev = get_device("cuda")
        exons = read_fasta(config["realign"]["exon_fasta"])
        refs = torch.as_tensor(encode_seqs(list(exons.values())), device=dev)
        parts = dict.fromkeys(("fetch", "encode", "scores", "classify"), 0.0)
        sampled = sorted(truth)[:WES_BREAKDOWN_N]
        for sid in sampled:
            t0 = time.perf_counter()
            seqs = fetch_reads_region(root / "aln" / f"{sid}.bam", None, *WES_WINDOW)[3]
            t1 = time.perf_counter()
            queries = encode_seqs(seqs)
            t2 = time.perf_counter()
            align.sw_scores(torch.as_tensor(queries, device=dev), refs).cpu()
            t3 = time.perf_counter()
            classify_window_reads(seqs, exons, WES_MIN_SCORE, 3, device=dev)
            t4 = time.perf_counter()
            parts["fetch"] += t1 - t0
            parts["encode"] += t2 - t1
            parts["scores"] += t3 - t2
            parts["classify"] += (t4 - t3) - (t3 - t1)  # its Python loops alone
        print(f"[wes] one sample on one thread (mean of {len(sampled)}, host clock): "
              f"{', '.join(f'{k} {v / len(sampled) * 1e3:.2f} ms' for k, v in parts.items())} "
              f"(scores: the kernel, its launch and the copy back; classify: "
              f"classify_reads' and classify_window_reads' Python loops); {card}", flush=True)
    return launches


def panel_haplotypes(n_samples: int, n_sites: int, seed: int, n_founders: int = 8,
                     switch_rate: float = 0.01, mutation_rate: float = 0.002) -> np.ndarray:
    """H [2 n_samples, n_sites] uint8 of ``make_synthetic_phased_panel``'s
    model (mosaics of founder haplotypes with rare mutations), made in numpy
    without writing a VCF: at this size the VCF writer alone would take
    minutes."""
    rng = np.random.default_rng(seed)
    n_hap = 2 * n_samples
    founders = rng.integers(0, 2, size=(n_founders, n_sites), dtype=np.uint8)
    source = np.empty((n_hap, n_sites), dtype=np.int64)
    source[:, 0] = rng.integers(0, n_founders, size=n_hap)
    switches = rng.random(size=(n_hap, n_sites)) < switch_rate
    for j in range(1, n_sites):
        source[:, j] = np.where(switches[:, j], rng.integers(0, n_founders, size=n_hap),
                                source[:, j - 1])
    H = founders[source, np.arange(n_sites)]
    H ^= (rng.random(size=H.shape) < mutation_rate).astype(np.uint8)
    return H


def panel_map(n_sites: int, seed: int) -> np.ndarray:
    """cM positions of sites 1 kb apart at 0.5-2 cM/Mb (the synthetic panel's
    genetic map)."""
    rates = np.random.default_rng(seed).uniform(0.5, 2.0, size=n_sites)
    return np.concatenate([[0.0], np.cumsum(rates[1:] * 1e-3)])


def ibs_engine_phase(card: str, engine: tuple = IBS_ENGINE, exact: tuple = IBS_CHECK) -> None:
    """Phase 14 (a): the host library's PBWT engine at the JAX package's
    engine shape on 1 thread and on all cores (the two results identical),
    and against the numpy engine, its plain version, on a cut the numpy
    engine finishes in seconds (identical ``idx``, ``cmlen``, ``cmedge``,
    ``count``). main() passes no size: the sizes let it be rehearsed small."""
    from grid_tpu_torch import native_host
    from grid_tpu_torch.native_host.ibs import pbwt_ibs_neighbors as native_engine
    from grid_tpu_torch.ops.pbwt import pbwt_ibs_neighbors as numpy_engine

    check(native_host.route() == "native", f"the host library did not load: {native_host.route()}")
    threads = os.cpu_count() or 1
    n, sites, k = engine
    t0 = time.perf_counter()
    H = panel_haplotypes(n, sites, IBS_SEED)
    cm = panel_map(sites, IBS_SEED)
    f = sites // 2
    focal_cm = float((cm[f - 1] + cm[f]) / 2)
    made_s = time.perf_counter() - t0
    runs = {}
    for t in sorted({1, threads}):
        t0 = time.perf_counter()
        out = native_engine(H, cm, f, focal_cm, k, threads=t)
        runs[t] = (time.perf_counter() - t0, out)
    one = runs[1][1]
    for t, (_, out) in runs.items():
        check(all(np.array_equal(a, b) for a, b in zip(out, one)),
              f"the native engine on {t} threads differs from 1 thread")
    check(bool((one[3] == k).all()), "the native engine found fewer than k neighbors")
    print(f"[ibs] native PBWT engine, {2 * n} haplotypes x {sites} sites (made in numpy in "
          f"{made_s:.1f} s; the sites a cut of a chromosome), k={k}: "
          + "; ".join(f"{t} thread(s) {sec:.3f} s ({2 * n / sec:.0f} haplotypes/s)"
                      for t, (sec, _) in runs.items())
          + f"; the results identical on every thread count (host clock); {card}", flush=True)

    n, sites, k = exact
    H = panel_haplotypes(n, sites, IBS_SEED + 1)
    cm = panel_map(sites, IBS_SEED + 1)
    f = sites // 2
    focal_cm = float((cm[f - 1] + cm[f]) / 2)
    t0 = time.perf_counter()
    want = numpy_engine(H, cm, f, focal_cm, k)
    numpy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = native_engine(H, cm, f, focal_cm, k, threads=threads)
    native_s = time.perf_counter() - t0
    for name, a, b in zip(("idx", "cmlen", "cmedge", "count"), got, want):
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"the native engine's {name} differs from the numpy engine's")
    print(f"[ibs] native vs numpy engine, {2 * n} haplotypes x {sites} sites, k={k}: idx, cmlen, "
          f"cmedge and count identical; numpy {numpy_s:.3f} s, native {native_s:.4f} s on "
          f"{threads} thread(s) (host clock)", flush=True)


def ibs_pipeline_phase(card: str, counted: dict, tmp: Path, cohort: dict, base: dict,
                       names: dict, resident_launches: dict, k: int, n_nbr: int) -> dict:
    """Phase 14 (b) and (c), on phase 9's cohort: the ``ibs`` command on a
    grouped panel's VCF and BGEN (the two files equal), then
    ``run_wgs_pipeline`` with ``compute_ibs.run: true`` and no platform named
    (the fused steps on the card, the IBS file equal to the command's, the
    haploid table equal to the plain route rebuilt from the run's own files,
    the haplotype allocation correlated with the truth). Returns the kernels'
    launches during the pipeline call."""
    from grid_tpu_torch import native_host
    from grid_tpu_torch.config import apply_defaults
    from grid_tpu_torch.io.formats import read_normalized_data
    from grid_tpu_torch.io.phased import write_phased_bgen
    from grid_tpu_torch.pipeline import run_wgs_pipeline
    from grid_tpu_torch.synth import make_synthetic_phased_panel

    import grid_tpu_torch.cli as cli

    n = len(cohort["ids"])
    threads = os.cpu_count() or 1
    focal_bp = (base["start_bp"] + base["end_bp"]) // 2
    hap_cn = cohort["hap_cn"].reshape(-1)
    groups = np.searchsorted(np.quantile(hap_cn, [0.25, 0.5, 0.75]), hap_cn)
    t0 = time.perf_counter()
    # the panel's middle site is the VNTR window's midpoint
    panel = make_synthetic_phased_panel(
        tmp / "panel", n_samples=n, n_sites=IBS_PANEL_SITES, chrom=base["chrom"],
        start_bp=focal_bp - 1000 * (IBS_PANEL_SITES // 2) + 500, seed=IBS_SEED,
        hap_groups=groups)
    check(panel["focal_bp"] == focal_bp, f"the panel's focus {panel['focal_bp']} != {focal_bp}")
    bgen = write_phased_bgen(tmp / "panel.bgen", panel["ids"], panel["H"], panel["positions"],
                             chrom=panel["chrom"])
    print(f"[ibs] grouped panel of phase 9's cohort: {n} samples x {IBS_PANEL_SITES} sites (VCF "
          f"and BGEN), haplotypes in 4 groups by quartiles of the true haplotype CN, made in "
          f"{time.perf_counter() - t0:.1f} s (host clock)", flush=True)

    # ---- (b) the command, on the VCF and on the BGEN ----------------------
    files, cmd_s = {}, {}
    for kind, path in (("vcf", panel["vcf"]), ("bgen", bgen)):
        files[kind] = tmp / f"ibs_cli_{kind}.tsv.gz"
        console = Recorder()
        args = ["ibs", f"--{kind}", str(path), "--genetic-map", str(panel["genetic_map"]),
                "--focal-bp", str(focal_bp), "-k", str(IBS_K), "-t", str(threads),
                "-o", str(files[kind])]
        native_host.fallbacks.clear()
        t0 = time.perf_counter()
        with patched(cli, {"make_console": lambda: console}):
            cli.cli.main(args=args, standalone_mode=False)
        cmd_s[kind] = time.perf_counter() - t0
        check(not console.failures(), f"ibs --{kind} logged failures: {console.failures()}")
        check(not native_host.fallbacks, f"ibs --{kind}: fallbacks {dict(native_host.fallbacks)}")
    check(content(files["vcf"]) == content(files["bgen"]),
          "the ibs command's files from the VCF and the BGEN differ")
    rows = content(files["vcf"]).count(b"\n") - 1
    check(rows == 2 * n * IBS_K, f"the neighbor file has {rows} rows, not {2 * n * IBS_K}")
    print(f"[ibs] `grid_tpu_torch.cli ibs` in this process, k={IBS_K}, {threads} threads: VCF "
          f"{cmd_s['vcf']:.3f} s, BGEN {cmd_s['bgen']:.3f} s (host clock, reading the panel "
          f"included); the two neighbor files equal after decompression ({rows} rows)",
          flush=True)

    # ---- (c) the pipeline: compute_ibs in front of the fused steps --------
    out = tmp / "ibs_run"
    out.mkdir()
    cfg = copy.deepcopy(base)
    cfg["output_dir"] = str(out)
    cfg["device"] = {"fused": True}
    cfg["compute_ibs"] = {"run": True, "vcf": str(panel["vcf"]), "focal_bp": focal_bp,
                          "genetic_map": str(panel["genetic_map"]), "num_neighbors": IBS_K}
    cfg["compute_haploid_genotypes"]["ibs_output"] = None
    cfg = apply_defaults(cfg)  # so validation warns of nothing
    (out / "read_counts.tsv").write_bytes(cohort["counts_file"].read_bytes())
    for fn in counted.values():
        fn.launches = 0
    native_host.fallbacks.clear()
    console = Recorder()
    t0 = time.perf_counter()
    t = run_wgs_pipeline(console, config=cfg)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    check(not console.failures(), f"the compute_ibs run logged failures: {console.failures()}")
    check(not native_host.fallbacks, f"the compute_ibs run: fallbacks "
                                     f"{dict(native_host.fallbacks)}")
    check(launches == resident_launches, f"compute_ibs run launches {launches} != "
                                         f"{resident_launches}")
    check("compute_ibs" in t and "fused_steps_4_7" in t, f"compute_ibs run timings {sorted(t)}")
    ibs_file = out / "ibs_neighbors.tsv.gz"
    check(content(ibs_file) == content(files["vcf"]),
          "the pipeline's IBS file differs from the ibs command's")
    ids, ratios, z, scales = read_normalized_data(out / names["normalized"])
    own = rebuild_from_files("ibs", out, names, ids, ratios, z, scales, ibs_file, k, n_nbr,
                             fused=True)
    lines = (out / names["haploid"]).read_text().splitlines()[1:]
    est = {ln.split("\t")[0]: (float(ln.split("\t")[2]), float(ln.split("\t")[3]))
           for ln in lines}
    row = {sid: i for i, sid in enumerate(cohort["ids"])}
    e, truth = [], []
    for sid, (h1, h2) in est.items():
        if np.isfinite(h1 + h2) and h1 + h2 > 0:
            t1, t2 = cohort["hap_cn"][row[sid]]
            e.append(h1 / (h1 + h2))
            truth.append(t1 / (t1 + t2))
    rho = float(np.corrcoef(e, truth)[0, 1])
    check(rho > IBS_MIN_RHO, f"haplotype allocation vs the truth: rho {rho:.3f} <= {IBS_MIN_RHO}")
    spans = ("fused.stage", "fused.device", "fused.phase", "fused.write")
    host = 1 - (t["fused.device"] + t["fused.phase"]) / wall
    print(f"[ibs] run_wgs_pipeline with compute_ibs, no platform named: kernel launches "
          f"{launches}; no fallback counted; the IBS file equals the command's; haploid "
          f"allocation vs the truth rho {rho:.3f} over {len(e)} samples "
          f"({len(own.dip_ids)} dipCN rows)", flush=True)
    print(f"[ibs] spans: compute_ibs {t['compute_ibs']:.3f} s, "
          + ", ".join(f"{s} {t[s]:.3f} s" for s in spans)
          + f", fused_steps_4_7 {t['fused_steps_4_7']:.3f} s; the whole call {wall:.3f} s "
          f"(host clock); host share of the call (all but fused.device and fused.phase) "
          f"{100 * host:.2f}%; {card}", flush=True)
    return {name: launches[name] for name in counted}


def tools_phase(card: str, bam_n: int = TOOLS_BAM_N, cram_n: int = TOOLS_CRAM_N) -> None:
    """Phase 14 (d): ``batch-crai`` and ``batch-subset`` to the VNTR window
    on fabricated BAMs and CRAMs; the subsets' records equal the native
    reader's records of the same region in the source files, a CRAM subset
    (the host library's verbatim writer) decodes through cramlite to the
    source's records, and no fallback is counted."""
    from grid_tpu_torch import native_host
    from grid_tpu_torch.io import cramlite
    from grid_tpu_torch.native_host import bam as native_bam
    from grid_tpu_torch.native_host import cram as native_cram
    from grid_tpu_torch.synth import make_synthetic_cohort_with_alignments

    import grid_tpu_torch.cli as cli

    check(native_host.route() == "native", f"the host library did not load: {native_host.route()}")
    threads = os.cpu_count() or 1
    chrom, start, end = TOOLS_WINDOW
    with tempfile.TemporaryDirectory(prefix="grid_tpu_torch_tools_") as tmp:
        root = Path(tmp)
        dirs, times = {}, {}
        for kind, n in (("bam", bam_n), ("cram", cram_n)):
            t0 = time.perf_counter()
            cohort = make_synthetic_cohort_with_alignments(
                root / kind, n_samples=n, seed=ALIGN_SEED, mean_depth=ALIGN_DEPTH,
                window_start=start, window_end=end, file_type=kind,
                indel_frac=0.1 if kind == "cram" else 0.0)
            fab_s = time.perf_counter() - t0
            dirs[kind] = Path(cohort["config"]["directory_loc"])
            native_host.fallbacks.clear()
            for command, args in (
                    ("batch-crai", ["-C", str(dirs[kind]), "-t", str(threads)]),
                    ("batch-subset", ["-C", str(dirs[kind]), "-c", chrom, "-s", str(start),
                                      "-e", str(end), "-o", str(root / f"{kind}_subsets"),
                                      "-t", str(threads)])):
                console = Recorder()
                t0 = time.perf_counter()
                with patched(cli, {"make_console": lambda: console}):
                    cli.cli.main(args=[command, *args], standalone_mode=False)
                times[kind, command] = time.perf_counter() - t0
                check(not console.failures(), f"{command} on {kind}: {console.failures()}")
                done = console.styled("success")
                check(done and done[-1].split()[1].startswith(f"{n}/{n}"),
                      f"{command} on {kind}: {done}")
            check(not native_host.fallbacks, f"the tools on {kind}: fallbacks "
                                             f"{dict(native_host.fallbacks)}")
            print(f"[tools] {n} {kind.upper()}s of phase 12's shape, fabricated in {fab_s:.1f} s: "
                  f"batch-crai {times[kind, 'batch-crai']:.3f} s, batch-subset to "
                  f"{chrom}:{start:,}-{end:,} {times[kind, 'batch-subset']:.3f} s on {threads} "
                  f"thread(s) (host clock, in this process); {card}", flush=True)

        records = 0
        for src in sorted(dirs["bam"].glob("*.bam")):
            sub = root / "bam_subsets" / f"{src.stem}_subset.bam"
            got = native_bam.fetch_reads(sub, chrom, 0, 1 << 40, exclude_flags=0)
            # every read is 100 bases with no indel: those overlapping the
            # window start at most 99 bases before it
            want = native_bam.fetch_reads(src, chrom, start - 99, end, exclude_flags=0)
            check(all(np.array_equal(a, b) for a, b in zip(got[:3], want[:3]))
                  and got[3] == want[3], f"{sub.name}: records differ from the source's window")
            records += len(got[0])
        cram_records = 0
        for i, src in enumerate(sorted(dirs["cram"].glob("*.cram"))):
            sub = root / "cram_subsets" / f"{src.stem}_subset.cram"
            got = native_cram.dump_records(sub)
            every = native_cram.dump_records(src)
            want = every[(every[:, 0] == 0) & (every[:, 1] < end)
                         & (every[:, 1] + np.maximum(every[:, 5], 1) > start)]
            check(np.array_equal(got, want), f"{sub.name}: records differ from the source's "
                                             f"window")
            cram_records += len(got)
            if i == 0:
                with cramlite.CramReader(sub) as rd:
                    decoded = [(r.name, r.flag, r.pos, r.seq, r.cigar) for r in rd.iter_records()]
                with cramlite.CramReader(src) as rd:
                    source = [(r.name, r.flag, r.pos, r.seq, r.cigar)
                              for r in rd.iter_records(chrom, start, end)]
                check(decoded == source, f"{sub.name} does not decode through cramlite to the "
                                         "source's records")
        print(f"[tools] subsets equal the native reader's records of the window in the sources: "
              f"{records} BAM records in {bam_n} files, {cram_records} CRAM records in {cram_n} "
              f"(the native verbatim writer); one CRAM subset decodes through cramlite to the "
              f"source's records with their CIGARs; no fallback counted", flush=True)


def ibs_phase(card: str, wrappers: dict) -> dict:
    """Phase 14 alone: phase 9's cohort fabricated again (as
    ``pipeline_phase`` does), (b) and (c) on it, then (a) and (d). Returns
    the kernels' launches of (c). main() runs (b) and (c) inside
    ``pipeline_phase`` instead, on the cohort it already has."""
    from grid_tpu_torch.ops.gpu_kernels import zprep_gram_panel, zprep_split
    from grid_tpu_torch.synth import make_synthetic_cohort

    counted = {**wrappers, "zprep_split": zprep_split, "zprep_gram_panel": zprep_gram_panel}
    names = {"normalized": "mosdepth_results_normalized.tsv.gz",
             "neighbors": f"neighbor_coverage.zMax{ZMAX:.1f}.tsv.gz",
             "dipcn": "diploid_genotypes.tsv", "haploid": "haploid_genotypes.tsv"}
    with tempfile.TemporaryDirectory(prefix="grid_tpu_torch_ibs_") as tmp:
        tmp = Path(tmp)
        cohort = make_synthetic_cohort(tmp / "cohort", n_samples=PIPELINE_N,
                                       flank_bins=PIPELINE_FLANK, missing_frac=0.02,
                                       seed=PIPELINE_SEED)
        base = cohort["config"]
        base["mosdepth"]["neighbors"]["num_neighbors"] = K
        base["compute_diploid_genotypes"]["n_nbr"] = N_NBR
        base["compute_haploid_genotypes"].update(max_neighbors=10, n_iters=N_ITERS)
        launches = ibs_pipeline_phase(card, counted, tmp, cohort, base, names,
                                      {**PIPELINE_LAUNCHES, "zprep_split": 0,
                                       "zprep_gram_panel": 0}, K, N_NBR)
    ibs_engine_phase(card)
    tools_phase(card)
    return {name: launches[name] for name in wrappers}


def dipcn_mode_table(dev, card: str, rows: int = MODE_TABLE_ROWS, reps: int = 5) -> dict:
    """Phase 5: ``dipcn_select``'s binary form in both modes on the same
    [rows, W] rows (quantized distances with the finfo.max of self and
    invalid columns, as a cohort's), at each width of MODE_TABLE_W and k=K,
    in float32, float64 and bfloat16: the outputs bitwise equal, each mode
    back to back (resident, wide, wide, resident; the better of its two),
    the resident mode's blocks an SM (0 where its shared memory does not
    fit: the wide mode alone), and the mode the rule picks; N=2504 must
    stay resident in every dtype and a 65,536-column bf16 row go wide.
    Returns {dtype: {W: the row}}."""
    from grid_tpu_torch.ops.gpu_select import _launch, dipcn_select_info, dipcn_select_mode

    gen = torch.Generator(device=dev).manual_seed(1)
    table = {}
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        kind = str(dtype).removeprefix("torch.")
        table[kind] = {}
        for w in MODE_TABLE_W:
            d2 = (torch.randint(0, 400, (rows, w), device=dev, generator=gen) * 0.25).to(dtype)
            d2[:, torch.rand(w, device=dev, generator=gen) < 0.05] = torch.finfo(dtype).max
            vec = (torch.rand(w, device=dev, generator=gen) + 0.5).to(dtype)
            usable = torch.rand(w, device=dev, generator=gen) > 0.2
            args = (d2, vec[:rows].contiguous(), vec, usable, usable[:rows].contiguous())
            blocks = dipcn_select_info(w, K, dev, dtype=dtype, mode="resident")["blocks_per_sm"]
            wide_blocks = dipcn_select_info(w, K, dev, dtype=dtype, mode="wide")["blocks_per_sm"]
            run = {mode: (lambda mode=mode: _launch(mode, *args, K, N_NBR))
                   for mode in (("resident", "wide") if blocks else ("wide",))}
            outs = {mode: fn() for mode, fn in run.items()}
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(outs["wide"], outs.get("resident",
                                                                                outs["wide"]))),
                  f"dipcn_select {kind} W={w}: the wide mode differs from the resident mode")
            order = [*run, *reversed(run)]
            rounds = [(mode, back_to_back_ms(run[mode], reps=reps, warmup=1)) for mode in order]
            times = {mode: min(t for m, t in rounds if m == mode) for mode in run}
            picked = dipcn_select_mode(w, K, dev, dtype)
            table[kind][str(w)] = {"resident_blocks_per_sm": blocks,
                                   "wide_blocks_per_sm": wide_blocks, "picked": picked,
                                   **{f"{mode}_ms": t for mode, t in times.items()}}
            faster = min(times, key=times.get)
            print(f"[times] dipcn_select {kind} modes at [{rows}, {w}], k={K}: "
                  + ", ".join(f"{mode} {t:.4f} ms" for mode, t in times.items())
                  + f" ({reps} back to back, better of two; resident {blocks} blocks an SM, wide "
                  f"{wide_blocks}); outputs bitwise equal; the rule picks {picked}, the faster is "
                  f"{faster}; {card}", flush=True)
            del d2, args, outs, run
    check(all(table[kind][str(N)]["picked"] == "resident" for kind in table),
          f"dipcn_select at W={N} must stay resident in every dtype")
    check(table["bfloat16"][str(PANEL_N)]["picked"] == "wide",
          f"dipcn_select on {PANEL_N}-column bf16 rows must take the wide mode")
    torch.cuda.empty_cache()
    return table


@contextmanager
def plain_calls_counted():
    """Count the calls of the plain versions that the kernels' wrappers
    would take (their module attributes) for the ``with`` block: on a card
    run every count must stay 0. Yields the counts."""
    import grid_tpu_torch.ops.gpu_kernels as gk
    import grid_tpu_torch.ops.gpu_select as gs
    import grid_tpu_torch.ops.phasing as ph

    counts = Counter()
    targets = {gk: ("masked_column_stats_plain", "zprep_gram_plain", "zprep_split_plain",
                    "zprep_gram_panel_plain", "zprep_gram_cross_plain"),
               gs: ("dipcn_from_distances", "dipcn_from_distances_multi", "sorted_smallest_k"),
               ph: ("phase_sweeps",)}

    def counting(name, fn):
        def call(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return call

    saved = [(m, name, getattr(m, name)) for m, names in targets.items() for name in names]
    for m, name, fn in saved:
        setattr(m, name, counting(name, fn))
    try:
        yield counts
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def step_wrappers() -> dict:
    """The cohort step's kernel wrappers by name, whose launch counts the
    card runs read: the three of the earlier kernels, the split and the
    panel Gram, and the selection and phasing kernels."""
    from grid_tpu_torch.ops.gpu_kernels import (
        masked_column_stats, zprep_gram, zprep_gram_panel, zprep_split,
    )
    from grid_tpu_torch.ops.gpu_select import dipcn_from_distances_gpu, sorted_smallest_k_gpu
    from grid_tpu_torch.ops.phasing import phase_sweeps_gpu

    return {"masked_column_stats": masked_column_stats, "zprep_gram": zprep_gram,
            "zprep_split": zprep_split, "zprep_gram_panel": zprep_gram_panel,
            "dipcn_from_distances_gpu": dipcn_from_distances_gpu,
            "sorted_smallest_k_gpu": sorted_smallest_k_gpu, "phase_sweeps_gpu": phase_sweeps_gpu}


def kernels_phase(dev, card: str, dtype, values_np, mask_np, reads_np, sms: int):
    """Phases 3-6 at N=2504 in ``dtype`` (float64: phase 17 (a, b, e);
    bfloat16: phase 18 (a)): the kernels' launch shapes; each kernel against
    its plain version on the card at TOL[dtype] (3); the step against the
    port's CPU route in the same dtype, every kernel launched and no plain
    version reached (4); the step and each kernel timed, with its bound and
    library call (5); the step's device time by kernel (6). In bfloat16 the
    four kernels of steps 4-6 run their bf16 forms, held within BF16_ULPS
    (the column statistics, the Gram) or bitwise (the selections); the
    sweeps run in float32 (step 7 computes as under auto) and are phase 3's
    float32 kernel, so they are neither held nor timed again. Returns a
    namespace: the kernels' rows, the step's tie counts, and what phase 5's
    float32 timings go on with."""
    from grid_tpu_torch.convert import inputs_to_torch, outputs_to_numpy
    from grid_tpu_torch.models.cohort import CohortParams, cohort_step, d2_resident
    from grid_tpu_torch.ops.gpu_kernels import (
        _r_pad, masked_column_stats, masked_column_stats_plain, zprep_gram, zprep_gram_info,
        zprep_gram_panel, zprep_gram_plain, zprep_split,
    )
    from grid_tpu_torch.ops.gpu_select import (
        KNN_BF16_MAX_W, KNN_MAX_K, _knn_launch, dipcn_from_distances_gpu, dipcn_select_info,
        knn_select_info, sorted_smallest_k_gpu,
    )
    from grid_tpu_torch.ops.knn import d2_matrix, prepare_z, region_filter_mask, sorted_smallest_k
    from grid_tpu_torch.ops.masked import masked_mean
    from grid_tpu_torch.ops.normalize import normalize_cohort, select_high_variance_mask
    from grid_tpu_torch.ops.phasing import (
        _sweeps_launch, phase_sweeps, phase_sweeps_gpu, phase_sweeps_info, phase_sweeps_mode,
    )
    from grid_tpu_torch.ops.select import dipcn_from_distances
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch_parity import assert_close_to_max, bf16_gram_ratio, bf16_ulps
    from torch_plans import zprep_gram64_l2_bytes

    f32, tol, e = dtype == torch.float32, TOL[dtype], torch.finfo(dtype).bits // 8
    half = dtype == torch.bfloat16
    wide = torch.float32 if half else dtype  # the reads' and the sweeps' dtype
    big = torch.finfo(dtype).max
    tag = {torch.float32: "", torch.float64: " f64", torch.bfloat16: " bf16"}[dtype]
    kind = str(dtype).removeprefix("torch.")

    def close(got, want, rtol) -> bool:
        """Within rtol, or within BF16_ULPS in bfloat16 (rtol None)."""
        if half and rtol is None:
            return bf16_ulps(got.float().cpu().numpy(), want.float().cpu().numpy()) <= BF16_ULPS
        return torch.allclose(got, want, rtol=rtol, atol=0)

    # ---- launch shapes ---------------------------------------------------
    info = zprep_gram_info(N, dev, dtype)
    if half:
        print(f"[build{tag}] zprep_gram {kind} at N={N}: {gram16_shape(info, sms)}", flush=True)
        check(info["spill_bytes"] == 0, "zprep_gram bf16 spills to local memory")
    else:
        print(f"[build{tag}] zprep_gram {kind} at N={N}: {info['blocks']} blocks (upper-triangle "
              f"tiles of {info['tile']}x{info['tile']}) on {sms} SMs at {info['blocks_per_sm']} "
              f"block(s) per SM; {info['threads']} threads and {info['smem_bytes']} B of dynamic "
              f"shared memory per block, a {info['stages']}-stage ring of {info['k_tile']}-column "
              f"stages", flush=True)
    dinfo = dipcn_select_info(N, K, dev, dtype=dtype)
    print(f"[build{tag}] dipcn_select {kind} at W={N}, k={K}: one block of {dinfo['threads']} "
          f"threads per row, {dinfo['smem_bytes']} B dynamic + {dinfo['static_smem_bytes']} B "
          f"static shared memory per block, {dinfo['blocks_per_sm']} blocks per SM "
          f"({min(N, dinfo['blocks_per_sm'] * sms)} of {N} rows in flight); "
          f"{dinfo['registers']} registers and {dinfo['spill_bytes']} B of local memory a thread",
          flush=True)
    check(dinfo["spill_bytes"] == 0, f"dipcn_select {kind} spills to local memory")
    kinfo = knn_select_info(N, K, dev, dtype=dtype)
    print(f"[build{tag}] knn_select {kind} at W={N}, k={K}: {kinfo['mode']} mode, one block of "
          f"{kinfo['threads']} threads per row, {kinfo['smem_bytes']} B dynamic + "
          f"{kinfo['static_smem_bytes']} B static shared memory per block, "
          f"{kinfo['blocks_per_sm']} blocks per SM ({min(N, kinfo['blocks_per_sm'] * sms)} of "
          f"{N} rows in flight); {kinfo['registers']} registers and {kinfo['spill_bytes']} B of "
          f"local memory a thread", flush=True)
    pinfo = phase_sweeps_info(N, 2, dev, dtype=wide)  # the slice's ring lists: 2 slots
    print(f"[build{tag}] phase_sweeps {str(wide).removeprefix('torch.')} at N={N}, K=2: "
          f"{pinfo['mode']} mode, a cluster of "
          f"{pinfo['cluster_blocks']} blocks of {pinfo['threads']} threads per replicate, "
          f"{pinfo['smem_bytes']} B of shared memory a block (the values double-buffered and "
          f"an eighth of the lists), {pinfo['blocks_per_sm']} block(s) per SM, "
          f"{pinfo['clusters']} clusters at once; {pinfo['registers']} registers and "
          f"{pinfo['spill_bytes']} B of local memory a thread", flush=True)
    check(kinfo["mode"] == "resident" and kinfo["spill_bytes"] == 0, "knn_select launch shape")
    check(pinfo["mode"] == "resident" and pinfo["spill_bytes"] == 0, "phase_sweeps launch shape")

    # ---- 3. kernels against their plain versions -------------------------
    rng = np.random.default_rng(0)
    values = torch.tensor(values_np, dtype=dtype, device=dev)
    mask = torch.tensor(mask_np, device=dev)
    # the cohort step's own inputs to each kernel (its d2-resident prefix)
    norm = normalize_cohort(values, mask, round_squares=False)  # bf16: as the step takes it
    selected = select_high_variance_mask(norm.var_ratio)
    ratios_seen = torch.where(selected, norm.var_ratio, torch.nan)
    region = selected & region_filter_mask(ratios_seen, n_written=selected.sum())
    sample_ok = norm.mask.any(dim=1)
    d2 = d2_matrix(norm.z, norm.mask, region, ZMAX, row_valid=sample_ok)
    w_main = (torch.tensor(reads_np, dtype=wide, device=dev) / norm.row_means_raw).to(dtype)
    cs_kw = {"round_squares": False} if half else {}

    def colstats_case(vals, msk):
        rm = masked_mean(vals, msk, axis=1)
        ok = torch.isfinite(rm) & (rm != 0)
        # bf16 divides by the row means, float32 and float64 scale by 1 / them
        row = torch.where(ok, rm, 1) if half else torch.where(ok, 1 / torch.where(ok, rm, 1), 0)
        return vals, msk & ok[:, None], row

    ragged_vals = torch.tensor(rng.uniform(10, 60, RAGGED), dtype=dtype, device=dev)
    ragged_mask = torch.tensor(rng.random(RAGGED) > 0.15, device=dev)
    errs = {}

    for label, (vals, msk, inv) in [("main", colstats_case(values, mask)),
                                    ("ragged", colstats_case(ragged_vals, ragged_mask))]:
        cnt, s, _ = masked_column_stats(vals, msk, inv, **cs_kw)
        pcnt, ps, _ = masked_column_stats_plain(vals, msk, inv, **cs_kw)
        mu = ps / pcnt.clamp_min(1)
        _, _, sq = masked_column_stats(vals, msk, inv, mu, **cs_kw)
        _, _, psq = masked_column_stats_plain(vals, msk, inv, mu, **cs_kw)
        torch.cuda.synchronize()
        check(torch.equal(cnt, pcnt), f"masked_column_stats {kind} {label}: counts differ")
        check(close(s, ps, tol.sums), f"masked_column_stats {kind} {label}: sums")
        check(close(sq, psq, tol.sums), f"masked_column_stats {kind} {label}: sqdev")
        once, twice = (masked_column_stats(vals, msk, inv, mu, **cs_kw) for _ in range(2))
        check(all(torch.equal(a, b) for a, b in zip(once, twice)),
              f"masked_column_stats {kind} {label}: two calls differ")
        err = max(max_abs(s, ps), max_abs(sq, psq))
        errs.setdefault("masked_column_stats", err)
        bound = f"{BF16_ULPS} bf16 ulp" if half else f"rtol {tol.sums:g}"
        print(f"[kernels{tag}] masked_column_stats {label} {tuple(vals.shape)}: counts exact, "
              f"sum/sqdev within {bound}, max abs err {err:.3e}; two calls bitwise equal",
              flush=True)

    rz = torch.tensor(rng.normal(size=RAGGED) * 3, dtype=dtype, device=dev)
    rmask = torch.tensor(rng.random(RAGGED) > 0.1, device=dev)
    rregion = torch.tensor(rng.random(RAGGED[1]) > 0.2, device=dev)
    for label, args in [("main", (norm.z, norm.mask, region, ZMAX)),
                        ("ragged", (rz, rmask, rregion, ZMAX))]:
        g, pg = zprep_gram(*args), zprep_gram_plain(*args)
        if half:  # and the norms of the split pass, grid_tpu's sum(P * P)
            ratio = bf16_gram_ratio(g.float().cpu().numpy(), pg.float().cpu().numpy())
            check(ratio <= 1, f"zprep_gram bf16 {label}: at {ratio:.3f} of the Gram rule")
            sq16, psq16 = zprep_gram(*args, norms=True)[1], zprep_gram_plain(*args, norms=True)[1]
            check(close(sq16, psq16, None), f"zprep_gram bf16 {label}: norms")
            err = max(max_abs(g, pg), max_abs(sq16, psq16))
            # one sum order: the panel mode's entries are the triangle's,
            # at a tile-aligned row and off the tiles
            split16 = zprep_split(*args)
            n16 = args[0].shape[0]
            for i0 in (0, n16 // 3):
                rows16 = min(512, n16 - i0)
                check(torch.equal(zprep_gram_panel(split16, i0, rows16), g[i0:i0 + rows16]),
                      f"zprep_gram bf16 {label}: the panel at row {i0} is not the triangle's rows")
            print(f"[kernels{tag}] zprep_gram {label}: at {ratio:.3f} of the bf16 Gram rule; its "
                  f"panels at rows 0 and {n16 // 3} bitwise the triangle's rows", flush=True)
            del split16
        else:
            err = assert_close_to_max(g.cpu(), pg.cpu(), tol.gram)
        errs.setdefault("zprep_gram", err)
        check(torch.equal(g, g.T), f"zprep_gram {kind} {label}: G is not exactly symmetric")
        z, msk, reg, zmax = args
        gate = ""
        if f32:  # both routes against a float64 Gram of the same P, on the card
            p64 = torch.where(msk, z.double().clamp(-zmax, zmax), 0) * reg[None, :].double()
            g64 = p64 @ p64.T
            err64, plain_err64 = max_abs(g, g64), max_abs(pg, g64)
            check(err64 <= 2 * plain_err64, f"zprep_gram {label}: error vs float64 {err64:.3e} "
                                            f"> 2x the plain version's {plain_err64:.3e}")
            ratio = err64 / plain_err64 if plain_err64 else float("inf")
            gate = (f"; vs a float64 Gram: kernel {err64:.3e}, plain {plain_err64:.3e} "
                    f"({ratio:.3f}x, gate 2x)")
        bound = (f"{BF16_ULPS} bf16 ulp of each entry or 2^-16 of max|G| (the split pass's "
                 f"norms within {BF16_ULPS} ulp)" if half else f"{tol.gram:g} of max|G|")
        print(f"[kernels{tag}] zprep_gram {label} {tuple(z.shape)}: within {bound}, max abs err "
              f"{err:.3e}; exactly symmetric{gate}", flush=True)

    def dipcn_case(zp, k, n_nbr):
        n = zp.shape[0]
        ones = torch.ones_like(zp, dtype=torch.bool)
        valid = torch.tensor(rng.random(n) > 0.1, device=dev)
        dd = d2_matrix(zp, ones, ones[0], 1e30, row_valid=valid)
        rnorm = torch.tensor(rng.uniform(0.5, 2.0, n), dtype=dtype, device=dev)
        usable = torch.tensor(rng.random(n) > 0.2, device=dev)
        return (dd, rnorm, rnorm, usable, usable), k, n_nbr

    ties = torch.tensor(np.round(rng.normal(size=(97, 16)) * 4) / 4, dtype=dtype, device=dev)
    # quantized random distances, with the finfo.max of self / invalid columns
    wide_d2 = torch.tensor(rng.integers(0, 400, WIDE) * 0.25, dtype=dtype, device=dev)
    wide_d2[:, rng.random(WIDE[1]) < 0.05] = big
    wide_w = torch.tensor(rng.uniform(0.5, 2.0, WIDE[1]), dtype=dtype, device=dev)
    wide_rnorm = torch.tensor(rng.uniform(0.5, 2.0, WIDE[0]), dtype=dtype, device=dev)
    wide_usable = torch.tensor(rng.random(WIDE[1]) > 0.2, device=dev)
    cases = [
        ("main", (d2, w_main, w_main, sample_ok, sample_ok), K, N_NBR),
        ("ragged", *dipcn_case(rz, 20, 7)),
        ("forced-tie", *dipcn_case(ties, 20, 7)),
        ("all-equal", *dipcn_case(torch.zeros((N, 16), dtype=dtype, device=dev), K, N_NBR)),
        ("wide", (wide_d2, wide_rnorm, wide_w, wide_usable, wide_rnorm > 0.6), K, N_NBR),
    ]
    for label, args, k, n_nbr in cases:
        dip, ok = dipcn_from_distances_gpu(*args, k=k, n_nbr=n_nbr)
        pdip, pok = dipcn_from_distances(*args, k=k, n_nbr=n_nbr)
        torch.cuda.synchronize()
        check(torch.equal(ok, pok), f"dipcn {kind} {label}: ok differs")
        check(torch.equal(dip[ok], pdip[ok]) if half else
              torch.allclose(dip[ok], pdip[ok], rtol=tol.dipcn, atol=0),
              f"dipcn {kind} {label}: values")
        err = max_abs(dip[ok], pdip[ok])
        errs.setdefault("dipcn_from_distances_gpu", err)
        print(f"[kernels{tag}] dipcn {label} {tuple(args[0].shape)} k={k} n_nbr={n_nbr}: ok exact "
              f"({int(ok.sum())} rows), dipcn within rtol {tol.dipcn:g}, max abs err {err:.3e}",
              flush=True)

    # knn_select: bitwise the stable sort (its plain version) in the mode the
    # wrapper picks, over the cluster size the width picks (float64: one
    # block a row, wider rows the wide mode); at the widths where the mode
    # changes its wide mode (the keys in device memory) too
    tie_d2 = cases[2][1][0]
    gen_k = torch.Generator(device=dev).manual_seed(16)

    def quantized(rows, width):  # each value repeats ~width / 400 times a row
        q = (torch.randint(0, 400, (rows, width), device=dev, generator=gen_k) * 0.25).to(dtype)
        q[:, torch.rand(width, device=dev, generator=gen_k) < 0.05] = big
        return q.contiguous()

    def shared(blocks):  # the mode of rows a cluster of `blocks` would take
        return ("wide", 1) if dtype == torch.float64 else ("cluster", blocks)

    select_cases = [(label, args[0], k, None) for label, args, k, _ in cases] + [
        ("forced-tie k=1", tie_d2, 1, None), ("forced-tie k=W", tie_d2, tie_d2.shape[1], None),
        ("ring merge [best | d2]", torch.cat([sorted_smallest_k(d2[:512], K)[0], d2[:512]], 1), K,
         None),
        ("the widest one-block row", quantized(64, KNN_SLICE), K, ("resident", 1)),
        ("the narrowest two-block row", quantized(64, KNN_SLICE + 1), K, shared(2)),
        ("a panel row", quantized(64, PANEL_N), K, shared(8)),
        ("the biobank row", quantized(16, BIOBANK_N), K, shared(8))]
    if half:  # a bf16 list entry's column has 17 bits: 131,072 columns at most
        select_cases += [("the widest row", quantized(4, KNN_BF16_MAX_W), K, shared(8)),
                         ("the largest list", quantized(4, KNN_BF16_MAX_W), KNN_MAX_K[dtype],
                          shared(8))]
    else:
        select_cases += [("past the cluster's edge", quantized(4, KNN_WIDE_W), K, ("wide", 1)),
                         ("the largest list", quantized(4, KNN_MAX_K_W), KNN_MAX_K[dtype],
                          ("wide", 1))]
    edges = {"the widest one-block row", "the narrowest two-block row", "a panel row"}
    for label, dd, k, want_mode in select_cases:
        vals, idx = sorted_smallest_k_gpu(dd, k)
        want_v, want_i = sorted_smallest_k(dd, k)
        torch.cuda.synchronize()
        check(torch.equal(idx, want_i) and torch.equal(vals, want_v),
              f"knn_select {kind} {label}: not the plain version's values and positions")
        kinfo_c = knn_select_info(dd.shape[1], k, dev, dtype=dtype)
        if want_mode is not None:
            check((kinfo_c["mode"], kinfo_c["cluster_blocks"]) == want_mode,
                  f"knn_select {kind} {label}: mode {kinfo_c['mode']} over "
                  f"{kinfo_c['cluster_blocks']} block(s), not {want_mode}")
        also = ""
        if label in edges and kinfo_c["mode"] != "wide":
            got_v, got_i = _knn_launch("wide", dd, k)
            check(torch.equal(got_i, idx) and torch.equal(got_v, vals),
                  f"knn_select {kind} {label}: its wide mode differs")
            also = ", and so its wide mode"
        errs["sorted_smallest_k_gpu"] = max(errs.get("sorted_smallest_k_gpu", 0.0),
                                            max_abs(vals, want_v))
        print(f"[kernels{tag}] knn_select {label} {tuple(dd.shape)} k={k} ({kinfo_c['mode']} "
              f"mode, {kinfo_c['cluster_blocks']} block(s) a row): values and positions bitwise "
              f"the {'int16 keys' if half else 'values'}' stable sort's{also}", flush=True)
    del select_cases
    if f32:
        lo_w, hi_w = PANEL_N, KNN_WIDE_W  # the widest row of the cluster mode at k=K lies here
        while hi_w - lo_w > 1:
            mid = (lo_w + hi_w) // 2
            lo_w, hi_w = ((mid, hi_w) if knn_select_info(mid, K, dev)["mode"] == "cluster"
                          else (lo_w, mid))
        print(f"[kernels] knn_select at k={K}: rows up to {lo_w} columns take the cluster mode "
              f"(8 blocks of {knn_select_info(lo_w, K, dev)['slice']} columns), wider ones the "
              f"wide mode; {card}", flush=True)

    irrs_main = rand_lists = boot_slots = boot_lists = None
    if not half:  # bfloat16 runs the float32 sweeps, held in phase 3
        # phase_sweeps: the plain sweeps within TOL's rtol (each neighbor list
        # summed in slot order, not in torch's reduction order), the same NaNs;
        # its modes bitwise equal. The bootstrap replicates' resampled lists
        # drive some values towards 0 (to ~1e-25 in 100 sweeps), where float32
        # keeps no 1e-5 relative accuracy: the plain sweeps themselves are
        # ~1.5e-5 from float64 sweeps there. In float32 those are held to
        # float64 sweeps instead: their relative error at most twice the plain
        # version's; in float64 to the plain sweeps at TOL's boot rtol.

        def rel_err(a, ref) -> float:
            """Largest relative error of ``a`` against ``ref`` over its finite,
            non-zero cells."""
            keep = torch.isfinite(ref) & (ref != 0)
            return float(((a.double() - ref) / ref).abs()[keep].max()) if keep.any() else 0.0

        main_dip, main_ok = dipcn_from_distances_gpu(d2, w_main, w_main, sample_ok, sample_ok, k=K,
                                                     n_nbr=N_NBR)
        irrs_main = torch.where(main_ok, main_dip, torch.nan)
        rand_lists = random_hap_lists(N, 10, dev, seed=3)
        rand_lists[1] = rand_lists[1].to(dtype)
        boot_slots = torch.tensor(
            (np.random.default_rng(4).random((BOOT_REPLICATES, 2 * N, 10))
             * rand_lists[2].sum(dim=1).clamp_min(1).cpu().numpy()[None, :, None]).astype(np.int64),
            device=dev)
        boot_lists = [torch.gather(rand_lists[0].long().expand(BOOT_REPLICATES, 2 * N, 10), 2,
                                   boot_slots).to(torch.int32).contiguous(),
                      torch.gather(rand_lists[1].expand(BOOT_REPLICATES, 2 * N, 10), 2, boot_slots),
                      rand_lists[2]]
        ring_lists = [torch.tensor(a, device=dev) for a in ring_neighbors(N)]
        ring_lists[1] = ring_lists[1].to(dtype)
        for label, lists, strict in (
                ("ring lists, K=2", ring_lists, True), ("random lists, K=10", rand_lists, True),
                (f"{BOOT_REPLICATES} bootstrap replicates, K=10", boot_lists, False)):
            hap0 = hap_start(irrs_main, lists[2])
            got = phase_sweeps_gpu(hap0, irrs_main, *lists, N_ITERS)
            want = phase_sweeps(hap0, irrs_main, *lists, N_ITERS)
            want64 = phase_sweeps(hap0.double(), irrs_main.double(), lists[0], lists[1].double(),
                                  lists[2], N_ITERS)
            modes = phasing_modes(N, lists[0].shape[-1], dev, dtype)
            others = {m: _sweeps_launch(
                m, hap0, irrs_main, lists[0].to(torch.int32), lists[1], lists[2], N_ITERS,
                torch.empty_like(got.reshape(-1, 2 * N))).reshape(got.shape) for m in modes}
            torch.cuda.synchronize()
            nan = got.isnan()
            check(torch.equal(nan, want.isnan()), f"phase_sweeps {kind} {label}: NaN cells differ")
            rel, plain_rel = rel_err(got, want64), rel_err(want, want64)
            rtol = tol.sweeps if strict else tol.boot
            if rtol is not None:
                check(torch.allclose(got[~nan], want[~nan], rtol=rtol, atol=0),
                      f"phase_sweeps {kind} {label}: beyond rtol {rtol:g} of the plain sweeps")
                gate = f"within rtol {rtol:g} of the plain sweeps"
            else:
                check(rel <= 2 * plain_rel,
                      f"phase_sweeps {label}: relative error {rel:.3e} against float64 sweeps > "
                      f"2x the plain version's {plain_rel:.3e}")
                gate = "relative error against float64 sweeps at most 2x the plain version's"
            for name, other in others.items():
                check(torch.equal(other.nan_to_num(), got.nan_to_num())
                      and torch.equal(other.isnan(), nan),
                      f"phase_sweeps {kind} {label}: the {name} mode differs from the wrapper's")
            err = max_abs(got[~nan], want[~nan])
            errs["phase_sweeps_gpu"] = max(errs.get("phase_sweeps_gpu", 0.0), err)
            mode = phase_sweeps_mode(N, lists[0].shape[-1], dev, dtype)
            print(f"[kernels{tag}] phase_sweeps {label}, N={N}, {N_ITERS} sweeps ({mode} mode): "
                  f"{gate} (max abs err {err:.3e} against the plain sweeps; relative error against "
                  f"float64 sweeps: kernel {rel:.3e}, plain {plain_rel:.3e}), NaN cells identical "
                  f"({int(nan.sum())} of {nan.numel()}); the modes {', '.join(others)} called "
                  f"directly bitwise the same", flush=True)
            del others

    # ---- 4. the slice: the step against the port's CPU route -------------
    reads_valid_np = np.ones(N, bool)
    hi, hw, hv = ring_neighbors(N)
    # bench.py's setting: unquantized z, so the two routes' z differ by
    # rounding only, never by a %.2f flip
    params = CohortParams(num_neighbors=K, n_nbr=N_NBR, n_iters=N_ITERS, quantize=False)
    check(d2_resident(params, N, e), f"the {kind} N={N} step must keep d2 resident")
    inputs = inputs_to_torch(values_np, mask_np, reads_np, reads_valid_np, hi, hw, hv, dev, dtype,
                             wide)
    counted = step_wrappers()
    for fn in counted.values():
        fn.launches = 0
    with plain_calls_counted() as plains:
        out = cohort_step(*inputs, params)
        torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}
    print(f"[slice{tag}] cohort_step {kind} on {torch.cuda.get_device_name(0)}: kernel launches "
          f"{launches}; plain versions reached {dict(plains)}", flush=True)
    check(not plains, f"the {kind} card step reached a plain version: {dict(plains)}")
    for name in SOURCES:
        check(launches[name] > 0, f"{name} was not launched by the {kind} step")
    check(all(launches[name] == 1 for name in SELECTION),
          f"the slice must launch knn_select and phase_sweeps once each: {launches}")

    check(out.z.dtype == out.nbr_sq_dists.dtype == out.dipcn.dtype == dtype,
          f"the {kind} step's outputs are not {kind}")
    got = outputs_to_numpy(out)
    t0 = time.perf_counter()
    cpu_wide = torch.float64 if half else dtype  # bf16's reads on the CPU, as under auto
    want = outputs_to_numpy(cohort_step(*inputs_to_torch(
        values_np, mask_np, reads_np, reads_valid_np, hi, hw, hv, "cpu", dtype, cpu_wide),
        params))
    cpu_s = time.perf_counter() - t0
    check(got.nbr_idx.shape == (N, K) and got.dipcn.shape == (N,), "output shapes")
    check(got.z.dtype == want.z.dtype and got.nbr_sq_dists.dtype == want.nbr_sq_dists.dtype
          and got.dipcn.dtype == want.dipcn.dtype and got.z.dtype.itemsize == max(e, 4),
          f"the {kind} step's output dtypes differ from the CPU route's")
    check(np.isfinite(got.dipcn[got.dipcn_valid]).all(), "non-finite dipCN on a valid row")
    check(np.isfinite(got.hap_irrs[np.repeat(got.phased, 2)]).all(), "non-finite phased hap")
    z_err = assert_close_to_max(got.z, want.z, tol.z)
    if dtype == torch.float64:
        check(np.array_equal(got.region_used, want.region_used), "f64 step: region_used differs")
    regions_apart = int((got.region_used != want.region_used).sum())
    usable = reads_valid_np & want.z_mask.any(axis=1)
    ties_found = {}
    summary = check_against(got, want, usable, N_NBR, f"the {kind} step", dtype, ties_found)
    z_same = float(np.mean(got.z == want.z))
    print(f"[slice{tag}] vs the port's CPU route in {kind} ({cpu_s:.1f} s, host clock): z within "
          f"{tol.z:g} of max|z| (max abs err {z_err:.3e}; {100 * z_same:.3f}% of the entries "
          f"equal); {summary}; r_use {int(got.r_use)} ({regions_apart} regions used on one side "
          f"only); {int(got.phased.sum())} phased", flush=True)

    # ---- 5. times --------------------------------------------------------
    slice_ms = median_ms(lambda: cohort_step(*inputs, params))
    print(f"[times{tag}] cohort_step {kind} N={N} R={R} k={K} n_iters={N_ITERS}: {slice_ms:.3f} "
          f"ms (median of {REPS}; {card})", flush=True)
    cs = colstats_case(values, mask)
    mu = norm.col_means.nan_to_num()
    sw = {}  # the sweeps' timing: float32 and float64 only (bf16 runs the float32 sweeps)
    if not half:
        sw["phase_sweeps_gpu"] = (
            lambda: phase_sweeps_gpu(step_hap0, step_irrs, *step_lists, N_ITERS),
            lambda: phase_sweeps(step_hap0, step_irrs, *step_lists, N_ITERS), None)
    gram_args = (norm.z, norm.mask, region, ZMAX)
    dip_args = (d2, w_main, w_main, sample_ok, sample_ok)
    # the slice's own phasing: its dipCN and its ring lists
    step_irrs = torch.where(out.dipcn_valid, out.dipcn, torch.nan)
    step_lists = inputs[4:7]
    step_hap0 = hap_start(step_irrs, step_lists[2])
    p_main = prepare_z(norm.z, norm.mask, ZMAX, region)
    timed = {  # (kernel, plain version, library call: a yardstick the port never calls)
        "masked_column_stats": (lambda: masked_column_stats(*cs, mu, **cs_kw),
                                lambda: masked_column_stats_plain(*cs, mu, **cs_kw), None),
        "zprep_gram": (lambda: zprep_gram(*gram_args), lambda: zprep_gram_plain(*gram_args),
                       lambda: torch.mm(p_main, p_main.T)),
        "dipcn_from_distances_gpu": (
            lambda: dipcn_from_distances_gpu(*dip_args, k=K, n_nbr=N_NBR),
            lambda: dipcn_from_distances(*dip_args, k=K, n_nbr=N_NBR), None),
        "sorted_smallest_k_gpu": (lambda: sorted_smallest_k_gpu(d2, K),
                                  lambda: sorted_smallest_k(d2, K),
                                  lambda: torch.sort(d2, dim=1, stable=True).values[:, :K]),
        **sw,
    }
    library = {"zprep_gram": f"torch.mm of the prepared P, {kind}" + (
                   ", TF32 off" if f32 else " (cuBLAS bf16 GEMM)" if half else " (cuBLAS DGEMM)"),
               "sorted_smallest_k_gpu": f"stable torch.sort of the {kind} rows, sliced to k"}
    bounds = {
        # values, mask, 1/row mean, column means in; three [R] sums out
        "masked_column_stats": bound_ms(N * R * (e + 1) + e * N + e * R + 3 * e * R),
        # z, mask, region in, G out; the symmetric product's N(N+1)R
        # operations at the Gram's peak (TF32, or the FP64 tensor cores)
        "zprep_gram": bound_ms(N * R * (e + 1) + R + e * N * N, N * (N + 1) * R, tol.gram_peak),
        # d2, rnorm, nbr_w, usable, valid in; dipcn, ok out
        "dipcn_from_distances_gpu": bound_ms(e * N * N + 3 * e * N + 3 * N),
        # d2 in, k values and k int32 positions a row out
        "sorted_smallest_k_gpu": bound_ms(e * N * N + (e + 4) * N * K),
    }
    if not half:  # the start, irrs and the lists read once, the values written once
        bounds["phase_sweeps_gpu"] = sweeps_bound_ms(step_hap0, step_irrs, *step_lists, N_ITERS,
                                                     flop_per_s=tol.peak)
    sources = {torch.float32: SOURCES, torch.float64: F64_SOURCES,
               torch.bfloat16: BF16_SOURCES}[dtype]
    rows = []
    for name, (kernel_fn, plain_fn, lib_fn) in timed.items():
        # plain, kernel, kernel, plain: neither side gets the warmer card
        p1, k1, k2, p2 = (median_ms(f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
        kernel_ms, plain_ms = min(k1, k2), min(p1, p2)
        b2b_ms = min(back_to_back_ms(kernel_fn), back_to_back_ms(kernel_fn))
        lib_ms = None if lib_fn is None else min(median_ms(lib_fn), median_ms(lib_fn))
        least, bound_by = bounds[name]
        route, source, replaces = sources[name]
        row = {"name": name, "route": route, "source": source, "replaces": replaces,
               "launches": launches[name], "max_abs_err": errs[name], "ms": kernel_ms,
               "ms_back_to_back": b2b_ms, "plain_ms": plain_ms, "bound_ms": least,
               "bound_by": bound_by, "bound_share": least / b2b_ms, "library_ms": lib_ms,
               "shape": f"N={N}, R={R}, k={K}, {kind}"}
        extra = ""
        if name in library:
            row["library"] = library[name]
            extra = f"; {library[name]} {lib_ms:.4f} ms"
        if name == "zprep_gram":
            flop = N * (N + 1) * R
            row["library_ms_back_to_back"] = min(back_to_back_ms(lib_fn) for _ in range(2))
            extra += (f"; {flop / kernel_ms / 1e9:.1f} vs {flop / plain_ms / 1e9:.1f} TFLOP/s as "
                      f"N(N+1)R; {REPS} back to back: {library[name].split(',')[0]} "
                      f"{row['library_ms_back_to_back']:.4f} ms")
            if dtype == torch.float64:  # reckoned from the tiles, not measured; at the b2b time
                l2_bytes = zprep_gram64_l2_bytes(N, N, "triangle", _r_pad(R, dtype))
                extra += (f"; the tiles read {l2_bytes / 1e9:.3f} GB from L2 a call (estimated "
                          f"from the tile count), {l2_bytes / b2b_ms / 1e9:.2f} TB/s at the b2b "
                          f"time")
        if name == "sorted_smallest_k_gpu":
            row["topk_ms"] = min(median_ms(lambda: torch.topk(d2, K, dim=1, largest=False,
                                                             sorted=True)) for _ in range(2))
            extra += f"; torch.topk (largest=False, sorted) {row['topk_ms']:.4f} ms"
        print(f"[times{tag}] {name} {kind}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(medians of {REPS}, better of two rounds{extra}); {REPS} back to back "
              f"{b2b_ms:.4f} ms per call; bound {least:.4f} ms by {bound_by}, "
              f"{100 * least / b2b_ms:.1f}% of it back to back; {card}", flush=True)
        rows.append(row)
    del p_main

    # ---- 6. profile ------------------------------------------------------
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            cohort_step(*inputs, params)
        torch.cuda.synchronize()
    ops = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    busy = None
    if ops:
        # one stream, so device ops do not overlap and their times add up;
        # the share is taken against the step timed without the profiler
        dev_ms = sum(map(device_us, ops)) / 1e3 / PROFILE_STEPS
        n_ops = sum(ev.count for ev in ops) / PROFILE_STEPS
        busy = dev_ms / slice_ms
        print(f"[profile{tag}] cohort_step {kind}: device time {dev_ms:.3f} ms per step in "
              f"{n_ops:.0f} device ops (torch.profiler, {PROFILE_STEPS} steps), "
              f"{100 * busy:.1f}% of the {slice_ms:.3f} ms step of phase 5; {card}", flush=True)
        for ev in sorted(ops, key=device_us, reverse=True)[:12]:
            print(f"[profile{tag}]   {device_us(ev) / 1e3 / PROFILE_STEPS:8.4f} ms/step "
                  f"{ev.count / PROFILE_STEPS:6.1f} calls/step  {ev.key[:80]}")
        # the hand kernels' own device time (the Gram product is two kernels,
        # the split or prep pass and the Gram kernel; the column statistics
        # are the row-chunk kernel and its merge)
        own = ("split_kernel", "split16_kernel", "gram_kernel", "prep_kernel", "gram64_kernel",
               "gram16_kernel", "dipcn_select_kernel", "colstats", "knn_select_kernel",
               "phase_resident_kernel", "phase_grid_kernel", "phase_sweep_kernel")
        for ev in ops:
            if any(name in ev.key for name in own):
                print(f"[profile{tag}]   hand kernel {device_us(ev) / 1e3 / PROFILE_STEPS:.4f} "
                      f"ms/step {ev.count / PROFILE_STEPS:.1f} calls/step  {ev.key[:80]}")
        if half:  # the bf16 Gram's device time a call: its split pass and its kernel
            gram_row = next(row for row in rows if row["name"] == "zprep_gram")
            parts = {name: sum(device_us(ev) for ev in ops if name in ev.key) / 1e3
                     / PROFILE_STEPS for name in ("split16_kernel", "gram16_kernel")}
            gram_row.update(device_ms=sum(parts.values()), split_device_ms=parts["split16_kernel"],
                            launch=info)
    else:
        print(f"[profile{tag}] torch.profiler saw no device activity: device time not measured")
    return SimpleNamespace(
        rows=rows, launches=launches, ties=ties_found["ties"], sets=ties_found["sets"],
        slice_ms=slice_ms, busy=busy, kinfo=kinfo, pinfo=pinfo, d2=d2, w_main=w_main,
        sample_ok=sample_ok, dip_args=dip_args, inputs=inputs, params=params, out=out,
        step=(step_hap0, step_irrs, step_lists), irrs_main=irrs_main, rand_lists=rand_lists,
        boot_slots=boot_slots, boot_lists=boot_lists)


def gram16_shape(info: dict, sms: int) -> str:
    """The bf16 Gram's launch (``zprep_gram_info`` in bf16) in words."""
    return (f"{info['tiles']} tiles of {info['tile_rows']}x{info['tile_cols']} walked by "
            f"{info['grid']} block(s) ({info['blocks_per_sm']} an SM on {sms} SMs; "
            f"{info['tiles'] / info['grid']:.2f} tiles a block), {info['threads']} threads (two "
            f"m64n256k16 consumer warpgroups, a producer warpgroup), a {info['stages']}-stage TMA "
            f"ring of {info['k_tile']}-column stages and {info['epilogue_boxes']} staged boxes of "
            f"G in {info['smem_bytes']} B of dynamic shared memory (+{info['static_smem_bytes']} "
            f"B static); {info['registers']} registers a thread at entry, "
            f"{info['spill_bytes']} B of local memory")


def gram64_shapes(dev, sms: int) -> None:
    """Phase 2: the FP64 Gram's launch in its three modes at the cohort
    step's shapes (the N=2504 triangle, the N=65,536 split and one of its
    512-row panels), held to ``tests/torch_plans.py``'s plan, with no spill."""
    from grid_tpu_torch.ops.gpu_kernels import zprep_gram_info
    from torch_plans import zprep_gram64_plan

    keys = ("tile", "k_tile", "stages", "threads", "smem_bytes", "blocks", "blocks_per_sm")
    for n, rows, mode in ((N, N, "triangle"), (PANEL_N, PANEL_N, "split"),
                          (PANEL_N, 512, "panel")):
        info = zprep_gram_info(n, dev, torch.float64, mode, rows)
        plan = zprep_gram64_plan(n, rows, mode)
        label = f"{mode} of {rows} rows" if mode == "panel" else mode
        print(f"[build] zprep_gram float64 {label} at N={n}"
              f": m16n8k16 mma.sync, {info['blocks']} tiles of {info['tile']}x"
              f"{info['tile']} ({info['blocks'] / sms:.2f} waves at {info['blocks_per_sm']} "
              f"block an SM on {sms} SMs), {info['threads']} threads a block (8 consumer warps, "
              f"a producer warpgroup), a {info['stages']}-stage TMA ring of {info['k_tile']}-"
              f"column stages in {info['smem_bytes']} B of dynamic shared memory "
              f"(+{info['static_smem_bytes']} B static); {info['registers']} registers a thread "
              f"at entry (the consumers take 232 by setmaxnreg), {info['spill_bytes']} B of "
              f"local memory; {plan['flops_per_l2_byte']:.0f} flops a byte from L2", flush=True)
        check(info["spill_bytes"] == 0, f"zprep_gram float64 {label}: spills to local memory")
        check(all(info[key] == plan[key] for key in keys),
              f"zprep_gram float64 {label}: launch {info} is not the plan {plan}")


def float64_phase(dev, card: str, values_np, mask_np, reads_np, sms: int) -> tuple:
    """Phase 17 (a-c, e, f): ``device.dtype: float64`` on the card. The
    up-front refusals (f), then phases 3-6 (:func:`kernels_phase`) and phase
    7 (:func:`panel_phase`) in float64: each kernel against its float64
    plain version at N=2504 and at the panel shapes (a), the N=2504 step
    against the port's float64 CPU route (b), the panel step at N=65,536
    against the plain route on the card (c), no plain version reached (e).
    Returns the float64 rows of the kernels line and the steps' times and
    tie counts."""
    from grid_tpu_torch.utils.device import compute_dtype

    t_phase = time.perf_counter()
    f64 = torch.float64
    refusals = (({"device": {"dtype": "float64"}, "mosdepth": {"neighbors": {
                    "num_neighbors": 8193}}}, "8192"),)
    for config, names in refusals:
        try:
            compute_dtype(config, dev)
        except ValueError as e:
            check(names in str(e), f"the refusal of {config} does not name {names!r}: {e}")
        else:
            raise RuntimeError(f"check failed: {config} was not refused")
    for config in ({"device": {"dtype": "float64"}},
                   {"device": {"dtype": "float64", "mesh_shape": [2], "dispatch": "ring"}},
                   {"device": {"dtype": "float64", "mesh_shape": [2], "fused": True}}):
        check(compute_dtype(config, dev) is f64, f"float64 refused for {config}")
    print("[f64] (f) compute_dtype on the card: float64 taken, with device.mesh_shape and for "
          "the multi-locus sweep too; float64 past 8,192 neighbors refused up front, naming "
          "the cause (bfloat16's rules: phase 18)", flush=True)
    res = kernels_phase(dev, card, f64, values_np, mask_np, reads_np, sms)
    panel, _, panel_run = panel_phase(dev, card, f64)
    rows = {}
    for row in res.rows:
        name = row["name"]
        rows[name] = {**row, "name": f"{name}[float64]", "panel_65536": panel[name]}
    torch.cuda.empty_cache()
    print(f"[f64] phase 17 (a-c, e, f) took {time.perf_counter() - t_phase:.1f} s (host clock); "
          f"{card}", flush=True)
    return rows, {"ms_2504": res.slice_ms, "busy_share_2504": res.busy,
                  "ms_65536": panel_run.step_ms, "ties_2504": res.ties, "sets_2504": res.sets,
                  "ties_65536": panel_run.ties, "sets_65536": panel_run.sets}


F64_RING_WORLD = 2  # the float64 sharded steps' ranks on the one card (gloo)


def float64_pipeline_runs(card: str, tmp: Path, cohort: dict, base: dict, names: dict,
                          cpu_out: Path, k: int, n_nbr: int) -> dict:
    """Phase 17 (d), and the fused ring of (i): ``run_wgs_pipeline`` with
    ``device.dtype: float64`` on the card, fused, in file mode and fused
    with ``mesh_shape: [2], dispatch: ring`` (the sharded step over 2 gloo
    ranks of the card: the FP64 cross mode, float64 ring shifts), on phase
    9's cohort on disk; each run's artifacts held to phase 9's float64 CPU
    run (``cpu_out``):
    normalized byte-identical (decompressed), neighbor lists identical but
    for ties within F64_TIE_RTOL of the row's k-th written distance, dipCN
    within 1e-9 where the input sets agree, haploid byte-identical where no
    dipCN input set differs (else its differing lines counted). No plain
    version is reached (e). Returns each run's launches and tie counts."""
    from grid_tpu_torch.io.formats import read_dipcn, read_neighbors, read_normalized_data
    from grid_tpu_torch.pipeline import run_wgs_pipeline
    from torch_parity import dipcn_sets_differ, neighbor_rows_differing

    from grid_tpu_torch.ops.gpu_kernels import zprep_gram_cross

    counted = {**step_wrappers(), "zprep_gram_cross": zprep_gram_cross}
    ids, ratios, _, _ = read_normalized_data(cpu_out / names["normalized"])
    row = {s: i for i, s in enumerate(ids)}
    n = len(ids)

    def lists(out):
        nbrs, _ = read_neighbors(out / names["neighbors"])
        return (np.array([[row[m] for m, _, _ in nbrs[s]] for s in ids]),
                np.array([[dist for _, _, dist in nbrs[s]] for s in ids], np.float64))

    want_idx, want_d = lists(cpu_out)
    want_dip_ids, want_dip, _ = read_dipcn(cpu_out / names["dipcn"])
    found = {}
    w = F64_RING_WORLD
    for label, device in (("fused", {"fused": True, "dtype": "float64"}),
                          ("files", {"dtype": "float64"}),
                          ("ring", {"fused": True, "dtype": "float64", "mesh_shape": [w],
                                    "dispatch": "ring"})):
        cfg = copy.deepcopy(base)
        out = tmp / f"card_f64_{label}"
        out.mkdir()
        cfg["output_dir"] = str(out)
        cfg["device"] = device
        (out / "read_counts.tsv").write_bytes(cohort["counts_file"].read_bytes())
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with plain_calls_counted() as plains:
            run_wgs_pipeline(config=cfg)
        run_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counted.items()}
        check(not plains, f"(e) the float64 {label} run reached a plain version: {dict(plains)}")
        if label == "ring":  # the ranks' launches, summed; phasing in this process
            check(launches["masked_column_stats"] == 2 * w and launches["zprep_split"] == w
                  and launches["zprep_gram_cross"] == w * w and launches["phase_sweeps_gpu"] == 1
                  and launches["sorted_smallest_k_gpu"] > 0
                  and launches["zprep_gram"] + launches["zprep_gram_panel"] == 0,
                  f"(i) the float64 ring run's launches {launches}")
        else:
            check(launches["masked_column_stats"] == 2 and launches["phase_sweeps_gpu"] == 1
                  and launches["sorted_smallest_k_gpu"] > 0
                  and launches["zprep_gram"] + launches["zprep_gram_panel"] > 0
                  and launches["zprep_gram_cross"] == 0,
                  f"(e) the float64 {label} run's launches {launches}")
        check(content(out / names["normalized"]) == content(cpu_out / names["normalized"]),
              f"f64 {label}: the normalized artifact differs from the float64 CPU run's")
        got_idx, got_d = lists(out)
        differ = neighbor_rows_differing(got_idx, got_d, want_idx, want_d,
                                         tol=F64_TIE_RTOL * want_d[:, -1])
        dip_ids, dip, _ = read_dipcn(out / names["dipcn"])
        check(dip_ids == want_dip_ids, f"f64 {label}: dipCN rows differ from the CPU run's")
        usable = np.array([s in set(dip_ids) for s in ids])
        sets = dipcn_sets_differ(got_idx, want_idx, usable, n_nbr)[[row[s] for s in dip_ids]]
        check(np.allclose(np.asarray(dip)[~sets], np.asarray(want_dip)[~sets], rtol=1e-9, atol=0),
              f"f64 {label}: dipCN beyond rtol 1e-9 where the input sets agree")
        hap_same = content(out / names["haploid"]) == content(cpu_out / names["haploid"])
        hap_lines = sum(a != b for a, b in zip(content(out / names["haploid"]).splitlines(),
                                               content(cpu_out / names["haploid"]).splitlines()))
        check(hap_same or sets.any(), f"f64 {label}: the haploid artifact differs although no "
                                      f"dipCN input set does ({hap_lines} lines)")
        found[label] = {"launches": launches, "rows_differing_by_ties": int(differ.size),
                        "dipcn_sets_differ": int(sets.sum()), "haploid_lines_differ": hap_lines,
                        "seconds": run_s}
        print(f"[f64] ({'i' if label == 'ring' else 'd'}) run_wgs_pipeline, device {device}, "
              f"on phase 9's {n} x "
              f"{len(ratios)} cohort: {run_s:.1f} s "
              f"(host clock); launches {launches}, no plain version reached; vs phase 9's float64 "
              f"CPU run: normalized byte-identical; neighbor rows identical on {n - differ.size} "
              f"of {n}, the other {differ.size} differ only by ties within {F64_TIE_RTOL:g} of "
              f"the k-th written distance; {int(sets.sum())} rows change a dipCN input set, "
              f"dipCN within rtol 1e-9 on the other {int((~sets).sum())}; haploid "
              f"{'byte-identical' if hap_same else f'{hap_lines} lines differ'}; {card}",
              flush=True)
    return found


F64_SWEEP_LOCI = 2  # the float64 sweep's loci: LPA and 1 drawn from the seed
F64_DIPCN_RTOL = 1e-9  # dipCN where the input sets agree (docs/parity.md, float64)
F64_MULTI_PANELS = 2  # the float64 multi kernel's panels at N=65,536
# The cross mode's blocks (B, a's first row, b's first row): first the
# ring's at N=16,384 over 2 ranks, the visiting block (the kernels line's
# row) and a rank's own block, whose diagonal tiles the panel mode mirrors;
# then the fused ring's at N=2504 over 2 ranks (1252 rows, off a tile);
# then a [4096] block at offsets on and off a tile.
F64_CROSS = ((8192, 0, 8192), (8192, 0, 0), (1252, 0, 0), (1252, 1252, 0), (4096, 12288, 100))
F64_TIME_REPS = 10  # the float64 multi kernel's timed calls at N=2504


def time_multi(label: str, card: str, d2, args, k: int, n_nbr: int, reps: int = REPS) -> dict:
    """The multi-weight dipCN on ``d2`` and ``args`` (rnorm, nbr_w, usable,
    valid): the kernel (the median of ``reps`` calls by CUDA events, and
    ``reps`` back to back) beside its plain version and, as the library
    yardstick, torch.mm of the take mask by W in d2's dtype (the sum part
    alone; the port never calls it); its bound by bytes and by the adds its
    take-sets need, in the dtype's FP peak."""
    from grid_tpu_torch.ops.gpu_select import dipcn_from_distances_multi_gpu
    from grid_tpu_torch.ops.select import _take_set, dipcn_from_distances_multi

    rows, w = d2.shape
    n_loci = args[0].shape[1]
    take, m_eff = _take_set(d2, args[2], k, n_nbr)
    take = take.to(d2.dtype)
    kern = lambda: dipcn_from_distances_multi_gpu(d2, *args, k=k, n_nbr=n_nbr)  # noqa: E731
    plain = lambda: dipcn_from_distances_multi(d2, *args, k=k, n_nbr=n_nbr)  # noqa: E731
    lib = lambda: torch.mm(take, args[1])  # noqa: E731
    p1, k1, k2, p2 = (median_ms(f, reps=reps) for f in (plain, kern, kern, plain))
    b2b = min(back_to_back_ms(kern, reps=reps), back_to_back_ms(kern, reps=reps))
    lib_ms = min(median_ms(lib, reps=reps), median_ms(lib, reps=reps))
    # d2 [rows, W], nbr_w [W, L] and rnorm [rows, L] of the dtype, usable
    # [W] and valid [rows, L] bytes read once; dipcn [rows, L] of the dtype
    # and ok [rows, L] bytes written once
    itemsize = d2.element_size()
    n_bytes = (itemsize * rows * w + itemsize * w * n_loci + w
               + rows * n_loci * (itemsize + 1 + itemsize + 1))
    adds = float(m_eff.sum()) * n_loci
    least, by = bound_ms(n_bytes, adds, TOL[d2.dtype].peak)
    print(f"[times] multi dipcn_select {label} in {d2.dtype}: kernel {min(k1, k2):.4f} ms "
          f"(median of {reps}), {reps} back to back {b2b:.4f} ms per call, plain "
          f"{min(p1, p2):.4f} ms; bound {least:.4f} ms by {by} ({n_bytes / 1e6:.1f} MB at "
          f"3.35 TB/s against {adds / 1e6:.1f} M adds at the FP peak "
          f"{TOL[d2.dtype].peak / 1e12:.0f} TFLOP/s), {100 * least / b2b:.1f}% of it back to "
          f"back; the sum part alone as torch.mm of the take mask by W in {d2.dtype} "
          f"{lib_ms:.4f} ms; {card}", flush=True)
    return {"ms": min(k1, k2), "ms_back_to_back": b2b, "plain_ms": min(p1, p2),
            "bound_ms": least, "bound_by": by, "bound_share": least / b2b, "library_ms": lib_ms}


def float64_sweep_phase(card: str, tmp: Path, base: dict, names: dict, k: int,
                        n_nbr: int) -> dict:
    """Phase 17 (h), and the N=2504 part of (g): ``run_multi_locus`` with
    ``device.dtype: float64`` on phase 9's cohort on disk over
    F64_SWEEP_LOCI catalog loci (LPA among them; phase 11's per-locus
    counts, step 7 on), its normalized file byte for byte (d)'s file
    mode's (which (d) holds to the CPU), held to the port's float64 sweep
    on the CPU (``device.platform: cpu``) over the same loci from that
    file: neighbor lists equal but for ties within 1e-12 of the
    k-th distance (counted), every locus's dipCN rows equal and within rtol
    1e-9 where the input sets agree, its haploid table byte-identical where
    none differs; no plain version reached on the card. Then (g) the
    float64 multi kernel on the sweep's float64 d2 (the geometry read again
    in float64 on the card) for all loci's weights, per usability group,
    against its float64 plain version (ok exact, rtol 1e-9) and, for three
    loci, the float64 binary kernel; timed at L = 1, 32 and 492. Returns
    the sweep's launches and seconds and the kernel's checks and times."""
    import math

    from grid_tpu_torch.data.loci import load_vntr_catalog
    from grid_tpu_torch.io.formats import (
        read_counts_tsv, read_dipcn, read_neighbors, read_normalized_data,
    )
    from grid_tpu_torch.ops.gpu_kernels import zprep_gram_cross
    from grid_tpu_torch.ops.gpu_select import (
        dipcn_from_distances_gpu, dipcn_from_distances_multi_gpu, dipcn_select_info,
    )
    from grid_tpu_torch.ops.knn import d2_matrix
    from grid_tpu_torch.ops.select import dipcn_from_distances_multi
    from grid_tpu_torch.steps import multilocus
    from grid_tpu_torch.steps.neighbors import load_neighbor_geometry
    from torch_parity import dipcn_sets_differ, neighbor_rows_differing

    t_phase = time.perf_counter()
    counts_dir = tmp / "multilocus"  # phase 11's per-locus counts
    first = {}  # an artifact name's first catalog gene
    for gene in dict.fromkeys(locus.gene for locus in load_vntr_catalog()):
        first.setdefault(gene.split(",")[0], gene)
    tag = {gene: t for t, gene in first.items()}
    others = [gene for gene in first.values() if gene != "LPA"]
    rng = np.random.default_rng(MULTI_SEED + 17)
    genes = ["LPA", *rng.choice(others, F64_SWEEP_LOCI - 1, replace=False).tolist()]
    counted = {**step_wrappers(), "zprep_gram_cross": zprep_gram_cross,
               "dipcn_from_distances_multi_gpu": dipcn_from_distances_multi_gpu}

    def sweep(label: str, device: dict, normalized=None):
        """The sweep into its own directory; with ``normalized``, step 4
        is off and the run starts from that file."""
        out = tmp / f"multilocus_f64_{label}"
        out.mkdir()
        for gene in genes:
            shutil.copy(counts_dir / f"read_counts.{tag[gene]}.tsv", out)
        cfg = copy.deepcopy(base)
        cfg["output_dir"] = str(out)
        cfg["device"] = device
        cfg["compute_haploid_genotypes"]["run"] = True
        if normalized is not None:
            shutil.copy(normalized, out / names["normalized"])
            cfg["mosdepth"]["normalize"]["run"] = False
        console = Recorder()
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with plain_calls_counted() as plains:
            multilocus.run_multi_locus(cfg, genes, console)
        wall = time.perf_counter() - t0
        failed = [msg for msg, style in console.lines
                  if style == "danger" or "Failed to run" in msg]
        check(not failed, f"(h) the float64 sweep on {label}: logged {failed[:3]}")
        batched = [msg for msg, _ in console.lines if msg.startswith("Batched dipCN")]
        return (out, cfg, wall, {name: fn.launches for name, fn in counted.items()},
                dict(plains), batched)

    card_out, card_cfg, card_s, launches, plains, batched = sweep("card", {"dtype": "float64"})
    check(not plains, f"(h) the float64 sweep on the card reached a plain version: {plains}")
    groups_said = re.fullmatch(rf"Batched dipCN: {len(genes)} loci in (\d+) device call\(s\) "
                               rf"\(N=\d+, k={k}, resident d2\)", batched[0] if batched else "")
    check(len(batched) == 1 and groups_said, f"(h) the float64 sweep's batched step: {batched}")
    n_groups = int(groups_said.group(1))
    ids, ratios, _, _ = read_normalized_data(card_out / names["normalized"])
    n = len(ids)
    n_panels = -(-n // 512)
    want = {"masked_column_stats": 2, "zprep_gram": n_groups, "zprep_split": 1,
            "zprep_gram_panel": n_panels, "dipcn_from_distances_gpu": 0,
            "sorted_smallest_k_gpu": n_panels, "phase_sweeps_gpu": len(genes),
            "zprep_gram_cross": 0, "dipcn_from_distances_multi_gpu": n_groups}
    check(launches == want, f"(h) the float64 sweep's launches {launches} != {want}")
    # step 4 is (d)'s: the card's float64 file mode, held there to the CPU
    # run. A CPU normalize of its own may put a written cell one %.2f
    # quantum apart (summation order at a rounding boundary), and a scale
    # one quantum apart moves that sample's dipCN and its neighbors' means
    # far past 1e-9. So the CPU sweep starts from the card's normalized
    # file and holds steps 5-7, the sweep's own.
    check(content(card_out / names["normalized"]) ==
          content(tmp / "card_f64_files" / names["normalized"]),
          "(h) the float64 sweep's normalized artifact differs from phase 17 (d)'s file mode's")
    cpu_out, _, cpu_s, cpu_launches, _, _ = sweep("cpu", {"platform": "cpu"},
                                                  card_out / names["normalized"])
    check(not any(cpu_launches.values()), f"(h) the CPU sweep launched {cpu_launches}")
    row = {sid: i for i, sid in enumerate(ids)}
    # the lists' float64 distances on the CPU from the shared normalized
    # file: the written ones are %.2f of distances that the quantized z
    # puts on rounding boundaries, where the two routes' last bits round
    # them a quantum apart
    cpu_ids, cpu_zp, _, _, _ = load_neighbor_geometry({**card_cfg,
                                                       "device": {"platform": "cpu"}})
    check(cpu_ids == ids, "(h) the CPU geometry's samples")
    ones = torch.ones(cpu_zp.shape, dtype=torch.bool)
    d2_cpu = d2_matrix(cpu_zp, ones, ones[0], math.inf).numpy()
    del cpu_zp, ones

    def lists(out):
        nbrs, _ = read_neighbors(out / names["neighbors"])
        idx = np.array([[row[m] for m, _, _ in nbrs[sid]] for sid in ids])
        return idx, np.take_along_axis(d2_cpu, idx, axis=1)

    got_idx, got_d = lists(card_out)
    want_idx, want_d = lists(cpu_out)
    differ = neighbor_rows_differing(got_idx, got_d, want_idx, want_d,
                                     tol=F64_TIE_RTOL * want_d[:, -1])
    del d2_cpu
    sets_total, hap_differ, compared = 0, 0, 0
    for gene in genes:
        dip_name, hap_name = (f"{prefix}.{tag[gene]}.tsv" for prefix in (
            "diploid_genotypes", "haploid_genotypes"))
        dip_ids, dip, _ = read_dipcn(card_out / dip_name)
        want_ids, want_dip, _ = read_dipcn(cpu_out / dip_name)
        check(dip_ids == want_ids and len(dip_ids) > 0,
              f"(h) {gene}: the dipCN rows differ from the CPU sweep's")
        usable = np.array([sid in set(dip_ids) for sid in ids])
        sets = dipcn_sets_differ(got_idx, want_idx, usable, n_nbr)[[row[s] for s in dip_ids]]
        check(np.allclose(np.asarray(dip)[~sets], np.asarray(want_dip)[~sets],
                          rtol=F64_DIPCN_RTOL, atol=0),
              f"(h) {gene}: dipCN beyond rtol {F64_DIPCN_RTOL:g} where the input sets agree")
        same_hap = content(card_out / hap_name) == content(cpu_out / hap_name)
        check(same_hap or sets.any(), f"(h) {gene}: the haploid table differs although no "
                                      f"dipCN input set does")
        sets_total += int(sets.sum())
        hap_differ += int(not same_hap)
        compared += int((~sets).sum())
    print(f"[f64] (h) run_multi_locus, device.dtype float64, over {len(genes)} loci "
          f"({', '.join(genes[:4])}, ...) on phase 9's {n} x {len(ratios)} cohort, step 7 on: "
          f"{card_s:.1f} s on the card (host clock), launches {launches}, no plain version "
          f"reached; the port's float64 sweep on the CPU from the card's normalized file "
          f"{cpu_s:.1f} s. Normalized byte-identical to (d)'s file mode's; neighbor rows "
          f"identical on {n - differ.size} of {n}, the other {differ.size} differ only by ties "
          f"within {F64_TIE_RTOL:g} of the k-th distance (the file's float64 distances, on "
          f"the CPU); "
          f"{sets_total} (row, locus) pairs change a dipCN input set, dipCN within rtol "
          f"{F64_DIPCN_RTOL:g} on the other {compared}; {len(genes) - hap_differ} of "
          f"{len(genes)} haploid tables byte-identical; {card}", flush=True)

    # ---- (g) the float64 multi kernel at N=2504, every locus's weights ----
    sample_ids, zp, scales, _, _ = load_neighbor_geometry(card_cfg)
    dev = zp.device
    check(zp.dtype == torch.float64 and dev.type == "cuda" and sample_ids == ids,
          "(g) the float64 geometry on the card")
    reads = {t: read_counts_tsv(counts_dir / f"read_counts.{t}.tsv") for t in first}
    groups = multilocus.usability_groups(sample_ids, scales,
                                         {first[t]: reads[t] for t in first})
    zp = zp.contiguous()
    ones = torch.ones(zp.shape, dtype=torch.bool, device=dev)
    d2 = d2_matrix(zp, ones, ones[0], math.inf)
    err, bin_err = 0.0, 0.0
    for usable, gnames, w in groups:
        args = multi_inputs(w, usable, dev, torch.float64)
        dip, ok = dipcn_from_distances_multi_gpu(d2, *args, k=k, n_nbr=n_nbr)
        pdip, pok = dipcn_from_distances_multi(d2, *args, k=k, n_nbr=n_nbr)
        check(dip.dtype == torch.float64 and torch.equal(ok, pok),
              "(g) the float64 multi kernel's ok differs from its plain version's")
        check(torch.allclose(dip[ok], pdip[ok], rtol=F64_DIPCN_RTOL, atol=0),
              f"(g) the float64 multi kernel beyond rtol {F64_DIPCN_RTOL:g} of its plain version")
        err = max(err, max_abs(dip[ok], pdip[ok]))
        for j in (0, len(gnames) // 2, len(gnames) - 1):
            col = args[0][:, j].contiguous()
            bdip, bok = dipcn_from_distances_gpu(d2, col, col, args[2], args[3][:, j].contiguous(),
                                                 k=k, n_nbr=n_nbr)
            check(torch.equal(bok, ok[:, j]) and torch.allclose(
                dip[bok, j], bdip[bok], rtol=F64_RTOL, atol=0),
                f"(g) locus {gnames[j]}: the float64 multi kernel against the binary kernel")
            bin_err = max(bin_err, max_abs(dip[bok, j], bdip[bok]))
    info = dipcn_select_info(n, k, dev, multi=True, dtype=torch.float64)
    check(info["mode"] == "resident" and info["spill_bytes"] == 0,
          f"(g) the float64 multi form's launch at N={n}: {info}")
    print(f"[f64] (g) the float64 multi kernel on the sweep's float64 d2 ({len(groups)} groups "
          f"of {', '.join(str(len(g)) for _, g, _ in groups)} loci): ok equal to its float64 "
          f"plain version's, within rtol {F64_DIPCN_RTOL:g} (max abs err {err:.3e}); three loci "
          f"a group against the float64 binary kernel: ok equal, within rtol {F64_RTOL:g} (max "
          f"abs err {bin_err:.3e}); {info['mode']} mode, {info['smem_bytes']} B dynamic + "
          f"{info['static_smem_bytes']} B static shared memory, {info['blocks_per_sm']} blocks "
          f"an SM, {info['registers']} registers, {info['spill_bytes']} B spilled", flush=True)
    usable_all = max((u for u, _, _ in groups), key=lambda u: int(u.sum()))
    w_all = np.concatenate([w for _, _, w in groups], axis=1)
    timed = {n_loci: time_multi(f"at N={n}, L={n_loci}", card, d2,
                                multi_inputs(w_all[:, :n_loci], usable_all, dev, torch.float64),
                                k, n_nbr, reps=F64_TIME_REPS)
             for n_loci in MULTI_TIMED_L}
    del d2, zp, ones
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[f64] phase 17 (h) and (g) at N={n} took {seconds:.1f} s (host clock); {card}",
          flush=True)
    return {"launches": launches, "seconds_card": card_s, "seconds_cpu": cpu_s,
            "rows_differing_by_ties": int(differ.size), "dipcn_sets_differ": sets_total,
            "haploid_tables_differ": hap_differ, "max_abs_err": err,
            "max_abs_err_binary": bin_err, "timed": timed, "phase_seconds": seconds}


def float64_stage_run(card: str, tmp: Path, cohort: dict, base: dict, k: int,
                      n_nbr: int) -> dict:
    """Phase 17 (i), the sharded stager: ``staged_sharded_cohort_step`` in
    float64 over F64_RING_WORLD ranks on phase 9's files (each rank stages
    its share into a float64 [rows_per, R] buffer and runs the float64 ring
    step on it), held to the flat float64 step on the card from the stage
    the ranks made (kept by each rank): z within 1e-12 of max|z|, lists
    under the tie rule at 1e-12, dipCN within 1e-9 where the input sets
    agree; each rank's launches checked."""
    import grid_tpu_torch.parallel.pcohort as pcohort
    import torch_ranks
    from grid_tpu_torch.convert import inputs_to_torch, outputs_to_numpy
    from grid_tpu_torch.io.bed import load_repeat_mask
    from grid_tpu_torch.io.formats import read_counts_tsv
    from grid_tpu_torch.models.cohort import CohortParams, cohort_step
    from grid_tpu_torch.parallel import staged_sharded_cohort_step
    from grid_tpu_torch.parallel.mesh import block_rows
    from grid_tpu_torch.parallel.pknn import MERGE_ROWS
    from grid_tpu_torch.utils.device import get_device
    from torch_parity import assert_close_to_max

    t0 = time.perf_counter()
    world = F64_RING_WORLD
    norm_cfg = base["mosdepth"]["normalize"]
    lo, hi = norm_cfg["min_depth"], norm_cfg["max_depth"]
    excluded = load_repeat_mask(norm_cfg["repeat_mask_file"])
    counts = read_counts_tsv(cohort["counts_file"])
    params = CohortParams(num_neighbors=k, n_nbr=n_nbr, n_iters=N_ITERS, quantize=False)
    n = len(cohort["ids"])
    hap = ring_neighbors(n)
    reports = []
    keep_dir = tmp / "stage17_kept"
    keep_dir.mkdir()
    with keeping(pcohort, "_rank_staged_step", torch_ranks.staged_rank_keeping_stage, keep_dir):
        stage, staged = staged_sharded_cohort_step(
            world, base["mosdepth"]["work_dir"], cohort["ids"], counts, *hap, params, lo, hi,
            excluded=excluded, dtype=torch.float64, reports=reports)
    call_s = time.perf_counter() - t0
    b = block_rows(n, world)
    want_rank = {"masked_column_stats": 2, "zprep_split": 1, "zprep_gram_cross": world,
                 "sorted_smallest_k_gpu": world * -(-b // MERGE_ROWS), "phase_sweeps_gpu": 1,
                 "zprep_gram": 0, "zprep_gram_panel": 0, "dipcn_from_distances_gpu": 0}
    for rank, rep in enumerate(reports):
        got = {name: rep[name] for name in want_rank}
        check(got == want_rank, f"(i) the float64 staged step: rank {rank} launched {got}")
    staged = outputs_to_numpy(staged)
    many = load_stage(keep_dir, "stage", world)
    check(many["values"].dtype == np.float64 and staged.z.dtype == np.float64,
          "(i) the float64 stage is not float64")
    check(stage.n == n, "(i) the float64 stage's sample count")
    ids = stage.sample_ids
    reads = np.array([counts.get(sid, 0.0) for sid in ids])
    reads_valid = np.array([sid in counts for sid in ids])
    dev = get_device("cuda")
    flat = outputs_to_numpy(cohort_step(*inputs_to_torch(
        many["values"][:n], many["mask"][:n], reads, reads_valid, *hap, dev, torch.float64),
        params))
    got = staged._replace(**{name: getattr(staged, name)[:n] for name in (
        "z", "z_mask", "scales", "nbr_idx", "nbr_sq_dists", "dipcn", "dipcn_valid")})
    z_err = assert_close_to_max(got.z, flat.z, F64_RTOL)
    found = {}
    summary = check_against(got, flat, reads_valid & flat.z_mask.any(axis=1), n_nbr,
                            "(i) the float64 staged step vs the flat step", torch.float64, found)
    print(f"[f64] (i) staged_sharded_cohort_step in float64 over {world} ranks on phase 9's "
          f"{n} files ({call_s:.2f} s for the call, host clock, spawn included; the ranks' "
          f"stage.pass2 {', '.join('%.3f' % rep['stage.pass2'] for rep in reports)} s, host "
          f"buffers {', '.join('%.2f' % (rep['host_buffer_bytes'] / 2**20) for rep in reports)} "
          f"MiB of float64), launches per rank {want_rank}; vs the flat float64 step on the card "
          f"from the ranks' own stage: z within {F64_RTOL:g} of max|z| (max abs err "
          f"{z_err:.3e}); {summary}; {card}", flush=True)
    return {"seconds": call_s, "launches_per_rank": want_rank, **found}


def float64_slice_phase(dev, card: str, zp_65536, cohort_16384) -> dict:
    """Phase 17 (g) at the panel and ring shapes, and (i)'s ring and gather
    form. (g) The FP64 Gram's cross mode on blocks of phase 7's prepared z
    in float64 (F64_CROSS: the blocks of (i)'s ring, a rank's own among
    them, and of the fused ring at N=2504, and a [4096] block at offsets
    on and off a tile; R=1024), bitwise zprep_gram_panel's entries for the
    same rows of one split of all rows, within 1e-12 of its plain version,
    timed beside torch.mm float64 (DGEMM) with its bound by operations; its
    launch the plan's. The float64 multi kernel on the first F64_MULTI_PANELS 512-row
    panels at N=65,536 with MULTI_L loci (its wide mode) against its
    float64 plain version, timed. (i) The ring (``sharded_cohort_step``)
    and the gather form (``auto_sharded_cohort_step``) in float64 over
    F64_RING_WORLD ranks at phase 8's N=16,384, R=1024, each held to the
    flat float64 step on the card: z within 1e-12 of max|z|, lists under
    the tie rule at 1e-12 (counted), dipCN within 1e-9 where the input
    sets agree. Returns the cross mode's and the panels' numbers and the
    sharded runs' launches, seconds and tie counts."""
    import math

    from grid_tpu_torch.convert import inputs_to_torch, outputs_to_numpy
    from grid_tpu_torch.models.cohort import CohortParams, cohort_step
    from grid_tpu_torch.ops.gpu_kernels import (
        zprep_gram_cross, zprep_gram_cross_plain, zprep_gram_info, zprep_gram_panel,
        zprep_split, zprep_split_plain,
    )
    from grid_tpu_torch.ops.gpu_select import (
        dipcn_from_distances_multi_gpu, dipcn_select_info,
    )
    from grid_tpu_torch.ops.knn import panel_d2
    from grid_tpu_torch.ops.select import dipcn_from_distances_multi
    from torch_parity import assert_close_to_max
    from torch_plans import zprep_gram64_plan

    t_phase = time.perf_counter()
    f64 = torch.float64
    # ---- (g) the cross mode ------------------------------------------------
    rows = max(max(a_off, b_off) + b for b, a_off, b_off in F64_CROSS)
    cohort = zp_65536[:rows].to(f64).contiguous()
    r = cohort.shape[1]
    whole = zprep_split(cohort, None, None, math.inf)
    cross = {}
    for b, a_off, b_off in F64_CROSS:
        a_rows, b_rows = cohort[a_off:a_off + b].contiguous(), cohort[b_off:b_off + b].contiguous()
        sa, sb = (zprep_split(t, None, None, math.inf) for t in (a_rows, b_rows))
        pa, pb = (zprep_split_plain(t, None, None, math.inf) for t in (a_rows, b_rows))
        before = zprep_gram_cross.launches
        g = zprep_gram_cross(sa, sb, a_off, b_off)
        check(zprep_gram_cross.launches == before + 1 and g.dtype == f64, "(g) the cross launch")
        panel = zprep_gram_panel(whole, a_off, b)
        check(torch.equal(g, panel[:, b_off:b_off + b]),
              f"(g) zprep_gram_cross float64 [{b}, {b}] at offsets ({a_off}, {b_off}): not "
              f"bitwise the panel's entries")
        del panel
        want = zprep_gram_cross_plain(pa, pb)
        err = max_abs(g, want)
        check(err <= F64_RTOL * float(want.abs().max()),
              f"(g) zprep_gram_cross float64 [{b}, {b}]: {err:.3e} from P_a P_b^T, beyond "
              f"{F64_RTOL:g} of its largest entry")
        del want
        info = zprep_gram_info(b, dev, f64, "cross", b)
        plan = zprep_gram64_plan(b, b, "cross")
        check(info["spill_bytes"] == 0 and all(info[key] == plan[key] for key in (
            "tile", "k_tile", "stages", "threads", "smem_bytes", "blocks", "blocks_per_sm")),
            f"(g) the cross mode's launch {info} is not the plan {plan}")
        del g
        kern = lambda: zprep_gram_cross(sa, sb, a_off, b_off)  # noqa: E731
        plain = lambda: zprep_gram_cross_plain(pa, pb)  # noqa: E731
        lib = lambda: torch.mm(pa.p, pb.p.T)  # noqa: E731  a yardstick the port never calls
        t = {name: [] for name in ("plain", "kernel", "library")}
        for name in ("plain", "kernel", "library", "library", "kernel", "plain"):
            fn = {"plain": plain, "kernel": kern, "library": lib}[name]
            t[name].append(back_to_back_ms(fn, reps=10, warmup=2))
        best = {name: min(v) for name, v in t.items()}
        device_ms = median_ms(kern, reps=10, warmup=1)
        r_pad = sa.p.shape[-1]
        least, by = bound_ms(2 * b * r_pad * 8 + b * b * 8, 2 * b * b * r,
                             FP64_TENSOR_FLOP_PER_S)
        print(f"[f64] (g) zprep_gram_cross float64 [{b}, {b}] x R={r} at offsets ({a_off}, "
              f"{b_off}): one launch of {info['blocks']} tiles ({info['blocks'] / 132:.2f} waves; "
              f"{info['registers']} registers, no spill), bitwise zprep_gram_panel's entries for "
              f"the same rows of one split of {rows} rows, within {F64_RTOL:g} of P_a P_b^T (max "
              f"abs err {err:.3e}); kernel {best['kernel']:.4f} ms (10 back to back; device "
              f"{device_ms:.4f} ms, median of 10), plain {best['plain']:.4f} ms, torch.mm "
              f"float64 (DGEMM) {best['library']:.4f} ms (better of two rounds in turns); bound "
              f"{least:.4f} ms by {by} (2*Ba*Bb*R at 67 TFLOP/s), "
              f"{100 * least / best['kernel']:.1f}% of it; "
              f"{2 * b * b * r / best['kernel'] / 1e9:.1f} TFLOP/s; {card}", flush=True)
        cross[(b, a_off, b_off)] = {"ms": best["kernel"], "device_ms": device_ms, "plain_ms": best["plain"],
                    "library_ms": best["library"], "bound_ms": least, "bound_by": by,
                    "max_abs_err": err, "shape": f"[{b}, {b}] x R={r}",
                    "offsets": [a_off, b_off]}
        del sa, sb, pa, pb
    del whole, cohort
    torch.cuda.empty_cache()

    # ---- (g) the float64 multi kernel on panels at N=65,536 ----------------
    zp = zp_65536.to(f64)
    n, b = zp.shape[0], 512
    rng = np.random.default_rng(MULTI_SEED)
    usable = rng.random(n) > 0.02
    w = np.where(usable[:, None], rng.uniform(0.5, 2.0, (n, MULTI_L)), 0.0)
    w_t, _, u_t, v_t = multi_inputs(w, usable, dev, f64)
    row_valid = torch.ones(n, dtype=torch.bool, device=dev)
    split = zprep_split(zp, None, None, math.inf)
    del zp
    info = dipcn_select_info(n, K, dev, multi=True, dtype=f64)
    check(info["mode"] == "wide" and info["spill_bytes"] == 0,
          f"(g) the float64 multi form's launch at W={n}: {info}")
    err = 0.0
    for i0 in range(0, F64_MULTI_PANELS * b, b):
        d2 = panel_d2(zprep_gram_panel(split, i0, b), split.norms, i0, row_valid)
        check(d2.dtype == f64, "(g) the panel's d2 is not float64")
        args = (w_t[i0:i0 + b].contiguous(), w_t, u_t, v_t[i0:i0 + b].contiguous())
        dip, ok = dipcn_from_distances_multi_gpu(d2, *args, k=K, n_nbr=N_NBR)
        pdip, pok = dipcn_from_distances_multi(d2, *args, k=K, n_nbr=N_NBR)
        check(torch.equal(ok, pok) and torch.allclose(dip[ok], pdip[ok], rtol=F64_DIPCN_RTOL,
                                                      atol=0),
              f"(g) the float64 multi kernel on panel {i0 // b}: beyond its plain version")
        err = max(err, max_abs(dip[ok], pdip[ok]))
    panels = time_multi(f"on a [{b}, {n}] panel (the last checked), L={MULTI_L}", card, d2,
                        args, K, N_NBR, reps=5)
    print(f"[f64] (g) the float64 multi kernel on {F64_MULTI_PANELS} panels at N={n}, "
          f"L={MULTI_L} ({info['mode']} mode, {info['registers']} registers, no spill): ok equal "
          f"to its float64 plain version's, within rtol {F64_DIPCN_RTOL:g} (max abs err "
          f"{err:.3e}); {card}", flush=True)
    del d2, split, args, w_t, u_t, v_t
    torch.cuda.empty_cache()

    # ---- (i) the ring and the gather form in float64 -----------------------
    params = CohortParams(num_neighbors=K, n_nbr=N_NBR, n_iters=N_ITERS, quantize=False)
    n16, r16 = cohort_16384.values.shape
    t0 = time.perf_counter()
    flat = outputs_to_numpy(cohort_step(*inputs_to_torch(
        cohort_16384.values, cohort_16384.mask, cohort_16384.reads, np.ones(n16, bool),
        *ring_neighbors(n16), dev, f64), params))
    flat_s = time.perf_counter() - t0
    usable16 = flat.z_mask.any(axis=1)
    sharded = {}
    for form, run in (("ring", ring_run), ("gather", auto_run)):
        label = f"N={n16} R={r16} k={K}, W={F64_RING_WORLD}, float64"
        got, reports, wall = run(label, F64_RING_WORLD, cohort_16384, params, card, dtype=f64)
        z_err = assert_close_to_max(got.z, flat.z, F64_RTOL)
        found = {}
        summary = check_against(got, flat, usable16, N_NBR, f"(i) the float64 {form} vs the "
                                f"flat step", f64, found)
        print(f"[f64] (i) the {form} in float64 over {F64_RING_WORLD} ranks vs the flat float64 "
              f"step on the card ({flat_s:.1f} s with its first launches at N={n16}, host "
              f"clock): z within {F64_RTOL:g} of max|z| (max abs err {z_err:.3e}); {summary}",
              flush=True)
        sharded[form] = {"seconds": wall, "step_seconds": statistics.mean(
            rep["seconds"] for rep in reports),
            "launches_per_rank": {name: reports[0][name] for name in (
                "masked_column_stats", "zprep_split", "zprep_gram_cross", "zprep_gram_panel",
                "dipcn_from_distances_gpu", *SELECTION)},
            "cross_launches": sum(rep["zprep_gram_cross"] for rep in reports), **found}
    seconds = time.perf_counter() - t_phase
    print(f"[f64] phase 17 (g) at the panel and ring shapes and (i)'s ring and gather form took "
          f"{seconds:.1f} s (host clock); {card}", flush=True)
    return {"cross": cross, "multi_panels": panels | {"max_abs_err": err},
            "sharded": sharded, "phase_seconds": seconds}


# phase 18: device.dtype bfloat16 on the card (the flat step, file-mode step
# 4 and the sweep; with mesh_shape the sharded forms: (d)-(f))
BF16_PANELS = 3  # (b): the first, a middle and the last panel against the plain route
BF16_SWEEP_LOCI = 2  # (c): the bf16 sweep's loci (LPA and one drawn from the seed)
GRAM16_CPU_R = (1024, 2048)  # (a): the panels' R and the slice's


def gram16_cpu_sums(dev, card: str) -> dict:
    """Phase 18 (a): the bf16 Gram kernel against its plain version run on
    the CPU in float32 (each bf16 product exact, the sum in the CPU's
    float32, G rounded to bf16 once) under the bf16 Gram rule, at N=2504
    (the triangle, with the split pass) and on a [512, 65,536] panel, each
    at R = GRAM16_CPU_R. Beside the kernel: torch.mm bf16 (cuBLAS, also
    summing in the tensor cores' accumulator) and an IEEE float32 product
    on the card (TF32 off), rounded once; for each the share of G's entries
    that are not the CPU's (a sum by a bf16 rounding edge lands one ulp
    away). At N=2504 also the CPU route's own bf16 product, which phase
    4 holds the step to. Returns {cell: its numbers}."""
    from grid_tpu_torch.ops.gpu_kernels import _prepare, zprep_gram, zprep_gram_panel, zprep_split
    from torch_parity import bf16_gram_ratio

    gen = torch.Generator(device=dev).manual_seed(18)
    out = {}
    for r in GRAM16_CPU_R:
        for cell in ("triangle", "panel"):
            if cell == "triangle":
                n, rows = N, N
                z = (torch.randn((n, r), device=dev, generator=gen) * 3).to(torch.bfloat16)
                mask = torch.rand((n, r), device=dev, generator=gen) > 0.1
                region = torch.rand(r, device=dev, generator=gen) > 0.2
                g = zprep_gram(z, mask, region, ZMAX)
                p = _prepare(z, mask, region, ZMAX)
            else:
                n, rows = PANEL_N, 512
                z = torch.randn((n, r), device=dev, generator=gen).to(torch.bfloat16)
                g = zprep_gram_panel(zprep_split(z, None, None, float("inf")), 0, rows)
                p = z  # unclipped, unmasked: P is z
            routes = {"kernel": g, "torch.mm bf16": p[:rows] @ p.T,
                      "float32 on the card": (p[:rows].float() @ p.float().T).to(torch.bfloat16)}
            pc = p.cpu()
            t0 = time.perf_counter()
            want = (pc[:rows].float() @ pc.float().T).to(torch.bfloat16)
            cpu_s = time.perf_counter() - t0
            if cell == "triangle":
                routes["the CPU route (bf16)"] = pc @ pc.T
            want_np = want.float().numpy()
            row = {}
            for name, got in routes.items():
                got = got.cpu()
                row[name] = {"ratio": bf16_gram_ratio(got.float().numpy(), want_np),
                             "share_apart": float((got != want).float().mean())}
            check(row["kernel"]["ratio"] <= 1,
                  f"zprep_gram bf16 {cell} R={r}: at {row['kernel']['ratio']:.3f} of the Gram "
                  f"rule against the float32 sum on the CPU")
            out[f"{cell}_{r}"] = row
            print(f"[kernels bf16] zprep_gram {cell} [{rows}, {n}] x R={r} against the float32 "
                  f"sum on the CPU ({cpu_s:.1f} s, host clock), at a ratio of the bf16 Gram rule "
                  f"(entries not the CPU's): " + "; ".join(
                      f"{name} {v['ratio']:.3f} ({100 * v['share_apart']:.4f}%)"
                      for name, v in row.items()) + f"; {card}", flush=True)
            del z, g, p, pc, want, want_np, routes
    torch.cuda.empty_cache()
    return out


def bfloat16_phase(dev, card: str, values_np, mask_np, reads_np, sms: int, cohort_65536) -> tuple:
    """Phase 18 (a, b): ``device.dtype: bfloat16`` on the card. The dtype
    rules first (bf16 taken without ``mesh_shape`` and with it, in both
    forms; the steps grid_tpu runs without a dtype in float32), then
    (a) phases 3-6 in bf16 at N=2504 (:func:`kernels_phase`: each bf16
    kernel against its plain version, the step against the port's bf16 CPU
    route with every kernel launched and no plain version reached, each
    kernel timed beside its bound and library call) and (b) the panel step
    at N=65,536 (:func:`bfloat16_panel_run`). Returns the bf16 rows of the
    kernels line and the steps' numbers."""
    from grid_tpu_torch.utils.device import compute_dtype, step_dtype

    t_phase = time.perf_counter()
    bf = torch.bfloat16
    for cfg in ({"device": {"dtype": "bfloat16"}},
                {"device": {"dtype": "bf16", "mesh_shape": [2]}},
                {"device": {"dtype": "bfloat16", "mesh_shape": [2], "fused": True}}):
        check(compute_dtype(cfg, dev) is bf and step_dtype(cfg, dev) is torch.float32,
              f"bfloat16 on the card ({cfg}): compute_dtype must take it, step_dtype give "
              f"float32")
    print("[bf16] compute_dtype on the card: bfloat16 taken without device.mesh_shape and with "
          "it, in both forms (steps 4-6 in bf16, step_dtype float32 for the reads and the steps "
          "grid_tpu runs without a dtype)", flush=True)
    res = kernels_phase(dev, card, bf, values_np, mask_np, reads_np, sms)
    cpu_sums = gram16_cpu_sums(dev, card)
    a_s = time.perf_counter() - t_phase
    panel = bfloat16_panel_run(dev, card, cohort_65536)
    rows = {}
    for row in res.rows:
        name = row["name"]
        rows[name] = {**row, "name": f"{name}[bfloat16]", "panel_65536": panel["kernels"][name]}
    torch.cuda.empty_cache()
    print(f"[bf16] phase 18 (a) took {a_s:.1f} s, (b) {time.perf_counter() - t_phase - a_s:.1f} "
          f"s (host clock); {card}", flush=True)
    return rows, {"ms_2504": res.slice_ms, "busy_share_2504": res.busy, "ties_2504": res.ties,
                  "sets_2504": res.sets, "gram_cpu_sums": cpu_sums, **panel["step"]}


def bfloat16_panel_run(dev, card: str, cohort) -> dict:
    """Phase 18 (b): the bf16 step at N=65,536, R=1,024 on phase 7's cohort
    (8 GiB of bf16 distances, past the 2 GiB budget: the panel branch): its
    launches, no plain version reached; BF16_PANELS of its panels held
    against the plain route on the card (the plain split's Gram panel within
    BF16_ULPS of the kernel's; on the kernel's distances the plain
    selection and dipCN bitwise the kernels'; the step's rows of the panel
    against the plain route's at the bf16 contract, its ties counted); the
    step timed once; each kernel at the panel shapes beside its bound,
    plain version and library call. Returns the kernels' fields and the
    step's numbers."""
    from grid_tpu_torch.convert import inputs_to_torch, to_numpy
    from grid_tpu_torch.models.cohort import CohortParams, cohort_step, d2_resident
    from grid_tpu_torch.ops.gpu_kernels import (
        masked_column_stats, masked_column_stats_plain, zprep_gram_info, zprep_gram_panel,
        zprep_gram_panel_plain, zprep_split, zprep_split_plain,
    )
    from grid_tpu_torch.ops.gpu_select import (
        _launch, dipcn_from_distances_gpu, dipcn_select_info, knn_select_info,
        sorted_smallest_k_gpu,
    )
    from torch.profiler import ProfilerActivity, profile
    from grid_tpu_torch.ops.knn import panel_d2, sorted_smallest_k
    from grid_tpu_torch.ops.masked import masked_mean
    from grid_tpu_torch.ops.select import dipcn_from_distances
    from torch_parity import bf16_gram_ratio, bf16_ulps

    bf, e = torch.bfloat16, 2
    n, r = PANEL_N, PANEL_R
    params = CohortParams(num_neighbors=K, n_nbr=N_NBR, n_iters=N_ITERS, quantize=False)
    check(not d2_resident(params, n, e) and n * n * e == 8 << 30,
          "N=65,536 in bf16 (8 GiB of d2) must take the panel branch")
    b = params.row_block
    n_panels = -(-n // b)
    inputs = inputs_to_torch(cohort.values, cohort.mask, cohort.reads, np.ones(n, bool),
                             *ring_neighbors(n), dev, bf, torch.float32)
    counted = step_wrappers()
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with plain_calls_counted() as plains:
        out = cohort_step(*inputs, params)
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    want_launches = {"masked_column_stats": 2, "zprep_gram": 0, "zprep_split": 1,
                     "zprep_gram_panel": n_panels, "dipcn_from_distances_gpu": n_panels,
                     "sorted_smallest_k_gpu": n_panels, "phase_sweeps_gpu": 1}
    check(launches == want_launches, f"(b) bf16 panel launches {launches} != {want_launches}")
    check(not plains, f"(b) the bf16 panel step reached a plain version: {dict(plains)}")
    check(out.z.dtype == out.nbr_sq_dists.dtype == out.dipcn.dtype == bf, "(b) bf16 outputs")
    t0 = time.perf_counter()
    cohort_step(*inputs, params)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    print(f"[bf16] (b) cohort_step bfloat16 N={n} R={r} k={K}: first call {first_s:.2f} s, the "
          f"step timed once {1e3 * step_s:.1f} ms (host clock around a synchronized call); "
          f"launches {launches}, no plain version reached; {card}", flush=True)

    # ---- BF16_PANELS panels against the plain route on the card ----------
    z, zmask, region = out.z, out.z_mask, out.region_used
    sample_ok = zmask.any(dim=1)
    reads_valid = inputs[3] & sample_ok
    w = (inputs[2] / out.scales).to(bf)
    split, plain = zprep_split(z, zmask, region, ZMAX), zprep_split_plain(z, zmask, region, ZMAX)
    split_p = split.p[0, :, :r] if split.p.dim() == 3 else split.p  # [1, N, R_pad] on the card
    check(torch.equal(split_p, plain.p), "(b) the bf16 split's P is not the plain P")
    check(bf16_ulps(to_numpy(split.norms), to_numpy(plain.norms)) <= BF16_ULPS,
          "(b) the bf16 split's norms")
    nbr_idx, nbr_d = to_numpy(out.nbr_idx), to_numpy(out.nbr_sq_dists)
    dipcn, dipcn_ok = to_numpy(out.dipcn), to_numpy(out.dipcn_valid)
    usable = to_numpy(reads_valid)
    last = n - (n - 1) % b - 1
    ties = sets = 0
    errs = {"zprep_gram": 0.0, "sorted_smallest_k_gpu": 0.0, "dipcn_from_distances_gpu": 0.0}
    for i0 in (0, (n // 2 // b) * b, last)[:BF16_PANELS]:
        rows = slice(i0, i0 + min(b, n - i0))
        g = zprep_gram_panel(split, i0, rows.stop - i0)
        pg = zprep_gram_panel_plain(plain, i0, rows.stop - i0)
        check(bf16_gram_ratio(to_numpy(g), to_numpy(pg)) <= 1,
              f"(b) zprep_gram bf16 panel {i0}: beyond the Gram rule")
        errs["zprep_gram"] = max(errs["zprep_gram"], max_abs(g, pg))
        d2 = panel_d2(g, split.norms, i0, sample_ok)
        vals, idx = sorted_smallest_k_gpu(d2, K)
        pvals, pidx = sorted_smallest_k(d2, K)
        check(torch.equal(idx, pidx) and torch.equal(vals, pvals),
              f"(b) knn_select bf16 panel {i0}: not the plain selection's")
        dip_args = (d2, w[rows].contiguous(), w, reads_valid, reads_valid[rows].contiguous())
        dip, ok = dipcn_from_distances_gpu(*dip_args, k=K, n_nbr=N_NBR)
        pdip, pok = dipcn_from_distances(*dip_args, k=K, n_nbr=N_NBR)
        check(torch.equal(ok, pok) and torch.equal(dip[ok], pdip[ok]),
              f"(b) dipcn_select bf16 panel {i0}: not the plain dipCN bitwise")
        # the step's rows against the plain route: plain Gram, epilogue,
        # selection and dipCN
        pd2 = panel_d2(pg, plain.norms, i0, sample_ok)
        wv, wi = sorted_smallest_k(pd2, K)
        wdip, wok = dipcn_from_distances(pd2, *dip_args[1:], k=K, n_nbr=N_NBR)
        got = SimpleNamespace(nbr_idx=nbr_idx[rows], nbr_sq_dists=nbr_d[rows],
                              dipcn=dipcn[rows], dipcn_valid=dipcn_ok[rows])
        want = SimpleNamespace(nbr_idx=to_numpy(wi), nbr_sq_dists=to_numpy(wv),
                               dipcn=to_numpy(wdip), dipcn_valid=to_numpy(wok))
        found = {}
        summary = check_against(got, want, usable, N_NBR, f"(b) bf16 panel {i0}", bf, found)
        ties, sets = ties + found["ties"], sets + found["sets"]
        print(f"[bf16] (b) panel rows [{i0}, {rows.stop}): the Gram panel under the Gram rule "
              f"against the plain one, knn_select and dipcn_select bitwise their plain versions "
              f"on its distances; the step's rows vs the plain route: {summary}", flush=True)
        del d2, pd2, g, pg

    # ---- the kernels at the panel shapes --------------------------------
    rm = masked_mean(inputs[0], inputs[1], axis=1)
    good = torch.isfinite(rm) & (rm != 0)
    cs = (inputs[0], inputs[1] & good[:, None], torch.where(good, rm, 1))
    kw = {"round_squares": False}
    mu = out.col_means.nan_to_num()
    cnt, s_, sq = masked_column_stats(*cs, mu, **kw)
    pcnt, ps, psq = masked_column_stats_plain(*cs, mu, **kw)
    check(torch.equal(cnt, pcnt) and bf16_ulps(to_numpy(s_), to_numpy(ps)) <= BF16_ULPS
          and bf16_ulps(to_numpy(sq), to_numpy(psq)) <= BF16_ULPS,
          "(b) masked_column_stats bf16 at the panel shape")
    errs["masked_column_stats"] = max(max_abs(s_, ps), max_abs(sq, psq))
    g0 = zprep_gram_panel(split, 0, b)
    d2 = panel_d2(g0, split.norms, 0, sample_ok)
    dip_args = (d2, w[:b].contiguous(), w, reads_valid, reads_valid[:b].contiguous())
    p_panel = plain.p[:b]
    timed = {
        "masked_column_stats": (lambda: masked_column_stats(*cs, mu, **kw),
                                lambda: masked_column_stats_plain(*cs, mu, **kw), None),
        "zprep_gram": (lambda: zprep_gram_panel(split, 0, b),
                       lambda: zprep_gram_panel_plain(plain, 0, b),
                       lambda: torch.mm(p_panel, plain.p.T)),
        "dipcn_from_distances_gpu": (
            lambda: dipcn_from_distances_gpu(*dip_args, k=K, n_nbr=N_NBR),
            lambda: dipcn_from_distances(*dip_args, k=K, n_nbr=N_NBR), None),
        "sorted_smallest_k_gpu": (
            lambda: sorted_smallest_k_gpu(d2, K), lambda: sorted_smallest_k(d2, K),
            lambda: torch.sort(d2, dim=1, stable=True).values[:, :K]),
    }
    bounds = {
        "masked_column_stats": bound_ms(n * r * (e + 1) + e * n + e * r + 3 * e * r),
        "zprep_gram": bound_ms(n * r * e + b * n * e, 2 * b * n * r, BF16_FLOP_PER_S),
        "dipcn_from_distances_gpu": bound_ms(b * n * e + 2 * e * b + e * n + n + 2 * b),
        "sorted_smallest_k_gpu": bound_ms(b * n * e + (e + 4) * b * K),
    }
    dinfo, kinfo = dipcn_select_info(n, K, dev, dtype=bf), knn_select_info(n, K, dev, dtype=bf)
    ginfo = zprep_gram_info(n, dev, bf, "panel", b)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    check(ginfo["spill_bytes"] == 0 and ginfo["grid"] == min(ginfo["tiles"], sms),
          f"(b) the bf16 Gram's panel launch: {ginfo}")
    shapes = {"masked_column_stats": f"[{n}, {r}], 2 calls per step",
              "zprep_gram": f"split [{n}, {r}] once per step, then panels [{b}, {n}]: "
                            f"{gram16_shape(ginfo, sms)}",
              "dipcn_from_distances_gpu": f"{dinfo['mode']} mode, panels [{b}, {n}]",
              "sorted_smallest_k_gpu": f"{kinfo['mode']} mode ({kinfo['cluster_blocks']} block(s) "
                                       f"a row), panels [{b}, {n}], k={K}"}
    found = {}
    for name, (kernel_fn, plain_fn, lib_fn) in timed.items():
        p1, k1, k2, p2 = (back_to_back_ms(f, reps=5, warmup=1)
                          for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
        kernel_ms, plain_ms = min(k1, k2), min(p1, p2)
        lib_ms = None if lib_fn is None else min(back_to_back_ms(lib_fn, reps=5, warmup=1)
                                                 for _ in range(2))
        least, by = bounds[name]
        calls = launches["zprep_gram_panel" if name == "zprep_gram" else name]
        found[name] = {"launches": calls, "max_abs_err": errs[name], "ms": kernel_ms,
                       "plain_ms": plain_ms, "bound_ms": least, "bound_by": by,
                       "library_ms": lib_ms, "shape": shapes[name]}
        lib = "" if lib_ms is None else f", the library call {lib_ms:.4f} ms"
        print(f"[times bf16] {name} bfloat16 at {shapes[name]}: kernel {kernel_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms{lib} per call (5 back to back, better of two); bound "
              f"{least:.4f} ms by {by}, {100 * least / kernel_ms:.1f}% of it; {calls} calls per "
              f"step: {calls * kernel_ms:.1f} ms; {card}", flush=True)
    # dipcn_select's two modes on the panel (resident, wide, wide, resident),
    # and the mode the rule picks
    check(dinfo["mode"] == "wide", f"(b) dipcn_select bf16 on [{b}, {n}] must go wide")
    rinfo = dipcn_select_info(n, K, dev, dtype=bf, mode="resident")
    by_mode = {mode: (lambda mode=mode: _launch(mode, *dip_args, K, N_NBR))
               for mode in ("resident", "wide")}
    rounds = [(mode, back_to_back_ms(by_mode[mode], reps=5, warmup=1))
              for mode in ("resident", "wide", "wide", "resident")]
    mode_ms = {mode: min(t for m, t in rounds if m == mode) for mode in by_mode}
    found["dipcn_from_distances_gpu"].update(
        mode=dinfo["mode"], resident_mode_ms_back_to_back=mode_ms["resident"],
        wide_mode_ms_back_to_back=mode_ms["wide"],
        resident_blocks_per_sm=rinfo["blocks_per_sm"], wide_blocks_per_sm=dinfo["blocks_per_sm"])
    # the Gram panel's own device time (torch.profiler), beside its b2b time
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            zprep_gram_panel(split, 0, b)
        torch.cuda.synchronize()
    own = [e for e in prof.key_averages() if "gram16_kernel" in e.key]
    count = sum(e.count for e in own)
    gram_dev = sum(device_us(e) for e in own) / 1e3 / count if count else None
    found["zprep_gram"].update(device_ms=gram_dev, launch=ginfo,
                               library="torch.mm of the bf16 panel (cuBLAS)")
    found["sorted_smallest_k_gpu"]["library"] = "stable torch.sort of the panel's bf16 rows"
    gram = found["zprep_gram"]
    print(f"[times bf16] zprep_gram bf16 panel [{b}, {n}] x {r}: b2b {gram['ms']:.4f} ms, device "
          + ("not measured" if gram_dev is None else f"{gram_dev:.4f} ms")
          + f" (torch.profiler, mean of 5), {100 * gram['bound_ms'] / gram['ms']:.1f}% of its "
          f"{gram['bound_ms']:.4f} ms bound; torch.mm bf16 {gram['library_ms']:.4f} ms b2b "
          f"({gram['ms'] / gram['library_ms']:.3f}x); {card}", flush=True)
    print(f"[times bf16] dipcn_select at [{b}, {n}]: the rule picks the {dinfo['mode']} mode; "
          f"resident {mode_ms['resident']:.4f} ms ({rinfo['blocks_per_sm']} block(s) an SM, "
          f"{rinfo['smem_bytes']} B of dynamic shared memory), wide {mode_ms['wide']:.4f} ms "
          f"({dinfo['blocks_per_sm']} blocks an SM) back to back (better of two); {card}",
          flush=True)
    del out, inputs, split, plain, d2, g0, z, zmask
    torch.cuda.empty_cache()
    return {"kernels": found, "step": {"ms_65536": 1e3 * step_s, "first_call_s_65536": first_s,
                                       "ties_65536_panels": ties, "sets_65536_panels": sets}}


def bfloat16_pipeline_runs(card: str, tmp: Path, cohort: dict, base: dict, names: dict,
                           k: int, n_nbr: int) -> dict:
    """Phase 18 (c): ``run_wgs_pipeline`` with ``device.dtype: bfloat16`` on
    the card, fused and in file mode, on phase 9's cohort on disk, each held
    to the port's bf16 CPU route of the same form (``device.platform:
    cpu``): the normalized matrix's z within 2^-7 of max|z| (cells apart
    counted), the scales within a %.2f quantum, the variance-ratio header
    within rtol 2^-7; neighbor lists equal but for ties within 2^-7 of the
    row's k-th written distance; dipCN within rtol 2^-7 where the input sets
    agree; the four artifacts written; no plain version reached on the
    card. Returns each card run's launches, tie counts and seconds."""
    from grid_tpu_torch.io.formats import read_dipcn, read_neighbors, read_normalized_data
    from grid_tpu_torch.pipeline import run_wgs_pipeline
    from torch_parity import dipcn_sets_differ, neighbor_rows_differing

    found = {}
    for label, device in (("fused", {"fused": True, "dtype": "bfloat16"}),
                          ("files", {"dtype": "bfloat16"})):
        outs, seconds = {}, {}
        for where in ("card", "cpu"):
            cfg = copy.deepcopy(base)
            out = tmp / f"{where}_bf16_{label}"
            out.mkdir()
            cfg["output_dir"] = str(out)
            cfg["device"] = {**device, **({"platform": "cpu"} if where == "cpu" else {})}
            (out / "read_counts.tsv").write_bytes(cohort["counts_file"].read_bytes())
            counted = step_wrappers()
            for fn in counted.values():
                fn.launches = 0
            t0 = time.perf_counter()
            with plain_calls_counted() as plains:
                timings = run_wgs_pipeline(config=cfg)
            seconds[where] = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in counted.items()}
            for name in names.values():
                check((out / name).exists(), f"(c) bf16 {label} on the {where}: {name} missing")
            if where == "card":
                check(not plains, f"(c) the bf16 {label} run reached a plain version: "
                                  f"{dict(plains)}")
                check(launches["masked_column_stats"] == 2 and launches["phase_sweeps_gpu"] == 1
                      and launches["sorted_smallest_k_gpu"] > 0,
                      f"(c) the bf16 {label} run's launches {launches}")
                check(("fused_steps_4_7" in timings) == (label == "fused"),
                      f"(c) the bf16 {label} run took the other form: {sorted(timings)}")
                card_launches = launches
            outs[where] = out
        ids, ratios, z, scales = read_normalized_data(outs["card"] / names["normalized"])
        c_ids, c_ratios, c_z, c_scales = read_normalized_data(outs["cpu"] / names["normalized"])
        check(ids == c_ids and np.array_equal(np.isnan(z), np.isnan(c_z)),
              f"(c) bf16 {label}: the normalized rows or NA cells differ")
        z_err = float(np.nanmax(np.abs(z - c_z)))
        check(z_err <= BF16_RTOL * float(np.nanmax(np.abs(c_z))),
              f"(c) bf16 {label}: z differs by {z_err}")
        check(max(abs(scales[s] - c_scales[s]) for s in ids) <= QUANTUM
              and np.allclose(ratios, c_ratios, rtol=BF16_RTOL, equal_nan=True),
              f"(c) bf16 {label}: scales or variance ratios")
        z_apart = int(np.nansum(np.abs(z - c_z) > 1e-9))
        row = {s: i for i, s in enumerate(ids)}

        def lists(out):
            nbrs, _ = read_neighbors(out / names["neighbors"])
            return (np.array([[row[m] for m, _, _ in nbrs[s]] for s in ids]),
                    np.array([[dist for _, _, dist in nbrs[s]] for s in ids], np.float64))

        (got_idx, got_d), (want_idx, want_d) = lists(outs["card"]), lists(outs["cpu"])
        differ = neighbor_rows_differing(got_idx, got_d, want_idx, want_d,
                                         tol=BF16_RTOL * want_d[:, -1] + QUANTUM)
        dip_ids, dip, _ = read_dipcn(outs["card"] / names["dipcn"])
        want_ids, want_dip, _ = read_dipcn(outs["cpu"] / names["dipcn"])
        check(dip_ids == want_ids, f"(c) bf16 {label}: dipCN rows differ from the CPU run's")
        usable = np.array([s in set(dip_ids) for s in ids])
        sets = dipcn_sets_differ(got_idx, want_idx, usable, n_nbr)[[row[s] for s in dip_ids]]
        check(np.allclose(np.asarray(dip)[~sets], np.asarray(want_dip)[~sets], rtol=BF16_RTOL,
                          atol=0), f"(c) bf16 {label}: dipCN beyond rtol 2^-7 where the input "
                                   f"sets agree")
        found[label] = {"launches": card_launches, "rows_differing_by_ties": int(differ.size),
                        "dipcn_sets_differ": int(sets.sum()), "z_cells_apart": z_apart,
                        "seconds": seconds["card"], "seconds_cpu": seconds["cpu"]}
        print(f"[bf16] (c) run_wgs_pipeline, device {device}, on phase 9's {len(ids)} x "
              f"{len(ratios)} cohort: {seconds['card']:.1f} s on the card, launches "
              f"{card_launches}, no plain version reached; the port's bf16 CPU route "
              f"{seconds['cpu']:.1f} s (host clock). Normalized: z within 2^-7 of max|z| "
              f"({z_apart} of {int((~np.isnan(z)).sum())} cells apart, max {z_err:.3g}); "
              f"neighbor rows identical on {len(ids) - differ.size} of {len(ids)}, the others "
              f"differ only by ties within 2^-7 of the k-th written distance; "
              f"{int(sets.sum())} rows change a dipCN input set, dipCN within rtol 2^-7 on the "
              f"other {int((~sets).sum())}; {card}", flush=True)
    return found


def bfloat16_sweep_run(card: str, tmp: Path, base: dict, names: dict, k: int) -> dict:
    """Phase 18 (c), the sweep: ``run_multi_locus`` with ``device.dtype:
    bfloat16`` on the card over BF16_SWEEP_LOCI catalog loci (phase 11's
    per-locus counts): step 4 in bf16 (its normalized file byte for byte the
    bf16 file mode's of (c)), the batched dipCN and step 7 in float32 (the
    multi-weight kernel's float32 form), every artifact written, no plain
    version reached. Returns its launches and seconds."""
    from grid_tpu_torch.data.loci import load_vntr_catalog
    from grid_tpu_torch.ops.gpu_select import dipcn_from_distances_multi_gpu
    from grid_tpu_torch.steps import multilocus

    counts_dir = tmp / "multilocus"  # phase 11's per-locus counts
    first = {}
    for gene in dict.fromkeys(locus.gene for locus in load_vntr_catalog()):
        first.setdefault(gene.split(",")[0], gene)
    tag = {gene: t for t, gene in first.items()}
    others = [gene for gene in first.values() if gene != "LPA"]
    rng = np.random.default_rng(MULTI_SEED + 18)
    genes = ["LPA", *rng.choice(others, BF16_SWEEP_LOCI - 1, replace=False).tolist()]
    out = tmp / "multilocus_bf16_card"
    out.mkdir()
    for gene in genes:
        shutil.copy(counts_dir / f"read_counts.{tag[gene]}.tsv", out)
    cfg = copy.deepcopy(base)
    cfg["output_dir"] = str(out)
    cfg["device"] = {"dtype": "bfloat16"}
    cfg["compute_haploid_genotypes"]["run"] = True
    counted = {**step_wrappers(), "dipcn_from_distances_multi_gpu": dipcn_from_distances_multi_gpu}
    for fn in counted.values():
        fn.launches = 0
    console = Recorder()
    t0 = time.perf_counter()
    with plain_calls_counted() as plains:
        multilocus.run_multi_locus(cfg, genes, console)
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    failed = [msg for msg, style in console.lines if style == "danger" or "Failed to run" in msg]
    check(not failed, f"(c) the bf16 sweep: logged {failed[:3]}")
    check(not plains, f"(c) the bf16 sweep reached a plain version: {dict(plains)}")
    check(launches["masked_column_stats"] == 2 and launches["dipcn_from_distances_multi_gpu"] > 0
          and launches["phase_sweeps_gpu"] == len(genes),
          f"(c) the bf16 sweep's launches {launches}")
    for gene in genes:
        for prefix in ("diploid_genotypes", "haploid_genotypes"):
            check((out / f"{prefix}.{tag[gene]}.tsv").exists(), f"(c) bf16 sweep {gene}: {prefix}")
    check(content(out / names["normalized"])
          == content(tmp / "card_bf16_files" / names["normalized"]),
          "(c) the bf16 sweep's normalized file differs from the bf16 file mode's")
    print(f"[bf16] (c) run_multi_locus, device.dtype bfloat16, over {len(genes)} loci "
          f"({', '.join(genes)}) on phase 9's cohort, step 7 on: {seconds:.1f} s on the card "
          f"(host clock), launches {launches}, no plain version reached; step 4 in bf16, its "
          f"normalized file byte for byte the bf16 file mode's; the batched dipCN in float32; "
          f"{card}", flush=True)
    return {"launches": launches, "seconds": seconds}


# phase 18 (d)-(f): bfloat16 with device.mesh_shape
BF16_RING_WORLD = 2  # the bf16 sharded steps' ranks on the one card (gloo)
# (d): [B, B] blocks at (a's, b's) first rows: the ring's visiting block at
# N=16,384 over 2 ranks and a rank's own, the fused ring's at N=2504, and a
# block off the 128- and 256-row tiles
BF16_CROSS = ((8192, 0, 8192), (8192, 0, 0), (1252, 0, 0), (4096, 12288, 100))


def bfloat16_slice_phase(dev, card: str, zp_65536, cohort_16384) -> dict:
    """Phase 18 (d, e): bfloat16 with ``device.mesh_shape``. (d) The bf16
    Gram's cross mode in-process on blocks of phase 7's prepared z rounded
    to bf16 (BF16_CROSS, R=1024): each block bitwise zprep_gram_panel's
    entries for the same rows of one split of all rows, within the bf16
    Gram rule of its plain version (P_a P_b^T in bf16), its launch the
    plan's, timed back to back beside torch.mm bf16 with its bound by
    operations at 989 TFLOP/s. (e) The ring (``sharded_cohort_step``) and
    the gather form (``auto_sharded_cohort_step``) in bf16 over
    BF16_RING_WORLD ranks at phase 8's N=16,384, R=1024: the ring's lists
    held to a whole-row selection (``knn_select``) on the panel-mode Gram
    of the ring's own prepared z under the tie rule at tol 0 (the cross
    mode is the panel mode's entries), its dipCN float32 (the reads'
    dtype, never rounded to bf16); the gather form held to the card's flat
    bf16 panel step at the bf16 contract (rows apart by ties and dipCN
    sets counted). Returns the cross mode's numbers and the sharded runs'
    launches, seconds and counts."""
    from grid_tpu_torch.convert import inputs_to_torch, outputs_to_numpy
    from grid_tpu_torch.models.cohort import CohortParams, cohort_step
    from grid_tpu_torch.ops.gpu_kernels import (
        zprep_gram_cross, zprep_gram_cross_plain, zprep_gram_info, zprep_gram_panel,
        zprep_split, zprep_split_plain,
    )
    from grid_tpu_torch.ops.gpu_select import sorted_smallest_k_gpu
    from grid_tpu_torch.ops.knn import d2_panels, prepare_z
    from torch_parity import assert_close_to_max, bf16_gram_ratio, neighbor_rows_differing
    from torch_plans import zprep_gram16_plan

    t_phase = time.perf_counter()
    bf = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # ---- (d) the cross mode ------------------------------------------------
    rows = max(max(a_off, b_off) + b for b, a_off, b_off in BF16_CROSS)
    cohort = zp_65536[:rows].to(bf).contiguous()
    r = cohort.shape[1]
    whole = zprep_split(cohort, None, None, math.inf)
    cross = {}
    for b, a_off, b_off in BF16_CROSS:
        a_rows, b_rows = cohort[a_off:a_off + b].contiguous(), cohort[b_off:b_off + b].contiguous()
        sa, sb = (zprep_split(t, None, None, math.inf) for t in (a_rows, b_rows))
        pa, pb = (zprep_split_plain(t, None, None, math.inf) for t in (a_rows, b_rows))
        before = zprep_gram_cross.launches
        g = zprep_gram_cross(sa, sb, a_off, b_off)
        check(zprep_gram_cross.launches == before + 1 and g.dtype == bf, "(d) the cross launch")
        panel = zprep_gram_panel(whole, a_off, b)
        check(torch.equal(g, panel[:, b_off:b_off + b]),
              f"(d) zprep_gram_cross bf16 [{b}, {b}] at offsets ({a_off}, {b_off}): not bitwise "
              f"the panel's entries")
        del panel
        want = zprep_gram_cross_plain(pa, pb)
        ratio = bf16_gram_ratio(g.float().cpu().numpy(), want.float().cpu().numpy())
        check(ratio <= 1, f"(d) zprep_gram_cross bf16 [{b}, {b}]: at {ratio:.3f} of the bf16 "
                          f"Gram rule against P_a P_b^T")
        err = max_abs(g.float(), want.float())
        del want
        info = zprep_gram_info(b, dev, bf, "cross", b)
        plan = zprep_gram16_plan(b, b, "cross", sms)
        check(info["spill_bytes"] == 0 and all(info[key] == plan[key] for key in plan),
              f"(d) the bf16 cross mode's launch {info} is not the plan {plan}")
        del g
        kern = lambda: zprep_gram_cross(sa, sb, a_off, b_off)  # noqa: E731
        plain = lambda: zprep_gram_cross_plain(pa, pb)  # noqa: E731
        lib = lambda: torch.mm(pa.p, pb.p.T)  # noqa: E731  a yardstick the port never calls
        t = {name: [] for name in ("plain", "kernel", "library")}
        for name in ("plain", "kernel", "library", "library", "kernel", "plain"):
            fn = {"plain": plain, "kernel": kern, "library": lib}[name]
            t[name].append(back_to_back_ms(fn, reps=10, warmup=2))
        best = {name: min(v) for name, v in t.items()}
        device_ms = median_ms(kern, reps=10, warmup=1)
        r_pad = sa.p.shape[-1]
        least, by = bound_ms(2 * b * r_pad * 2 + b * b * 2, 2 * b * b * r, BF16_FLOP_PER_S)
        print(f"[bf16] (d) zprep_gram_cross bf16 [{b}, {b}] x R={r} at offsets ({a_off}, "
              f"{b_off}): one launch of {info['tiles']} tiles on {info['grid']} blocks "
              f"({info['registers']} registers, no spill), bitwise zprep_gram_panel's entries for "
              f"the same rows of one split of {rows} rows, within the bf16 Gram rule of P_a P_b^T "
              f"(ratio {ratio:.3f}, max abs err {err:.3e}); kernel {best['kernel']:.4f} ms (10 "
              f"back to back; device {device_ms:.4f} ms, median of 10), plain {best['plain']:.4f} "
              f"ms, torch.mm bf16 {best['library']:.4f} ms (better of two rounds in turns); bound "
              f"{least:.4f} ms by {by} (2*Ba*Bb*R at 989 TFLOP/s), "
              f"{100 * least / best['kernel']:.1f}% of it; "
              f"{2 * b * b * r / best['kernel'] / 1e9:.1f} TFLOP/s; {card}", flush=True)
        cross[(b, a_off, b_off)] = {
            "ms": best["kernel"], "device_ms": device_ms, "plain_ms": best["plain"],
            "library_ms": best["library"], "bound_ms": least, "bound_by": by,
            "max_abs_err": err, "gram_rule_ratio": ratio, "shape": f"[{b}, {b}] x R={r}",
            "offsets": [a_off, b_off]}
        del sa, sb, pa, pb
    del whole, cohort
    torch.cuda.empty_cache()
    d_s = time.perf_counter() - t_phase

    # ---- (e) the ring and the gather form in bf16 --------------------------
    params = CohortParams(num_neighbors=K, n_nbr=N_NBR, n_iters=N_ITERS, quantize=False)
    n16, r16 = cohort_16384.values.shape
    w = BF16_RING_WORLD
    label = f"N={n16} R={r16} k={K}, W={w}, bfloat16"
    sharded = {}
    got, reports, wall = ring_run(label, w, cohort_16384, params, card, dtype=bf)
    check(got.dipcn.dtype == np.float32 and got.hap_irrs.dtype == np.float32,
          "(e) the bf16 ring's dipCN and step 7 must stay float32 (the reads' dtype)")
    dip = got.dipcn[got.dipcn_valid]
    off_grid = float(np.mean(dip != torch.from_numpy(dip).to(bf).float().numpy()))
    check(off_grid > 0.9, f"(e) the bf16 ring's dipCN sits on the bf16 grid ({off_grid:.3f})")
    # the ring's lists against one whole-row selection on the panel-mode
    # Gram of the ring's own prepared z
    z = torch.from_numpy(got.z).to(dev).to(bf)
    z_mask = torch.from_numpy(got.z_mask).to(dev)
    region = torch.from_numpy(got.region_used).to(dev)
    zp = prepare_z(z, z_mask, params.zmax, region_mask=region)
    split = zprep_split(zp, None, None, math.inf)
    sample_ok = z_mask.any(dim=1)
    sq, idx = [], []
    for _, d2 in d2_panels(split, 512, sample_ok):
        vals, nbr = sorted_smallest_k_gpu(d2, K)
        sq.append(vals.float().cpu())
        idx.append(nbr.cpu())
        del d2
    want_d, want_idx = torch.cat(sq).numpy(), torch.cat(idx).numpy()
    del z, z_mask, zp, split
    differ = neighbor_rows_differing(got.nbr_idx, got.nbr_sq_dists.astype(np.float64),
                                     want_idx, want_d.astype(np.float64), tol=0)
    same = np.ones(n16, bool)
    same[differ] = False
    check(np.array_equal(got.nbr_sq_dists[same], want_d[same]),
          "(e) the bf16 ring's distances are not the panel selection's where the lists agree")
    print(f"[bf16] (e) the ring's lists in bf16 over {w} ranks vs a whole-row knn_select on the "
          f"panel-mode Gram of its own prepared z: identical on {n16 - differ.size} of {n16} rows, "
          f"the other {differ.size} differ only by the order of exact ties (tol 0), the distances "
          f"bitwise where the lists agree; dipCN float32, {100 * off_grid:.1f}% of it off the bf16 "
          f"grid; {card}", flush=True)
    sharded["ring"] = {"seconds": wall, "step_seconds": statistics.mean(
        rep["seconds"] for rep in reports), "start_seconds": statistics.mean(
        rep["start_seconds"] for rep in reports),
        "spans": {key: statistics.mean(rep[key] for rep in reports)
                  for key in reports[0] if key.startswith("sharded.")},
        "launches_per_rank": {name: reports[0][name] for name in (
            "masked_column_stats", "zprep_split", "zprep_gram_cross", *SELECTION)},
        "cross_launches": sum(rep["zprep_gram_cross"] for rep in reports),
        "rows_differing_by_ties_vs_panel_selection": int(differ.size)}
    t0 = time.perf_counter()
    flat = outputs_to_numpy(cohort_step(*inputs_to_torch(
        cohort_16384.values, cohort_16384.mask, cohort_16384.reads, np.ones(n16, bool),
        *ring_neighbors(n16), dev, bf, torch.float32), params._replace(d2_budget_bytes=0)))
    flat_s = time.perf_counter() - t0
    got, reports, wall = auto_run(label, w, cohort_16384, params, card, dtype=bf)
    z_err = assert_close_to_max(got.z, flat.z, BF16_RTOL)
    z_apart = int((got.z != flat.z).sum())
    found = {}
    summary = check_against(got, flat, flat.z_mask.any(axis=1), N_NBR,
                            "(e) the bf16 gather form vs the flat bf16 panel step", bf, found)
    print(f"[bf16] (e) the gather form in bf16 over {w} ranks vs the flat bf16 panel step on the "
          f"card ({flat_s:.1f} s with its first launches, host clock): z within 2^-7 of max|z| "
          f"({z_apart} of {got.z.size} entries apart, max {z_err:.3e}); {summary}; {card}",
          flush=True)
    sharded["gather"] = {"seconds": wall, "step_seconds": statistics.mean(
        rep["seconds"] for rep in reports), "start_seconds": statistics.mean(
        rep["start_seconds"] for rep in reports),
        "spans": {key: statistics.mean(rep[key] for rep in reports)
                  for key in reports[0] if key.startswith(("sharded.", "auto."))},
        "launches_per_rank": {name: reports[0][name] for name in (
            "masked_column_stats", "zprep_split", "zprep_gram_panel", "dipcn_from_distances_gpu",
            *SELECTION)}, "z_entries_apart": z_apart, **found}
    seconds = time.perf_counter() - t_phase
    print(f"[bf16] phase 18 (d) took {d_s:.1f} s, (e) {seconds - d_s:.1f} s (host clock); {card}",
          flush=True)
    return {"cross": cross, "sharded": sharded, "phase_seconds": seconds}


def bfloat16_sharded_runs(card: str, tmp: Path, cohort: dict, base: dict, names: dict,
                          k: int, n_nbr: int) -> dict:
    """Phase 18 (f): ``run_wgs_pipeline`` fused with ``mesh_shape: [2],
    dispatch: ring`` in bf16 on phase 9's cohort (the sharded step over
    BF16_RING_WORLD gloo ranks of the card: the bf16 cross mode, bf16 ring
    shifts), its four artifacts written, no plain version reached, held to
    the port's bf16 CPU route of the same config (``platform: cpu``: the
    ring on gloo ranks of the host, which rounds where grid_tpu's ring
    rounds) under (c)'s rules: z within 2^-7 of max|z| (cells apart
    counted), the scales within a %.2f quantum, the variance-ratio header
    within rtol 2^-7, lists under the tie rule at 2^-7 of the k-th written
    distance, dipCN within rtol 2^-7 where the input sets agree. Then
    ``staged_sharded_cohort_step`` in bf16 over BF16_RING_WORLD ranks on
    phase 9's files (phase 16 (c)'s size: each rank stages its share into
    a bf16 buffer): its buffers hold bf16 values, and the step is bitwise
    ``sharded_cohort_step`` in bf16 on the card from the stage its ranks
    made; every rank's launches checked. Returns the runs' launches,
    seconds and counts."""
    import grid_tpu_torch.parallel.pcohort as pcohort
    import torch_ranks
    from grid_tpu_torch.io.bed import load_repeat_mask
    from grid_tpu_torch.io.formats import (
        read_counts_tsv, read_dipcn, read_neighbors, read_normalized_data,
    )
    from grid_tpu_torch.models.cohort import CohortOutputs, CohortParams
    from grid_tpu_torch.ops.gpu_kernels import zprep_gram_cross
    from grid_tpu_torch.parallel import sharded_cohort_step, staged_sharded_cohort_step
    from grid_tpu_torch.parallel.mesh import block_rows
    from grid_tpu_torch.parallel.pknn import MERGE_ROWS
    from grid_tpu_torch.pipeline import run_wgs_pipeline
    from torch_parity import dipcn_sets_differ, neighbor_rows_differing

    w = BF16_RING_WORLD
    device = {"fused": True, "dtype": "bfloat16", "mesh_shape": [w], "dispatch": "ring"}
    outs, seconds = {}, {}
    for where in ("card", "cpu"):
        out = tmp / f"{where}_bf16_ring"
        out.mkdir()
        cfg = copy.deepcopy(base)
        cfg["output_dir"] = str(out)
        cfg["device"] = {**device, **({"platform": "cpu"} if where == "cpu" else {})}
        (out / "read_counts.tsv").write_bytes(cohort["counts_file"].read_bytes())
        counted = {**step_wrappers(), "zprep_gram_cross": zprep_gram_cross}
        for fn in counted.values():
            fn.launches = 0
        console = Recorder()
        t0 = time.perf_counter()
        with plain_calls_counted() as plains:
            timings = run_wgs_pipeline(config=cfg, console=console)
        seconds[where] = time.perf_counter() - t0
        check("fused_steps_4_7" in timings and [msg for msg, _ in console.lines
                                                if msg.startswith("sharded step:")],
              f"(f) the bf16 ring run on the {where} did not take the sharded step")
        for name in names.values():
            check((out / name).exists(), f"(f) the bf16 ring run on the {where}: {name} missing")
        if where == "card":
            launches = {name: fn.launches for name, fn in counted.items()}
            check(not plains, f"(f) the bf16 ring run reached a plain version: {dict(plains)}")
            check(launches["masked_column_stats"] == 2 * w and launches["zprep_split"] == w
                  and launches["zprep_gram_cross"] == w * w and launches["phase_sweeps_gpu"] == 1
                  and launches["sorted_smallest_k_gpu"] > 0
                  and launches["zprep_gram"] + launches["zprep_gram_panel"] == 0,
                  f"(f) the bf16 ring run's launches {launches}")
            device_s = timings["fused.device"]
        outs[where] = out
    ids, ratios, z, scales = read_normalized_data(outs["card"] / names["normalized"])
    c_ids, c_ratios, c_z, c_scales = read_normalized_data(outs["cpu"] / names["normalized"])
    check(ids == c_ids and np.array_equal(np.isnan(z), np.isnan(c_z)),
          "(f) the bf16 ring run's normalized rows or NA cells differ from the CPU's")
    z_err = float(np.nanmax(np.abs(z - c_z)))
    check(z_err <= BF16_RTOL * float(np.nanmax(np.abs(c_z))), f"(f) z differs by {z_err}")
    check(max(abs(scales[s] - c_scales[s]) for s in ids) <= QUANTUM
          and np.allclose(ratios, c_ratios, rtol=BF16_RTOL, equal_nan=True),
          "(f) the bf16 ring run's scales or variance ratios")
    z_apart = int(np.nansum(np.abs(z - c_z) > 1e-9))
    row = {s: i for i, s in enumerate(ids)}

    def lists(where):
        nbrs, _ = read_neighbors(where / names["neighbors"])
        return (np.array([[row[m] for m, _, _ in nbrs[s]] for s in ids]),
                np.array([[dist for _, _, dist in nbrs[s]] for s in ids], np.float64))

    (got_idx, got_d), (want_idx, want_d) = lists(outs["card"]), lists(outs["cpu"])
    differ = neighbor_rows_differing(got_idx, got_d, want_idx, want_d,
                                     tol=BF16_RTOL * want_d[:, -1] + QUANTUM)
    dip_ids, dip, _ = read_dipcn(outs["card"] / names["dipcn"])
    want_ids, want_dip, _ = read_dipcn(outs["cpu"] / names["dipcn"])
    check(dip_ids == want_ids, "(f) the bf16 ring run's dipCN rows differ from the CPU's")
    usable = np.array([s in set(dip_ids) for s in ids])
    sets = dipcn_sets_differ(got_idx, want_idx, usable, n_nbr)[[row[s] for s in dip_ids]]
    check(np.allclose(np.asarray(dip)[~sets], np.asarray(want_dip)[~sets], rtol=BF16_RTOL,
                      atol=0), "(f) the bf16 ring run's dipCN beyond rtol 2^-7")
    found = {"pipeline_ring": {"launches": launches, "seconds": seconds["card"],
                               "fused_device_seconds": device_s, "seconds_cpu": seconds["cpu"],
                               "z_cells_apart": z_apart, "rows_differing_by_ties": int(differ.size),
                               "dipcn_sets_differ": int(sets.sum())}}
    print(f"[bf16] (f) run_wgs_pipeline, device {device}, on phase 9's {len(ids)} x "
          f"{len(ratios)} cohort: {seconds['card']:.1f} s on the card (host clock; fused.device "
          f"{device_s:.1f} s, spawn included), launches {launches}, no plain version reached; "
          f"the port's bf16 CPU ring {seconds['cpu']:.1f} s. Normalized: z within 2^-7 of "
          f"max|z| ({z_apart} of {int((~np.isnan(z)).sum())} cells apart, max {z_err:.3g}); "
          f"neighbor rows identical on {len(ids) - differ.size} of {len(ids)}, the others "
          f"differ only by ties within 2^-7 of the k-th written distance; {int(sets.sum())} rows "
          f"change a dipCN input set, dipCN within rtol 2^-7 on the other "
          f"{int((~sets).sum())}; {card}", flush=True)

    # ---- the sharded stager in bf16 ----------------------------------------
    t0 = time.perf_counter()
    norm_cfg = base["mosdepth"]["normalize"]
    lo, hi = norm_cfg["min_depth"], norm_cfg["max_depth"]
    excluded = load_repeat_mask(norm_cfg["repeat_mask_file"])
    counts = read_counts_tsv(cohort["counts_file"])
    params = CohortParams(num_neighbors=k, n_nbr=n_nbr, n_iters=N_ITERS, quantize=False)
    n = len(cohort["ids"])
    hap = ring_neighbors(n)
    reports = []
    keep_dir = tmp / "stage18_kept"
    keep_dir.mkdir()
    with keeping(pcohort, "_rank_staged_step", torch_ranks.staged_rank_keeping_stage, keep_dir):
        stage, staged = staged_sharded_cohort_step(
            w, base["mosdepth"]["work_dir"], cohort["ids"], counts, *hap, params, lo, hi,
            excluded=excluded, dtype=torch.bfloat16, reports=reports)
    call_s = time.perf_counter() - t0
    b = block_rows(n, w)
    want_rank = {"masked_column_stats": 2, "zprep_split": 1, "zprep_gram_cross": w,
                 "sorted_smallest_k_gpu": w * -(-b // MERGE_ROWS), "phase_sweeps_gpu": 1,
                 "zprep_gram": 0, "zprep_gram_panel": 0, "dipcn_from_distances_gpu": 0}
    for rank, rep in enumerate(reports):
        got_rank = {name: rep[name] for name in want_rank}
        check(got_rank == want_rank, f"(f) the bf16 staged step: rank {rank} launched {got_rank}")
    check(staged.z.dtype == torch.bfloat16 and staged.dipcn.dtype == torch.float32,
          "(f) the bf16 staged step's outputs: z bf16, dipCN float32")
    many = load_stage(keep_dir, "stage", w)
    values = torch.from_numpy(many["values"])
    check(torch.equal(values, values.to(torch.bfloat16).float()),
          "(f) the bf16 stage's buffers hold values off the bf16 grid")
    check(stage.n == n, "(f) the bf16 stage's sample count")
    ids = stage.sample_ids
    reads = np.array([counts.get(sid, 0.0) for sid in ids])
    reads_valid = np.array([sid in counts for sid in ids])
    t0 = time.perf_counter()
    ring = sharded_cohort_step(w, many["values"][:n], many["mask"][:n], reads, reads_valid, *hap,
                               params, dtype=torch.bfloat16)
    ring_s = time.perf_counter() - t0
    for name in CohortOutputs._fields:
        got, want = getattr(staged, name), getattr(ring, name)
        if name in pcohort.ROW_FIELDS:
            got, want = got[:n], want[:n]
        check(got.dtype == want.dtype and torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
              and torch.equal(got.isnan() if got.is_floating_point() else got,
                              want.isnan() if want.is_floating_point() else want),
              f"(f) the bf16 staged step's {name} is not the ring's from the host arrays")
    print(f"[bf16] (f) staged_sharded_cohort_step in bf16 over {w} ranks on phase 9's {n} files "
          f"({call_s:.2f} s for the call, host clock, spawn included; the ranks' stage.pass2 "
          f"{', '.join('%.3f' % rep['stage.pass2'] for rep in reports)} s, host buffers "
          f"{', '.join('%.2f' % (rep['host_buffer_bytes'] / 2**20) for rep in reports)} MiB with "
          f"bf16 values), launches per rank {want_rank}; every output bitwise "
          f"sharded_cohort_step's in bf16 on the card from the stage its ranks made ({ring_s:.2f} "
          f"s); {card}", flush=True)
    found["stage"] = {"seconds": call_s, "launches_per_rank": want_rank,
                      "ring_from_host_seconds": ring_s}
    return found


def clock(start: float, done: str) -> None:
    """Prints the host seconds since ``start`` (the script's start) once
    the phases ``done`` have ended, so the log shows where the script's
    time limit goes."""
    print(f"[clock] {done} done at {time.perf_counter() - start:.1f} s", flush=True)


def main() -> int:
    t_script = time.perf_counter()
    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run", file=sys.stderr)
        return 1
    # the plain versions' matmuls must run in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    repo = Path(__file__).resolve().parent
    sys.path[:0] = [str(repo), str(repo / "tests")]
    card = card_line()
    print(f"[device] {card}  (torch {torch.__version__}, CUDA {torch.version.cuda})", flush=True)

    from grid_tpu_torch.synth import make_matrix
    from grid_tpu_torch import native, native_host
    from grid_tpu_torch.models.cohort import cohort_step
    from grid_tpu_torch.ops.gpu_kernels import (
        colstats_plan, masked_column_stats, masked_column_stats_plain, zprep_gram,
    )
    from grid_tpu_torch.ops.gpu_select import (
        _knn_launch, dipcn_from_distances_gpu, dipcn_select_info, sorted_smallest_k_gpu,
    )
    from grid_tpu_torch.ops.phasing import (
        _sweeps_launch, _sweeps_probe, phase_bootstrap_slots, phase_sweeps, phase_sweeps_gpu,
        phase_sweeps_info, phase_sweeps_mode,
    )
    from grid_tpu_torch.utils.device import get_device

    dev = get_device("cuda")
    wrappers = {
        "masked_column_stats": masked_column_stats,
        "zprep_gram": zprep_gram,
        "dipcn_from_distances_gpu": dipcn_from_distances_gpu,
    }
    selectors = {"sorted_smallest_k_gpu": sorted_smallest_k_gpu,
                 "phase_sweeps_gpu": phase_sweeps_gpu}

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()

    def build_host() -> float:
        start = time.perf_counter()
        native_host.build()
        return time.perf_counter() - start

    # one nvcc per source and the host library's g++, all started together
    with ThreadPoolExecutor(len(native.KERNELS) + 1) as pool:
        host_build = pool.submit(build_host)
        list(pool.map(native.build, native.KERNELS))
        host_build_s = host_build.result()
    print(f"[build] nvcc of {', '.join(native.KERNELS)} and g++ of the host library in parallel: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    host_phase(host_build_s)
    for name in native.KERNELS:
        native.load(name)
        found = ptxas_functions(native.build(name).with_suffix(".log").read_text())
        if name == "sw_scores":  # one function per instance of its table: phase 13 lists them
            regs = [f["registers"] for f in found]
            lines = [f"sw_scores: {len(regs)} functions, {min(regs)}-{max(regs)} registers, "
                     f"{sum(f['spill_bytes'] for f in found)} bytes of spill stores and loads "
                     f"in all"]
        else:
            lines = [f"{f['function']}: {f['registers']} registers, {f['usage']}, "
                     f"{f['spill_bytes']} bytes spilled" for f in found]
        for line in lines:
            print(f"[build]   ptxas: {line}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    col_tiles, chunks, rows_per_chunk = colstats_plan(N, R, sms)
    col_programs = col_tiles * chunks
    print(f"[build] masked_column_stats at {N}x{R}: {chunks} row chunks of {rows_per_chunk} "
          f"rows, {col_programs} programs in the main pass ({col_programs / sms:.2f} per SM), "
          f"then one merge in chunk order", flush=True)
    check(col_programs >= 4 * sms, "masked_column_stats: fewer than 4 programs per SM")
    t0 = time.perf_counter()
    tiny = torch.ones((4, 3), device=dev)
    masked_column_stats(tiny, tiny > 0, torch.ones(4, device=dev))
    torch.cuda.synchronize()
    print(f"[build] masked_column_stats: Triton JIT {time.perf_counter() - t0:.1f} s", flush=True)
    gram64_shapes(dev, sms)

    clock(t_script, "phases 1-2 (the build)")
    # ---- 3-6. kernels, the slice, times, profile --------------------------
    values_np, mask_np, reads_np = make_matrix(N, R)
    res = kernels_phase(dev, card, torch.float32, values_np, mask_np, reads_np, sms)
    kernels, kinfo, pinfo = res.rows, res.kinfo, res.pinfo
    d2, w_main, sample_ok, dip_args = res.d2, res.w_main, res.sample_ok, res.dip_args
    inputs, params, out = res.inputs, res.params, res.out
    step_hap0, step_irrs, step_lists = res.step
    irrs_main, rand_lists, boot_slots, boot_lists = (res.irrs_main, res.rand_lists,
                                                     res.boot_slots, res.boot_lists)
    clock(t_script, "phases 3-6")
    # ---- 5 (continued). float32 times beyond each kernel's own -----------
    # CohortParams.dipcn_lists: dipCN from knn_select's lists in tensor code
    # on the card, beside dipcn_select's route on the same d2: the same
    # validity, dipCN within 1e-6 relative (the same take-set summed in
    # another order); the step with the flag runs the list route once and
    # no dipcn_select
    from grid_tpu_torch.ops.select import dipcn_from_lists

    sq_l, idx_l = sorted_smallest_k_gpu(d2, K)
    lists_args = (d2, sq_l, idx_l, w_main, w_main, sample_ok, sample_ok)
    dip_l, ok_l = dipcn_from_lists(*lists_args, k=K, n_nbr=N_NBR)
    dip_s, ok_s = dipcn_from_distances_gpu(*dip_args, k=K, n_nbr=N_NBR)
    torch.cuda.synchronize()
    check(torch.equal(ok_l, ok_s), "dipcn_lists: validity differs from dipcn_select's")
    check(torch.allclose(dip_l[ok_l], dip_s[ok_s], rtol=1e-6, atol=0),
          "dipcn_lists: beyond 1e-6 relative of dipcn_select's dipCN")
    lists_rel = float(((dip_l[ok_l].double() - dip_s[ok_s]) / dip_s[ok_s]).abs().max())
    lists_counted = {"sorted_smallest_k_gpu": sorted_smallest_k_gpu,
                     "dipcn_from_distances_gpu": dipcn_from_distances_gpu,
                     "dipcn_from_lists": dipcn_from_lists}
    for fn in lists_counted.values():
        fn.launches = 0
    out_l = cohort_step(*inputs, params._replace(dipcn_lists=True))
    torch.cuda.synchronize()
    lists_launches = {name: fn.launches for name, fn in lists_counted.items()}
    check(lists_launches == {"sorted_smallest_k_gpu": 1, "dipcn_from_distances_gpu": 0,
                             "dipcn_from_lists": 1},
          f"the step with dipcn_lists launched {lists_launches}")
    ok_step = out.dipcn_valid
    check(torch.equal(out_l.dipcn_valid, ok_step)
          and torch.allclose(out_l.dipcn[ok_step], out.dipcn[ok_step], rtol=1e-6, atol=0),
          "the step with dipcn_lists: dipCN or its validity differs from dipcn_select's step")
    lists_fn = lambda: dipcn_from_lists(*lists_args, k=K, n_nbr=N_NBR)  # noqa: E731
    lists_ms = min(median_ms(lists_fn) for _ in range(2))
    lists_b2b = min(back_to_back_ms(lists_fn) for _ in range(2))
    dip_row = next(row for row in kernels if row["name"] == "dipcn_from_distances_gpu")
    dip_row.update(lists_route_ms=lists_ms, lists_route_ms_back_to_back=lists_b2b,
                   lists_route_launches=lists_launches["dipcn_from_lists"],
                   lists_route_max_rel_err=lists_rel)
    print(f"[times] dipcn_lists at [{N}, {N}], k={K}, n_nbr={N_NBR}: validity identical to "
          f"dipcn_select's ({int(ok_l.sum())} rows), dipCN within 1e-6 relative (max "
          f"{lists_rel:.3e}); the step with the flag launched {lists_launches}; the route "
          f"{lists_ms:.4f} ms (median of {REPS}), {lists_b2b:.4f} ms back to back, beside "
          f"dipcn_select's {dip_row['ms']:.4f} / {dip_row['ms_back_to_back']:.4f} ms; {card}",
          flush=True)
    del sq_l, idx_l, lists_args, dip_l, dip_s, out_l

    # dipcn_select's two modes on the same rows in each dtype: the table the
    # mode rule's least resident blocks an SM comes from
    next(row for row in kernels if row["name"] == "dipcn_from_distances_gpu").update(
        mode_table_back_to_back=dipcn_mode_table(dev, card))

    # knn_select beside torch.topk (the same set, no tie order) and in its
    # wide mode; phase_sweeps on 20 bootstrap replicates
    knn_wide_ms = min(back_to_back_ms(lambda: _knn_launch("wide", d2, K)) for _ in range(2))
    # what holds the resident launch: one row an SM (a row's latency), then
    # the rows the card holds at once (one wave), beside all N rows; back to
    # back, and the kernel's own device time under torch.profiler (a launch
    # of few rows may be shorter than the wrapper's host cost)
    from torch.profiler import ProfilerActivity, profile

    def knn_device_ms(rows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                _knn_launch(kinfo["mode"], d2[:rows], K)
            torch.cuda.synchronize()
        own = [e for e in prof.key_averages() if "knn_select_kernel" in e.key]
        count = sum(e.count for e in own)
        return sum(device_us(e) for e in own) / 1e3 / count if count else None

    wave_rows = (sms, min(N, kinfo["blocks_per_sm"] * sms), N)
    knn_wave_ms = {rows: (min(back_to_back_ms(lambda rows=rows: _knn_launch(kinfo["mode"],
                                                                            d2[:rows], K))
                              for _ in range(2)), knn_device_ms(rows)) for rows in wave_rows}
    boot = (irrs_main, *rand_lists, boot_slots, 1, N_ITERS)
    boot_ms = [median_ms(lambda: phase_bootstrap_slots(*boot), reps=5) for _ in range(2)]
    with patched(sys.modules["grid_tpu_torch.ops.phasing"],
                 {"phase_sweeps_gpu": lambda hap, irrs, *rest: phase_sweeps(hap, irrs, *rest)}):
        boot_plain_ms = [median_ms(lambda: phase_bootstrap_slots(*boot), reps=5)
                         for _ in range(2)]
    # both modes on the slice's ring lists (K=2) and on lists of the
    # pipeline's default max_neighbors (K=10), in turns forward then
    # backward; what a resident sweep is made of: the kernel with the list
    # walk alone (no exchange) and with the exchange alone (no walk), at
    # N_ITERS sweeps and at one; the 20 bootstrap replicates in each mode;
    # the floor of a launch a sweep, N_ITERS empty launches back to back
    out_sweep = torch.empty((1, 2 * N), device=dev)
    rand_hap0 = hap_start(irrs_main, rand_lists[2])
    sweep_modes, sweep_parts = {}, {}
    for label, (h0, irrs_, lists) in (("K=2", (step_hap0, step_irrs, step_lists)),
                                      ("K=10", (rand_hap0, irrs_main, rand_lists))):
        check(phase_sweeps_mode(N, lists[0].shape[1], dev) == "resident",
              f"phase_sweeps at N={N}, {label} must take the resident mode")
        idx32 = lists[0].to(torch.int32)
        modes = phasing_modes(N, lists[0].shape[1], dev)
        run = {m: (lambda m=m, h0=h0, irrs_=irrs_, idx32=idx32, lists=lists:
                   _sweeps_launch(m, h0, irrs_, idx32, *lists[1:], N_ITERS, out_sweep))
               for m in modes}
        rounds = [(name, back_to_back_ms(run[name])) for name in [*run, *reversed(run)]]
        sweep_modes[label] = {name: min(t for m, t in rounds if m == name) for name in run}
        sweep_parts[label] = {
            part: tuple(min(back_to_back_ms(lambda part=part, iters=iters, h0=h0, irrs_=irrs_,
                                            idx32=idx32, lists=lists:
                                            _sweeps_probe(part, h0, irrs_, idx32, *lists[1:],
                                                          iters, out_sweep))
                            for _ in range(2)) for iters in (N_ITERS, 1))
            for part in ("whole", "exchange", "walk")}
    out_boot = torch.empty((BOOT_REPLICATES, 2 * N), device=dev)
    boot_modes = {}
    for m in phasing_modes(N, 10, dev):
        boot_modes[m] = min(back_to_back_ms(
            lambda m=m: _sweeps_launch(m, rand_hap0, irrs_main, *boot_lists, N_ITERS, out_boot),
            reps=5) for _ in range(2))
    del out_boot
    # the wrapper's whole call (its checks, the index check's sync, the
    # launch) beside the kernel alone, by torch.profiler
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            phase_sweeps_gpu(step_hap0, step_irrs, *step_lists, N_ITERS)
        torch.cuda.synchronize()
    own = [e for e in prof.key_averages() if "phase_resident_kernel" in e.key]
    own_count = sum(e.count for e in own)
    sweep_kernel_ms = (sum(device_us(e) for e in own) / 1e3 / own_count if own_count else None)
    empty_ms = min(back_to_back_ms(lambda: torch.cuda._sleep(0), reps=10 * N_ITERS)
                   for _ in range(2))
    pinfo10 = phase_sweeps_info(N, 10, dev)
    knn_row = next(row for row in kernels if row["name"] == "sorted_smallest_k_gpu")
    topk_ms = knn_row["topk_ms"]
    knn_row.update(wide_mode_ms_back_to_back=knn_wide_ms,
                   rows_ms_back_to_back={str(r): t[0] for r, t in knn_wave_ms.items()},
                   rows_device_ms={str(r): t[1] for r, t in knn_wave_ms.items()})
    sweep_row = next(row for row in kernels if row["name"] == "phase_sweeps_gpu")
    sweep_row.update(bootstrap_20_ms=min(boot_ms), bootstrap_20_plain_ms=min(boot_plain_ms),
                     bootstrap_20_modes_ms_back_to_back=boot_modes,
                     modes_ms_back_to_back=sweep_modes,
                     parts_ms_back_to_back={label: {name: {"sweeps": t[0], "one_sweep": t[1]}
                                                    for name, t in parts.items()}
                                            for label, parts in sweep_parts.items()},
                     kernel_device_ms=sweep_kernel_ms,
                     launch_a_sweep_floor_ms=N_ITERS * empty_ms)
    print(f"[times] knn_select [{N}, {N}] k={K}: kernel {knn_row['ms']:.4f} ms (resident mode; "
          f"the wide mode {knn_wide_ms:.4f} ms back to back), the stable torch.sort sliced to k "
          f"{knn_row['library_ms']:.4f} ms, torch.topk (largest=False, sorted) {topk_ms:.4f} ms; "
          f"{card}", flush=True)
    print(f"[times] knn_select [rows, {N}] k={K}, a launch back to back (better of two) and "
          f"its device time (torch.profiler, mean of {REPS}): "
          + ", ".join(f"{rows} rows {b2b:.4f} / "
                      + ("not measured" if dev_ms is None else f"{dev_ms:.4f}") + " ms"
                      for rows, (b2b, dev_ms) in knn_wave_ms.items())
          + f" ({wave_rows[0]}: one a SM; {wave_rows[1]}: one wave at {kinfo['blocks_per_sm']} "
          f"blocks per SM); {card}", flush=True)
    modes_text = "; ".join(
        f"{label}: " + ", ".join(f"{name} {t:.4f} ms ({1e3 * t / N_ITERS:.2f} us a sweep)"
                                 for name, t in times.items())
        for label, times in sweep_modes.items())
    print(f"[times] phase_sweeps N={N}, K=2, {N_ITERS} sweeps, a cluster of "
          f"{pinfo['cluster_blocks']} blocks: the wrapper's call {sweep_row['ms']:.4f} ms "
          f"(median), {sweep_row['ms_back_to_back']:.4f} ms back to back, the kernel alone "
          + ("not measured" if sweep_kernel_ms is None else f"{sweep_kernel_ms:.4f} ms")
          + f" (torch.profiler, mean of {REPS}); the Python loop {sweep_row['plain_ms']:.4f} ms; "
          f"bound {sweep_row['bound_ms']:.6f} ms by {sweep_row['bound_by']} (inputs read once, "
          f"output written once); the modes back to back (better of two rounds) {modes_text}; "
          f"the floor of a launch a sweep, {N_ITERS} empty launches back to back, "
          f"{N_ITERS * empty_ms:.4f} ms; {card}", flush=True)
    for label, parts in sweep_parts.items():
        print(f"[times] phase_sweeps N={N}, {label}, what a resident sweep is made of (back to "
              f"back, better of two; {N_ITERS} sweeps / 1 sweep, then per sweep as the "
              f"difference over {N_ITERS - 1}): "
              + "; ".join(f"{name} {t[0]:.4f} / {t[1]:.4f} ms, "
                          f"{1e3 * (t[0] - t[1]) / (N_ITERS - 1):.3f} us a sweep"
                          for name, t in parts.items()) + f"; {card}", flush=True)
    print(f"[times] phase_sweeps {BOOT_REPLICATES} bootstrap replicates (N={N}, K=10, "
          f"{phase_sweeps_mode(N, 10, dev)} mode, {pinfo10['smem_bytes']} B of shared memory a "
          f"block, {pinfo10['clusters']} clusters at once): phase_bootstrap_slots "
          f"{min(boot_ms):.4f} ms, the loop {min(boot_plain_ms):.4f} ms (medians of 5, better "
          f"of two); the kernel alone back to back in each mode "
          + ", ".join(f"{name} {t:.4f} ms" for name, t in boot_modes.items()) + f"; {card}",
          flush=True)
    torch.cuda.empty_cache()

    # the genome-wide normalize's column statistics, made on the card
    gen = torch.Generator(device=dev).manual_seed(0)
    g_vals = torch.rand(GENOME, device=dev, generator=gen) * 50 + 10
    g_mask = torch.rand(GENOME, device=dev, generator=gen) > 0.15
    g_inv = 1 / g_vals.mean(dim=1)
    g_mu = torch.rand(GENOME[1], device=dev, generator=gen) + 0.5
    g_cnt, g_sum, g_sq = masked_column_stats(g_vals, g_mask, g_inv, g_mu)
    g_want = masked_column_stats_plain(g_vals, g_mask, g_inv, g_mu)
    check(torch.equal(g_cnt, g_want[0]), "masked_column_stats genome-wide: counts differ")
    check(torch.allclose(g_sum, g_want[1], rtol=1e-5, atol=0)
          and torch.allclose(g_sq, g_want[2], rtol=1e-5, atol=0),
          "masked_column_stats genome-wide: sums")
    del g_want
    g_kernel = lambda: masked_column_stats(g_vals, g_mask, g_inv, g_mu)  # noqa: E731
    g_plain = lambda: masked_column_stats_plain(g_vals, g_mask, g_inv, g_mu)  # noqa: E731
    gp1, gk1, gk2, gp2 = (back_to_back_ms(f, reps=5)
                          for f in (g_plain, g_kernel, g_kernel, g_plain))
    g_n, g_r = GENOME
    g_least, g_by = bound_ms(g_n * g_r * 5 + 4 * g_n + 4 * g_r + 12 * g_r)
    _, g_chunks, _ = colstats_plan(g_n, g_r, sms)
    print(f"[times] masked_column_stats genome-wide {g_n}x{g_r} ({g_chunks} row chunk(s)): "
          f"kernel {min(gk1, gk2):.4f} ms, plain {min(gp1, gp2):.4f} ms (5 back to back, better "
          f"of two rounds); bound {g_least:.4f} ms by {g_by}, "
          f"{100 * g_least / min(gk1, gk2):.1f}% of it; counts exact, sums within rtol 1e-5; "
          f"{card}", flush=True)
    del g_vals, g_mask
    torch.cuda.empty_cache()

    clock(t_script, "phase 5's float32 times")
    # ---- 7. panels and 8. branches ---------------------------------------
    panel, panel_zp, cohort_65536 = panel_phase(dev, card)
    cohort_16384 = branch_phase(dev, card)

    clock(t_script, "phases 7-8")
    # ---- 17 (a-c, e, f). device.dtype float64 on the card -----------------
    f64_rows, f64_step = float64_phase(dev, card, values_np, mask_np, reads_np, sms)
    clock(t_script, "phase 17 (a-c, e, f)")
    f64_slice = float64_slice_phase(dev, card, panel_zp, cohort_16384)
    clock(t_script, "phase 17 (g) at the panel and ring shapes, (i) the ring and gather form")
    # ---- 18 (a, b). device.dtype bfloat16 on the card ---------------------
    bf16_rows, bf16_step = bfloat16_phase(dev, card, values_np, mask_np, reads_np, sms,
                                          cohort_65536)
    clock(t_script, "phase 18 (a, b)")
    # ---- 18 (d, e). bfloat16 with mesh_shape: the cross mode, the ring and
    # the gather form ------------------------------------------------------
    bf16_slice = bfloat16_slice_phase(dev, card, panel_zp, cohort_16384)
    clock(t_script, "phase 18 (d, e)")
    # ---- 15 (a-c). the sharded ring on W ranks of the one card ------------
    ring = ring_phase(dev, card, cohort_16384, cohort_65536, panel_zp)
    clock(t_script, "phase 15 (a-c)")
    # ---- 16 (a, b). the gather form on W ranks of the one card -----------
    auto = auto_phase(dev, card, cohort_16384, cohort_65536, ring)
    del cohort_16384, cohort_65536

    clock(t_script, "phase 16 (a, b)")
    # ---- 9. the pipeline, from files, 10. in file mode, 11. multi-locus ----
    # (with 14 (b, c), 15 (d) and 16 (c, d) on the same cohort)
    (pipeline_launches, files_launches, multi, ibs_launches, ring_launches,
     f64_runs, f64_files, bf16_files) = pipeline_phase(card, wrappers)
    multi_wide = multilocus_wide_phase(card, panel_zp)
    del panel_zp
    torch.cuda.empty_cache()

    clock(t_script, "phases 9-11 (with 14 (b, c), 15 (d), 16 (c, d))")
    # ---- 12. steps 1-3 from alignments in front of steps 4-7 --------------
    align = alignment_phase(card, wrappers)
    align_json = {name: {"launches": align["fused"][name], "files": align["files"][name]}
                  for name in wrappers}
    for name in ("zprep_split", "zprep_gram_panel"):
        align_json["zprep_gram"][name] = {"fused": align["fused"][name],
                                          "files": align["files"][name]}
    files_json = {"masked_column_stats": {"launches": files_launches["masked_column_stats"]},
                  "zprep_gram": {"launches": files_launches["zprep_gram"],
                                 "zprep_split": files_launches["zprep_split"],
                                 "zprep_gram_panel": files_launches["zprep_gram_panel"]},
                  "dipcn_from_distances_gpu": {
                      "launches": files_launches["dipcn_from_distances_gpu"]}}

    multi_launches = multi["launches"]
    multi_json = {"masked_column_stats": {"launches": multi_launches["masked_column_stats"]},
                  "zprep_gram": {"launches": multi_launches["zprep_gram"],
                                 "zprep_split": multi_launches["zprep_split"],
                                 "zprep_gram_panel": multi_launches["zprep_gram_panel"]},
                  "dipcn_from_distances_gpu": {
                      "launches": multi_launches["dipcn_from_distances_gpu"]}}
    rows = []
    for row in kernels:
        earlier = {key: row[key] for key in row if key not in ("name", "route", "source",
                                                                "replaces")}
        fixed = {key: row[key] for key in ("name", "route", "source", "replaces")}
        if row["name"] in selectors:  # the ring's and the gather form's launches per rank
            rows.append({**fixed, **panel[row["name"]], "slice_2504": earlier,
                         "ring": {key: {row["name"]: v[row["name"]]}
                                  for key, v in ring["selection"].items()},
                         "auto": {key: {row["name"]: auto[key][row["name"]]}
                                  for key in ("launches_per_rank_16384_w4",
                                              "launches_per_rank_65536_w4")}})
            continue
        rows.append({**fixed,
                     **panel[row["name"]], "slice_2504": earlier,
                     "pipeline_2504": {"launches": pipeline_launches[row["name"]]},
                     "pipeline_files_2504": files_json[row["name"]],
                     "multilocus_2504": multi_json[row["name"]],
                     f"alignments_{ALIGN_N}": align_json[row["name"]],
                     "ibs_2504": {"launches": ibs_launches[row["name"]]}})
    # phase 15: the ring's launches per rank, its pipeline call's over all
    # ranks, and the Gram kernel's cross mode
    for row in rows:
        if row["name"] in ("zprep_gram", "masked_column_stats"):
            row["ring"] = ring[row["name"]]
            names = (("zprep_split", "zprep_gram_cross") if row["name"] == "zprep_gram"
                     else (row["name"],))
            row["ring"]["pipeline_2504_w4"] = {name: ring_launches[name] for name in names}
        if row["name"] == "zprep_gram":
            row["ring"]["peak_bytes_per_rank_65536_w4"] = ring["peak_bytes_per_rank_65536_w4"]
    # phase 16: the gather form's launches per rank
    auto_names = {"masked_column_stats": ("masked_column_stats",),
                  "zprep_gram": ("zprep_split", "zprep_gram_panel", "zprep_gram_cross"),
                  "dipcn_from_distances_gpu": ("dipcn_from_distances_gpu",)}
    for row in rows:
        if row["name"] in auto_names:
            row["auto"] = {key: {name: auto[key][name] for name in auto_names[row["name"]]}
                           for key in ("launches_per_rank_16384_w4",
                                       "launches_per_rank_65536_w4")}
            if row["name"] == "zprep_gram":
                row["auto"]["peak_bytes_per_rank_65536_w4"] = auto[
                    "peak_bytes_per_rank_65536_w4"]
    # the cross mode as a row of its own: its main path is phase 15 (a)'s
    # run at N=16,384 over 4 ranks (the launches of all four ranks)
    cross = ring["zprep_gram"]["cross_16384_w4"]
    rows.append({"name": "zprep_gram_cross", "route": "cuda",
                 "source": "grid_tpu_torch/csrc/zprep_gram.cu",
                 "replaces": "grid_tpu/parallel/pknn.py:74 (jnp.dot, no pallas_call)",
                 "launches": ring["cross_launches_16384_w4"],
                 "max_abs_err": cross["max_abs_err"], "ms": cross["ms"],
                 "plain_ms": cross["plain_ms"], "bound_ms": cross["bound_ms"],
                 "bound_by": cross["bound_by"], "library_ms": cross["library_ms"],
                 "library": "torch.mm of the two prepared blocks, TF32 off",
                 "shape": cross["shape"], "own_block_ms": cross["own_block_ms"],
                 "at_65536_w4": ring["zprep_gram"]["cross_65536_w4"]})
    # the multi-weight form: the sweep over the catalog at N=2504 is its
    # main path, its numbers those at L=492 there
    at_l = multi["timed"][MULTI_L]
    rows.append({"name": "dipcn_from_distances_multi_gpu", "route": "cuda",
                 "source": "grid_tpu_torch/csrc/dipcn_select.cu",
                 "replaces": "grid_tpu/ops/pallas_select.py:130",
                 "launches": multi_launches["dipcn_from_distances_multi_gpu"],
                 "max_abs_err": multi["max_abs_err"], "ms": at_l["ms"],
                 "plain_ms": at_l["plain_ms"], "bound_ms": at_l["bound_ms"],
                 "bound_by": at_l["bound_by"], "library_ms": at_l["library_ms"],
                 "library": "torch.mm of the [N, N] float32 take mask by W, TF32 off: the sum "
                            "part alone",
                 "shape": f"resident mode, d2 [{N}, {N}], L={MULTI_L}",
                 "by_l_2504": {str(l): v for l, v in multi["timed"].items()},
                 "max_abs_err_vs_binary": multi["max_abs_err_binary"],
                 "launches_second_call": multi["launches_call2"]["dipcn_from_distances_multi_gpu"],
                 "launches_panel_branch": multi["launches_panels"][
                     "dipcn_from_distances_multi_gpu"],
                 "panels_65536": multi_wide})
    clock(t_script, "phase 12")
    # ---- 13. the WES path: the Smith-Waterman kernel and the pipeline ------
    sw = sw_kernel_phase(dev, card)
    at_q = sw["timed"][SW_TIMED_Q[0]]
    sw_launches = wes_phase(card)
    clock(t_script, "phase 13")
    # ---- 14. compute_ibs: the engine (a) and the tools (d); (b, c) ran on
    # phase 9's cohort ------------------------------------------------------
    ibs_engine_phase(card)
    tools_phase(card)
    rows.append({"name": "sw_scores_gpu", "route": "cuda",
                 "source": "grid_tpu_torch/csrc/sw_scores.cu",
                 "replaces": "grid_tpu/ops/align.py:42 (lax.scan, no pallas_call)",
                 "launches": sw_launches, "max_abs_err": sw["max_abs_err"], "ms": at_q["ms"],
                 "ms_back_to_back": at_q["ms_back_to_back"], "plain_ms": at_q["plain_ms"],
                 "bound_ms": at_q["bound_ms"], "bound_by": "operations",
                 "bound_share": at_q["bound_share"], "library_ms": None,
                 "int32_bound_ms": at_q["int32_bound_ms"],
                 "int32_bound_share": at_q["int32_bound_share"],
                 "shape": f"Q={SW_TIMED_Q[0]}, Lq={WES_READ_LEN}, T=3, Lr=182, "
                          f"{at_q['shape']['form']} form, G={at_q['shape']['G']}, "
                          f"S={at_q['shape']['S']}",
                 "sm_clock_mhz_now_max": sw["clock_mhz"],
                 "sass_instructions_per_cell": [
                     {k: lp[k] for k in ("kernel", "form", "g", "s", "instructions", "shuffles")}
                     | {"per_cell": round(lp["per_cell"], 3)} for lp in sw["sass"]],
                 "by_q": {str(q): v for q, v in sw["timed"].items()},
                 f"by_shape_q{SW_SMALL_Q}": sw["small_q"]})
    clock(t_script, "phase 14")
    # phase 17: the float64 forms, each a row of its own; its launches those
    # of the float64 N=2504 step (b), the panel step's and the pipeline
    # runs' (d) beside them
    for name, row in f64_rows.items():
        row["step"] = f64_step
        for label, run in f64_runs.items():
            names64 = (("zprep_gram", "zprep_split", "zprep_gram_panel", "zprep_gram_cross")
                       if name == "zprep_gram" else (name,))
            row[f"pipeline_2504_{label}"] = {key: run["launches"][key] for key in names64}
        row["pipeline_2504_ties"] = {label: {key: run[key] for key in (
            "rows_differing_by_ties", "dipcn_sets_differ", "haploid_lines_differ")}
            for label, run in f64_runs.items()}
        rows.append(row)
    # phase 17 (g-i): the float64 multi-weight form, its main path the
    # float64 sweep (h), its numbers those at L=492 on the sweep's d2
    sweep64 = f64_files["sweep"]
    at_l = sweep64["timed"][MULTI_L]
    rows.append({"name": "dipcn_from_distances_multi_gpu[float64]", "route": "cuda",
                 "source": "grid_tpu_torch/csrc/dipcn_select.cu",
                 "replaces": "grid_tpu/ops/pallas_select.py:130",
                 "launches": sweep64["launches"]["dipcn_from_distances_multi_gpu"],
                 "max_abs_err": sweep64["max_abs_err"], "ms": at_l["ms"],
                 "ms_back_to_back": at_l["ms_back_to_back"], "plain_ms": at_l["plain_ms"],
                 "bound_ms": at_l["bound_ms"], "bound_by": at_l["bound_by"],
                 "bound_share": at_l["bound_share"], "library_ms": at_l["library_ms"],
                 "library": "torch.mm of the [N, N] float64 take mask by W (DGEMM): the sum "
                            "part alone",
                 "shape": f"resident mode, d2 [{N}, {N}] float64, L={MULTI_L}",
                 "by_l_2504": {str(l): v for l, v in sweep64["timed"].items()},
                 "max_abs_err_vs_binary": sweep64["max_abs_err_binary"],
                 "panels_65536": f64_slice["multi_panels"],
                 "sweep_2504": {key: sweep64[key] for key in (
                     "launches", "seconds_card", "seconds_cpu", "rows_differing_by_ties",
                     "dipcn_sets_differ", "haploid_tables_differ")}})
    # the FP64 cross mode: its main path (i)'s float64 ring at N=16,384 over
    # 2 ranks (the launches of both ranks), its numbers at that ring's
    # visiting block, [8192, 8192]
    cross64 = f64_slice["cross"][F64_CROSS[0]]
    rows.append({"name": "zprep_gram_cross[float64]", "route": "cuda",
                 "source": "grid_tpu_torch/csrc/zprep_gram64.cu",
                 "replaces": "grid_tpu/parallel/pknn.py:74 (jnp.dot, no pallas_call)",
                 "launches": f64_slice["sharded"]["ring"]["cross_launches"],
                 "max_abs_err": cross64["max_abs_err"], "ms": cross64["ms"],
                 "device_ms": cross64["device_ms"], "plain_ms": cross64["plain_ms"],
                 "bound_ms": cross64["bound_ms"], "bound_by": cross64["bound_by"],
                 "library_ms": cross64["library_ms"],
                 "library": "torch.mm of the two prepared float64 blocks (DGEMM)",
                 "shape": cross64["shape"], "offsets": cross64["offsets"],
                 "other_blocks": [f64_slice["cross"][key] for key in F64_CROSS[1:]],
                 "sharded_16384_w2": f64_slice["sharded"],
                 "pipeline_2504_ring_w2": f64_runs["ring"]["launches"]["zprep_gram_cross"],
                 "staged_2504_w2": f64_files["stage"]})
    # phase 18: the bf16 forms, each a row of its own; its launches those of
    # the bf16 N=2504 step (a), the panel step's (b) and the pipeline runs'
    # and the sweep's (c) beside them
    for name, row in bf16_rows.items():
        row["step"] = bf16_step
        names16 = ("zprep_gram", "zprep_split", "zprep_gram_panel") if name == "zprep_gram" \
            else (name,)
        for label, run in bf16_files["runs"].items():
            row[f"pipeline_2504_{label}"] = {key: run["launches"][key] for key in names16}
        row["pipeline_2504_ties"] = {label: {key: run[key] for key in (
            "rows_differing_by_ties", "dipcn_sets_differ", "z_cells_apart")}
            for label, run in bf16_files["runs"].items()}
        row["sweep_2504"] = {key: bf16_files["sweep"]["launches"][key] for key in names16}
        # (d)-(f): bf16 with mesh_shape, the launches per rank of the ring
        # and the gather form at N=16,384 over 2 ranks and of the staged step
        # at N=2504, and the pipeline ring's over both ranks
        keys16 = names16 + (("zprep_gram_cross",) if name == "zprep_gram" else ())
        runs = {f"{form}_16384_w{BF16_RING_WORLD}": run["launches_per_rank"]
                for form, run in bf16_slice["sharded"].items()}
        runs[f"staged_2504_w{BF16_RING_WORLD}"] = bf16_files["sharded"]["stage"][
            "launches_per_rank"]
        runs[f"pipeline_2504_ring_w{BF16_RING_WORLD}"] = bf16_files["sharded"][
            "pipeline_ring"]["launches"]
        for key, launched in runs.items():
            row[key] = {kn: v for kn, v in launched.items() if kn in keys16}
        if name == "zprep_gram":
            row["cross"] = {"launches_per_rank_16384_w2": bf16_slice["sharded"]["ring"][
                "launches_per_rank"]["zprep_gram_cross"],
                **bf16_slice["cross"][BF16_CROSS[0]]}
        rows.append(row)
    # the bf16 cross mode: its main path (e)'s bf16 ring at N=16,384 over 2
    # ranks (the launches of both ranks), its numbers at that ring's
    # visiting block, [8192, 8192]
    cross16 = bf16_slice["cross"][BF16_CROSS[0]]
    rows.append({"name": "zprep_gram_cross[bfloat16]", "route": "cuda",
                 "source": "grid_tpu_torch/csrc/zprep_gram16.cu",
                 "replaces": "grid_tpu/ops/pallas_kernels.py:93 (the ring's jnp.dot, "
                             "grid_tpu/parallel/pknn.py:74)",
                 "launches": bf16_slice["sharded"]["ring"]["cross_launches"],
                 "max_abs_err": cross16["max_abs_err"], "ms": cross16["ms"],
                 "device_ms": cross16["device_ms"], "plain_ms": cross16["plain_ms"],
                 "bound_ms": cross16["bound_ms"], "bound_by": cross16["bound_by"],
                 "library_ms": cross16["library_ms"],
                 "library": "torch.mm of the two prepared bf16 blocks",
                 "shape": cross16["shape"], "offsets": cross16["offsets"],
                 "other_blocks": [bf16_slice["cross"][key] for key in BF16_CROSS[1:]],
                 "sharded_16384_w2": bf16_slice["sharded"],
                 "pipeline_2504_ring_w2": bf16_files["sharded"]["pipeline_ring"]["launches"][
                     "zprep_gram_cross"],
                 "staged_2504_w2": bf16_files["sharded"]["stage"]})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
