#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero
before the last line is printed:

1. device: the card's name and power limit, the library versions;
2. build: compile the six CUDA sources from ``src/repro_torch/kernels/csrc``
   (``nvcc``, sm_90a, one process each, all started together) and time it;
3. kernels against their plain PyTorch versions on the card:
   ``gaia_select`` and ``rand_k_select`` bit-exact (output and count) at
   every GN-LeNet parameter shape stacked at K=5 and at a ragged
   n=1,000,003, in float32 and bfloat16 (rand-k with seeds past 2**31 and
   keep = 1 - float32(0.999)), one tensor a launch, and as the training
   path launches them, GN-LeNet's 16 tensors in one launch
   (``gaia_select_many``; ``rand_k_sparsify_many``, acc and vel with the
   conv weights counted in the reference's layout) and a ragged list of
   1, 37 and 1,000,003 elements, against the plain versions' loops;
   ``neighbor_mix`` allclose (float32 2e-5,
   bfloat16 2e-2) at (5, 96682) on a ring, on a random K=16 degree-4 graph,
   and in bfloat16; its src-gather variant likewise with a (15, 96682)
   snapshot buffer read at staleness 2 and a (48, 96682) one on the
   random graph, and an index past the buffer refused with no launch;
   as the training path launches them, every leaf of GN-LeNet, resnet-s
   and alexnet-s in one launch (``neighbor_mix_many``; and
   ``neighbor_mix_push_many``, AD-PSGD's snapshot push and stale gather,
   at staleness 0 and 2 over a 3-slot buffer, the pushed buffer exact;
   ``neighbor_mix_src_many``, phase 12's mix, every neighbour row from
   a (2K, N) source) at K=5 on a ring and on the random K=16 degree-4
   graph, float32 2e-5 and bfloat16 2e-2, and an index of -1 or past the
   buffer refused when
   the operands are built (``mix_operands``), with no launch;
   DGC's histogram route bit-exact (``dgc_sparsify``'s selection, count
   and threshold against the bisection, one launch a call; its parts
   ``abs_histogram_fused``, ``abs_histogram`` and ``dgc_select``, one
   launch each) at n in {1, 37, 4096, 483,410, 1,000,003, 2**20},
   float32 and bfloat16, sparsities {0.5, 0.9, 0.99, 0.999}, at 100
   bins, with ties at max|v|, all zeros and an external v_max below
   max|v| and of 1e-35; ``group_norm`` allclose (float32 1e-5, bfloat16
   2e-2) at (2, 8, 8, 16) and (4, 4, 4, 32) with group_size {2, 4}, at
   (128, 8, 8, 64), at GN-LeNet's and resnet-s-gn's first activations
   at K=5 x batch 20, (100, 16, 16, 32) and (100, 16, 16, 16), on the
   one-block-a-sample route, and at (2, 128, 128, 16) (1 MB a sample)
   on the (sample, group) route, and a channel count off the group size
   refused with no launch;
   ``flash_attention`` allclose (float32 2e-5, bfloat16 2e-2) on
   ``tests/test_kernels.py``'s grid (B, H, Tq, Tk, D) = (1, 2, 128, 128,
   64), (2, 1, 64, 192, 64), (1, 1, 200, 200, 128), at D = 256 (gemma2's
   head dim) and at the LM prefill's (4, 16, 2048, 2048, 128) in
   bfloat16, causal, non-causal, causal with a window of 64 and causal
   with softcap 30, and a head dim of 80 and an input with D off unit
   stride refused with no launch; the (Dk, Dv) pairs (96, 96), (192,
   128), (96, 64) and (48, 32) likewise (float32 on the CUDA-core body,
   bfloat16 on the tensor cores) at (B, H, Tq, Tk) in (1, 2, 128, 128),
   (2, 1, 64, 192), (1, 1, 200, 200), (1, 2, 100, 37), and on a v sliced
   from a fused kv projection as MLA's is; cross-attention (non-causal,
   q_offset 0, Tq > Tk and Tq < Tk) through ``chunked_attention``, one
   launch each; ``flash_attention_bthd`` likewise on
   (B, T, H, D) views of one projection-shaped tensor, at 1, 2 and 4
   query heads a KV head on the same grid (and 10, recurrentgemma's
   group) and at the prefill's 16 over 8 heads (bfloat16, max |err| 8e-3
   and mean 1e-6, printed for each mask); at phase 9's model shapes as
   the models launch them, in bfloat16 at those bounds and in float32 at
   2e-5: recurrentgemma's (4, 2048) tokens of 10 query heads over one KV
   head of 256, causal with its window of 2048, and the same at (1,
   4096), where the window cuts keys; seamless' encoder (4, 1500, 16
   heads of 64, non-causal, a ragged tail of keys), its decoder's causal
   (4, 2048) self-attention and its cross-attention (Tq 2048 and 1 over
   Tk 1500, non-causal); then every kernel of phase 6's bench on the
   bench's own operands (``kernels_bench.inputs``): ``gaia_select``,
   ``rand_k_select`` and ``dgc_sparsify`` at n = 2**20 bit-exact,
   ``neighbor_mix`` at (8, 2**17) on ``ring(8)`` within 2e-5,
   ``group_norm`` within 1e-5 and ``flash_attention`` at (1, 4, 256, 64)
   within 2e-5;
4. the main path: ``train_decentralized`` trains GN-LeNet at full width
   (96,682 parameters a node, K=5, batch 20) under every strategy: BSP,
   Gaia, D-PSGD (ring), AD-PSGD (ring, staleness 2), DGC top-k, DGC
   rand-k, FedAvg (iter_local 5) and D-PSGD steered by SkewScout over the
   topology ladder.  First five steps of each on the card and on the CPU
   (plain versions) must give the same losses (and SkewScout the same θ
   history); AD-PSGD at staleness 0 must give D-PSGD's results exactly on
   the card; then 30 steps of each on the card, with every launch count
   set to 0 just before each run and read just after: one ``gaia_select``
   launch a Gaia step, one ``rand_k_select`` launch a DGC rand-k step.
   D-PSGD and SkewScout make one ``neighbor_mix`` launch a step, AD-PSGD
   one ``neighbor_mix_src`` launch.  Then one more step of each of the
   eight, from its run's last state, under the step audit
   (``repro_torch.analysis.step_audit``: JA401 by PyTorch's sync debug
   mode, JA404, JA405): no finding, and exactly those launches
   (``STEP_LAUNCHES``); and the audit's positive control, a planted
   ``.item()`` of a card tensor: exactly one JA401, the caller's sync
   debug mode restored.
   Then one step of Gaia, DGC rand-k, D-PSGD and AD-PSGD on the earlier
   design (one ``gaia_select`` launch a tensor; two ``rand_k_select``
   launches a tensor and permuted copies into the reference's layout and
   back; the leaves flattened into one matrix, the raw ``neighbor_mix``
   with its host-side index check, the result split back, and for
   AD-PSGD the snapshot buffer rebuilt by ``torch.cat``), swapped in
   here, against the one-launch step: the same state bit for bit after a
   step from the same state (cuDNN deterministic), the host syncs of the
   step (PyTorch's sync debug mode), the wall time a step (median of 40
   in two rounds, in turns), and one step of each under
   ``torch.profiler``: its kernels, device busy time, idle share and top
   kernels (traced last, after phase 10, so that no profiling runs before
   a host-bound timing of the script); and one step of each strategy the
   paper benches run beside those (``BENCH_STEPS``): BSP, DGC top-k,
   FedAvg at an averaging step and Gaia under SkewScout at a travel step
   (five probes of 2 x 256 samples), each timed (median of 40) and traced
   likewise, DGC top-k's threshold (``quantile_rows``, by ``kthvalue``)
   marked to give its share of the step;
5. kernel times: the median of 50 CUDA-event-timed launches at the main
   path's shapes (a whole training step's tensors in one launch for
   ``gaia_select`` and ``rand_k_select``, beside the earlier design's one
   launch a tensor; GN-LeNet's 16 leaves in one launch for
   ``neighbor_mix_many`` and, with the snapshot push at staleness 2,
   ``neighbor_mix_push_many``, beside the earlier design's pieces: the
   raw op's index check with its host sync, its one launch on the flat
   matrix, the push by ``torch.cat``, and the design whole; an empty
   launch and a copy of the same bytes as floors; the bench's for the
   DGC histogram kernel, n = 2**20,
   its one-launch ``dgc_sparsify`` and each of its parts, with
   ``torch.histc`` as the histogram's yardstick, and for ``group_norm``,
   (128, 8, 8, 64), and GN-LeNet's (100, 16, 16, 32); the LM prefill's for
   ``flash_attention``, through the (B, H, T, D) launch and through the
   (B, T, H, D) launch the model makes, 16 over 8 heads, with
   ``chunked_attention`` around it, the (Dk, Dv) pairs at (1, 16, 2048,
   2048) bfloat16 causal, the three prefill shapes of phase 8's models
   as they launch the kernel ((4, 2048) tokens of 16 heads at (192, 128),
   40 at (96, 64) and 32 at (96, 96), MLA's v a view of its expansion)
   beside SDPA where one of its fused backends takes the pair, each
   also held against its plain version under the four masks at the
   prefill's tolerances, the five shapes of phase 9's models beside SDPA
   on the same operands, with ptxas' register and spill lines of
   ``flash_attention_tc<256>`` and ``<64>``, and the bench's (1, 4, 256,
   64) float32): the
   kernel launch alone (``ms``) and the whole op with its
   checks and allocations (``op_ms``), beside the plain version, the
   library call
   that computes the same function where there is one, and the least time
   the card could take (bytes over 3.35 TB/s, operations over 67 TFLOP/s,
   the float32 rate of the CUDA cores, which integer work is counted at
   too, or over 989 TFLOP/s, the bfloat16 rate of the tensor cores, for
   bfloat16 products);
6. the kernel bench (``repro_torch.benchmarks.kernels_bench``, every row
   of the reference's ``benchmarks/kernels_bench.py`` but the
   interpret-mode ones) through its entry point on the card, with every
   launch count set to 0 just before and read just after: the DGC
   histogram kernel (one ``dgc_sparsify`` launch a call) and
   ``group_norm`` run on no training path, so this is their main path;
   then a kernel and an oracle row of each public op the reference has
   no twin of (``gaia_select_many``, ``rand_k_sparsify_many``, DGC's
   parts, one launch a call each, the three gossip list ops,
   ``flash_attention_bthd``), and the report twin's gate
   (``repro_torch.benchmarks.report --gate``) over the rows written: a
   verdict line a ``kernel/`` row with an ``oracle/`` twin, every such
   row covered, the verdicts reported, not asserted (each row a call's
   device time: ``kernels_bench.time_us`` queues a spin kernel first);
7. LM serving: ``qwen3-0.6b`` at full width (28 layers, d_model 1024, 16
   heads over 8 KV heads of 128, vocab 151,936), bfloat16, random weights
   from a seeded generator on the card.  (a) ``make_prefill_step`` on 4
   prompts of 2048 tokens, the launch counts set to 0 just before the
   timed calls and read just after: 28 ``flash_attention`` launches a
   call; (b) the ``serve_decode`` example's loop answers 4 requests of a
   16-token prompt with 16 generated tokens over a 128-slot cache; (c)
   ``forward``'s logits at every position of 256 tokens against
   ``decode_step``'s after the same tokens (the kernel's causal prefill
   against the kernel-free decode path); (d) every arch of the registry,
   reduced, float32 (the VLM with patches), on the card against the CPU,
   logits and MoE aux (TF32 off, rtol and atol 1e-3; seamless with its
   reduced frames);
8. LM serving of the MLA, MoE and VLM families at full width, bfloat16,
   random weights from a seeded generator on the card, each model's
   parameter counts, draw time and peak memory printed, and its prefill
   (``make_prefill_step``, 4 x 2048 positions, one ``flash_attention``
   launch a layer and no other kernel, counted over the timed calls) and
   decode (the ``serve_decode`` loop of phase 7, no kernel launch, host
   syncs a step) timed: (a) ``deepseek-v2-lite-16b`` (MLA over 26 MoE
   layers, 27 launches a call), prefill against decode at 1 x 8 tokens
   (no capacity drop) in bfloat16 at full depth and in float32 on a
   4-layer cut (1 dense, 3 MoE, every width as published; within 5e-3,
   every greedy token equal); beside the bfloat16 gap, the (token,
   expert) pairs each path routes differently at each MoE layer and the
   same prefill with the plain attention in the kernel's place; and,
   after every timing, one prefill call
   under ``torch.profiler`` (flash_attention, GEMMs, MoE dispatch, other)
   and one decode step's launches; (b) ``minicpm3-4b`` (dense MLA, 62
   launches a call), prefill against decode at 2 x 256 in float32 (5e-3,
   99% greedy equal) and bfloat16 (reported); (c)
   ``phi-3-vision-4.2b`` (576 patches prepended to 1,472 text tokens, 32
   launches a call), its logits over the text positions only;
9. LM serving of the SSM, RG-LRU and enc-dec families at full width,
   bfloat16, one model on the card at a time, as phase 8 serves its
   own: ``mamba2-780m`` (48 SSD layers, no attention: 0 launches a
   prefill call), ``recurrentgemma-2b`` (18 RG-LRU and 8 attention
   layers of 10 heads over one KV head of 256, window 2048: 8 launches)
   and ``seamless-m4t-large-v2`` (24 encoder layers over (4, 1500, 1024)
   random frames, 24 decoder layers each with self- and
   cross-attention: 72 launches); decode through the ``serve_decode``
   loop (seamless' encoder run once, then 24 cross-attention launches a
   step); prefill against decode at 1 x 8 tokens in bfloat16 (reported)
   and in float32 on a depth cut (4 SSD layers; recurrentgemma's first
   cycle (rglru, rglru, attn); 2 encoder and 2 decoder layers: within
   5e-3, every greedy token equal); the SSD and RG-LRU scans timed alone
   at the models' shapes; and, after every timing of phases 7-9,
   deepseek-v2-lite-16b's traces (phase 8) and one prefill call of each
   phase 9 model under ``torch.profiler`` (GEMMs, flash_attention, the
   SSD / RG-LRU scan, the elementwise glue);
10. the paper benches' path through the port's entry points, every
   training run's launch counts set to 0 just before it and read just
   after: (a) ``python -m repro_torch.benchmarks.run --only fig4 --json
   build/bench_torch``'s ``main``, its CSV row and ``BENCH_fig4.json``
   (this card's name and power limit), the non-IID mean μ_B divergence
   above the IID one; (b) ``fig_topology.smoke_async()`` and
   ``smoke_links()`` with their own assertions (AD-PSGD's simulated
   wall-clock below D-PSGD's, the straggler chain fired), one
   ``neighbor_mix`` launch a D-PSGD step and one ``neighbor_mix_src``
   launch an AD-PSGD step and no other launch (evaluation launches
   none); (c) ``smoke_scale()``, host only, 50 priced rounds on a
   10k-node fabric within 10 s; (d) ``examples.quickstart`` (Gaia, IID
   against non-IID, 300 steps each), one ``gaia_select`` launch a step,
   both accuracies and the savings printed;
11. LM training (after every profile of the phases above, which the
   full-width states need the memory of): (a) the attention's autograd
   route (``ops.FlashAttention``: the kernel forward, the plain chunked
   backward) against autograd through ``ref.flash_attention_bthd_ref``,
   dq, dk and dv within 2e-2 (bfloat16) and 1e-4 (float32, TF32 off) of
   the largest plain gradient, at qwen3's (2, 1024, 16 over 8 heads of
   128) bfloat16 causal and at a float32 (2, 512, 8 over 2 of 64) with a
   window of 256 and softcap 30; the forward kernel, the backward and
   SDPA's forward plus backward timed on the same views; ``gaia_select``'s
   float32-v, bfloat16-w instance bit-exact and timed at qwen3's stacked
   bfloat16 leaves; (b) ``qwen3-0.6b`` at full width, bfloat16, random
   weights, 2 pods of 2 x 1024 tokens, remat, through
   ``launch.steps.make_train_step`` under bsp, gaia, fedavg, dgc, dpsgd
   and adpsgd: one warm-up and one timed step each, every launch count
   set to 0 just before the timed steps and read just after (112
   ``flash_attention`` launches a step, the forward run again under
   remat; 2 ``gaia_select``, 26 ``dgc_sparsify``, 2 ``neighbor_mix``, 2
   ``neighbor_mix_src`` launches a step of their strategy: one a dtype
   group, one a (pod, leaf)), finite losses, wall ms a step, peak memory
   and a fifth step's host syncs; (c) one bsp step through the kernel
   route against the plain route (``ops.flash_attention_bthd`` swapped
   for the plain version here): on a float32 4-layer cut at full width
   (TF32 off) every leaf within 1e-3 of its largest update plus 2 ulps
   of its largest weight, and at full width in bfloat16 reported; (d)
   ``examples.train_lm_decentralized`` for gaia and dpsgd, 200 steps
   each, its loss < 5.5; (e) (d)'s gaia state and (b)'s full-width pod
   params saved in the reference's checkpoint format and restored bit
   for bit;
12. the pod axis across processes (``launch.procs.spawn``; the parent
   built the kernels, the ranks only load them): (a) two gloo ranks on
   the card, one phase 11 pod each (qwen3-0.6b at full width cut to its
   first 4 layers, bfloat16, 2 x 1024 tokens, remat),
   ``launch.mesh.make_mesh`` over them, under
   the six strategies: one warm-up and one timed step each, every launch
   count set to 0 just before the timed steps and read just after in
   each rank (8 ``flash_attention``, 2 ``gaia_select``, 13
   ``dgc_sparsify``, 2 ``neighbor_mix_src`` launches a step a rank for
   dpsgd and adpsgd: ``ops.neighbor_mix_src_many`` over the gathered or
   received rows), ms a step, tokens/s, each rank's peak memory and the
   last timed step's host syncs (the calling thread's; gloo stages CUDA
   tensors through the host on its own threads); (b) that step's
   exchange: its inputs all-gathered, each rank runs the one-card
   exchange on the stacked inputs and holds its own rows of the result
   against the two-rank exchange's, bit for bit for all six (row 2's
   body also timed alone at the dpsgd shape, beside its bound, the plain
   version and a dense W @ src, and held against the plain version bit
   for bit); (c) a float32 2-layer cut at full
   width (TF32 off), one step of each strategy, each rank's rows against
   the one-card step it runs itself from the same seeded state and
   batch: the velocity within 1e-3 relative L2, its worst leaf reported;
   (d) NCCL at world size 1 through the same step (bsp and dpsgd, both
   pods on the rank, a bf16 2-layer cut): ms a step, launches, 0 host
   syncs a step; then dpsgd's and adpsgd's exchange on full-width inputs
   through both routes on the one card (the one-card route's fused
   kernels, the mesh route at world size 1), timed, bit for bit with
   each other.  A rank's failure fails the phase;
13. the intra-pod axes (``launch.procs.spawn``, eight gloo ranks on the
   card, one CUDA context each, ``launch.mesh.make_mesh`` over (pod,
   data, model) = (2, 2, 2): each pod over 2 data ranks (FSDP) and 2
   model ranks (tensor parallelism)): (a) a float32 2-layer cut of
   qwen3-0.6b at full width (TF32 off), one step of each strategy on
   phase 12's global batch against the one-card step, which rank 0 runs
   once and each rank cuts its blocks of through CUDA IPC: the gathered
   params and velocities within 1e-5 relative L2
   (for gaia and dgc, whose selections may flip an entry at the
   threshold, the exchange's inputs), the mesh exchange on the one-card
   step's own inputs bit for bit (DGC's sharded leaves through
   ``abs_histogram`` summed over the ranks and ``dgc_select``), 0 host
   syncs, the launches a rank (4 ``flash_attention``, 8 ``abs_histogram``
   and 8 ``dgc_select`` beside 5 ``dgc_sparsify`` for dgc); (b) the
   first 2 layers at full width, bf16, remat, bsp and dpsgd, 2 x 1024
   tokens a pod, one warm-up and 2 timed steps: the slower rank's ms a
   step, tokens/s, peak memory a rank, host syncs, launches a step a rank
   (8 ``flash_attention`` at (1, 1024, 8 over 4, 128)); (c) (b)'s bsp
   params saved on the mesh, each rank's blocks restored on the mesh,
   and the checkpoint restored on one device, each rank's blocks of it
   equal to that rank's state (SHA-256 of the bytes).  (Phases 12 (a)
   and 13 (b) ran the full 28 layers until phase 14 needed the time, 7
   until phase 15 did; 13 (a) ran 4 layers until then.)
14. serving under a mesh (``launch.steps.make_prefill_step`` and
   ``make_serve_step`` with ``mesh=``; four gloo ranks on the card, one
   site of a (1, D, M) mesh: each rank holds its blocks of the weights
   (FSDP over data, tensor and expert parallelism over model), of the
   decode cache and its rows of the requests): ``flash_attention`` at
   each rank's prefill shape against its plain version (bf16 causal,
   max |err| 8e-3, mean 1e-6): qwen3-0.6b's (2, 2048, 8 over 4, 128) and
   deepseek-v2-lite-16b's (4, 2048, 4 over 4, (192, 128)); the one-card
   serves the ranks are held against (run first, each model freed before
   the next); (a) float32 (TF32 off): qwen3-0.6b at full depth over
   (1, 2, 2), the 4 x 2048 prefill and 8 requests' teacher-forced decode
   (a 64-token prompt, then the one-card greedy tokens; 128 slots) for
   its first 4 steps, under both cache placements (the length over
   model: flash-decode; and the KV heads over model, the reference's
   ``REPRO_BASELINE_DECODE``); a 4-layer cut of deepseek-v2-lite-16b at
   full width over (1, 1, 4) (1 dense and 3 MoE layers), the same
   prefill and its first 32 decode steps under the length placement and
   16 under the heads placement, the EP
   route's prefill (reported) and 8 of its decode steps (the dense
   route's function at one token, by the reference's rule), and the EP
   route's first MoE layer against ``moe_apply_ep_ref`` on the one-card
   run's own input: every logit row, and that layer's output, within
   1e-5 relative L2; (b) bf16 at full width, the weights drawn by the
   ranks in turns (each keeps clones of its blocks): qwen3-0.6b's first 4
   layers over (1, 2, 2), deepseek-v2-lite-16b's first 3 layers (1 dense,
   2 MoE) over (1, 1, 4) with the dense
   and the EP route: one warm-up and 2 timed prefill calls and decode
   steps, the slowest rank's median, tokens/s, peak memory a rank, 0 host
   syncs a decode step, the launches (4 and 3 ``flash_attention`` a
   prefill call a rank, none a decode step), one decode step's
   collectives (calls, bytes handed, ms inside them); qwen3's logits no
   farther from the float32 one-card logits than 1.25x the one-card bf16
   logits are (gated), deepseek's relative L2 to the one-card bf16
   logits and greedy agreement (reported); (c) NCCL at world size 1: the
   serve steps on a (1, 1, 1) mesh equal the steps without one, 0 host
   syncs a decode step.  (Until phase 15 needed the script's time, (a)
   decoded qwen3 for 8 steps and the deepseek cut for all 95 (32 under
   the heads placement), and (b) served deepseek at its full 27 layers;
   until phase 16 (d) and (e) did, (b) served qwen3 at its 28 layers
   and deepseek's first 14, with 3 timed calls and steps.)
15. training MLA + MoE inside a pod, and a model axis wider than
   n_kv_heads (``launch.procs.spawn``, four gloo ranks on the card, one
   spawn, a deadline): (a) deepseek-v2-lite-16b at full width, float32
   (TF32 off), a 2-layer cut (layer 0 dense, layer 1 MoE: 64 experts, 16
   a rank) over (1, 1, 4), a pod batch of 2 x 256 tokens, one bsp step
   with each MoE route: the dense route's gathered params and velocities
   within 1e-5 relative L2 of the one-card step each rank runs in turn,
   its loss within 1e-6 relative, every (token, k) pair's expert equal to
   the one-card router's unless that token's top-k margin is below 1e-5
   relative (the flips and margins printed), the remat recompute routing
   as the forward; the EP route's step distance to the one-card step and
   its dropped pairs reported, and its MoE layer on seeded tokens (y,
   the gradients of x, the router, the experts and the shared experts)
   within 1e-5 relative L2 of ``moe_apply_ep_ref``'s autograd; (b) that
   cut in bf16 over (2, 1, 2), each strategy's exchange on seeded inputs,
   each rank's blocks against the one-card exchange's, bit for bit (rank
   0 runs the one-card exchange and checks every rank's blocks by their
   bits' fingerprints); (c) a 3-layer cut (1 dense, 2 MoE) in bf16,
   remat, 2 x 1024 tokens, bsp, both routes, one warm-up and one timed
   step: the slowest rank's ms a step, tokens/s, peak memory a rank,
   the first timed step's collectives by kind, the warm-up step's plain
   attention backward, 0 host syncs a step, 5 ``flash_attention``
   launches a step a rank (3 forward, 2 recomputed: the dense first
   layer is not checkpointed, as in the reference); (d) starcoder2-3b at
   full width
   (24 heads over 2 KV heads: each KV head serves two model ranks),
   float32, a 2-layer cut over (1, 1, 4): one bsp step against the
   one-card step (1e-5 relative L2), a 4 x 512 prefill and 8
   teacher-forced decode steps of 8 requests under the flash-decode and
   the heads placements against the one-card serve by phase 14's float32
   gate; (e) starcoder2-3b bf16, remat, a 4-layer cut, 1 x 1024 tokens,
   bsp, one warm-up and one timed step, as (c) (8 launches a step a
   rank).
16. training and serving the SSM, RG-LRU hybrid, enc-dec and VLM
   families inside a pod (``launch.procs.spawn``, four gloo ranks on the
   card over (1, 2, 2), one spawn, a deadline): mamba2-780m,
   recurrentgemma-2b, seamless-m4t-large-v2 (1500 frames a request)
   and phi-3-vision-4.2b (576 patches a sequence) at full width on depth
   cuts (2 layers; recurrentgemma one (rglru, rglru, attn) cycle;
   seamless 2 encoder and 2 decoder layers): (a) float32 (TF32 off), one
   bsp step on 2 x 256 tokens against the one-card step each rank runs
   in turn, two at once (1e-5 relative L2, the loss within 1e-6
   relative), a 2 x 512
   prefill and 4 teacher-forced decode steps of 8 requests over 128
   slots (the enc-dec's memory encoded once on the rank's requests)
   against the parent's one-card serve by phase 14's gate (C12), and the
   cache gathered whole (the SSD state's head_dim blocks, the conv
   histories and RG-LRU states whole on every model rank) within the
   decode gate of the one-card cache; (b) bf16, remat, 2 x 1024 tokens
   (and the frames or patches), bsp, one warm-up and one timed step: the
   slowest rank's ms a step, tokens/s, peak memory a rank, the first
   timed step's collectives by kind, 0 host syncs a step, the
   ``flash_attention`` launches of the layer plan (0, 2, 10 and 4 a
   step a rank: every attention of the forward, the body cycles'
   again); (c) mamba2 and recurrentgemma served in bf16: a 4 x 2048
   prefill (one warm-up call, one timed) and 3 decode steps of 4
   requests over 128 slots, 0 host syncs a decode step.  The ranks
   record every shape, dtype and mask (a), (b) and (c) call
   ``flash_attention`` at (recurrentgemma's 5 query heads over one KV
   head of 256 with its window, seamless' encoder, decoder and
   cross-attention on 8 heads of 64, phi-3-vision's 16 heads of 96 over
   a sequence of text and patches, seamless' cross-attention at a decode
   step); the parent then holds the kernel at each against its plain
   version: bf16 within max |err| 8e-3 and mean 1e-6, float32 within
   2e-5 + 2e-5 |plain| an output.  What an axis does not divide (ROADMAP
   A11d), in the same spawn: (d) (a) re-meshed over (1, 1, 4) for
   recurrentgemma-2b (10 query heads over 4 ranks: every head on each)
   and seamless-m4t-large-v2 (its vocabulary of 256,206 whole on each
   model rank); (e) one long_500k request whole on every rank of (1, 2,
   2) for 2-layer float32 cuts of qwen3-0.6b and mamba2-780m at full
   width, each decode cache seeded as it stands after 4,160 tokens (the
   4,096-slot ring wrapped; the SSD state's heads over data) and placed
   with its length over data: 4 decode steps against the one-card
   decode on the same cache by phase 14's gate, 0 host syncs a step;
17. the dry-run stand-in against the card (phase 12's bsp and dpsgd steps
   traced on meta; its audit sweep on the host beside phase 12's ranks),
   every one of those traces also under the step audit, no finding.

Every phase ends with its own line, ``phase N: X.XX s (script Y.YY s)``
(phases 4, 8 and 9 run in two parts and print one a part).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  The kernel checks and the
card-against-CPU losses run with TF32 off, so the card and the CPU compute
the same function; the timed 30-step runs use PyTorch's default flags, as a
user's run does.  Exits non-zero without a result where there is no CUDA
device or no ``src/repro_torch`` beside this file.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

#: the script's start, before torch is imported
_T_SCRIPT = time.perf_counter()
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM, NVIDIA data sheet: HBM3 bytes/s, bfloat16 tensor-core FLOP/s
from repro_torch.launch.analysis import (  # noqa: E402
    BF16_FLOPS_PER_S, HBM_BYTES_PER_S)

FP32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
STEPS = 30
CPU_CHECK_STEPS = 5
K = 5
#: 1 - 0.999 in float32: DGC's keep probability at its last sparsity rung
KEEP_999 = float(np.float32(1) - np.float32(0.999))
#: DGC histogram checks: ragged sizes, GN-LeNet's K=5 stack (483,410),
#: the bench's 2**20
DGC_SIZES = (1, 37, 4096, 483_410, 1_000_003, 1 << 20)
DGC_SPARSITIES = (0.5, 0.9, 0.99, 0.999)
#: GroupNorm checks: tests/test_kernels.py's shapes, the bench's,
#: GN-LeNet's and resnet-s-gn's first activations at K=5 x batch 20, and a
#: 1 MB sample, which takes the (sample, group) route
GN_CASES = (((2, 8, 8, 16), 2), ((2, 8, 8, 16), 4), ((4, 4, 4, 32), 2),
            ((4, 4, 4, 32), 4), ((128, 8, 8, 64), 2), ((100, 16, 16, 32), 2),
            ((100, 16, 16, 16), 2), ((2, 128, 128, 16), 2))
#: flash_attention checks: tests/test_kernels.py's grid (B, H, Tq, Tk, D),
#: then D = 256 with Tq = Tk and with Tq < Tk
FA_SHAPES = ((1, 2, 128, 128, 64), (2, 1, 64, 192, 64), (1, 1, 200, 200, 128),
             (1, 2, 160, 160, 256), (1, 1, 64, 300, 256))
FA_KWS = ({"causal": True}, {"causal": False}, {"causal": True, "window": 64},
          {"causal": True, "logit_softcap": 30.0})
#: query heads over KV heads in the (B, T, H, D) checks: recurrentgemma's
#: 10 besides
FA_GROUPS = (1, 2, 4, 10)
#: the (Dk, Dv) pairs besides the dense LMs' equal ones: phi-3-vision's,
#: deepseek-v2's, minicpm3's, the reduced MLA configs'
FA_PAIRS = ((96, 96), (192, 128), (96, 64), (48, 32))
#: their checks' (B, H, Tq, Tk): the grid above and a ragged Tq over Tk
FA_PAIR_SHAPES = ((1, 2, 128, 128), (2, 1, 64, 192), (1, 1, 200, 200),
                  (1, 2, 100, 37))
#: their timing shape (B, H, T): a prefill of 2048 tokens, 16 heads
FA_PAIR_TIMED = (1, 16, 2048)
#: zoo models whose leaf sets phase 3 mixes in one launch
GOSSIP_CFGS = ("gn-lenet", "resnet-s", "alexnet-s")
#: wall-clock steps a side in phase 4's comparison of the two designs
PROFILE_STEPS = 20
#: the LM prefill: qwen3-0.6b's attention over 4 prompts of 2048 tokens
PREFILL_B, PREFILL_T, PREFILL_CALLS = 4, 2048, 3
FA_PREFILL = (PREFILL_B, 16, PREFILL_T, PREFILL_T, 128)
#: the same as the model runs it: 16 query heads over 8 KV heads, as
#: (B, H_kv, Tq, Tk, D) with a group of 2
FA_PREFILL_GQA, FA_PREFILL_GROUP = (PREFILL_B, 8, PREFILL_T, PREFILL_T,
                                    128), 2
#: the kernel's bound at the prefill's shape in bfloat16, tighter than the
#: grid's 2e-2 (about half an output there): an H100 read max |err| 3.91e-3
#: (one bfloat16 ulp in [0.5, 1)), so 8e-3 is twice it; and a bound on the
#: mean |err| over the 33.5 M outputs, which read 2.9e-8 to 3.0e-8 for the
#: four masks (most outputs round to the same bfloat16)
FA_PREFILL_TOL, FA_PREFILL_MEAN_TOL = 8e-3, 1e-6
#: phase 8's models, whose prefill shapes phase 5 times the kernel at
FA_MODEL_ARCHS = ("deepseek-v2-lite-16b", "minicpm3-4b", "phi-3-vision-4.2b")
#: phase 9's models as they launch the kernel: (label, (B, Hkv, Tq, Tk,
#: D), query heads a KV head, mask)
FA_NEW_SHAPES = (
    ("recurrentgemma-2b", (PREFILL_B, 1, PREFILL_T, PREFILL_T, 256), 10,
     {"causal": True, "window": 2048}),
    ("recurrentgemma-2b at 4096 tokens", (1, 1, 4096, 4096, 256), 10,
     {"causal": True, "window": 2048}),
    ("seamless encoder", (PREFILL_B, 16, 1500, 1500, 64), 1,
     {"causal": False}),
    ("seamless decoder self-attention", (PREFILL_B, 16, PREFILL_T,
                                         PREFILL_T, 64), 1, {"causal": True}),
    ("seamless cross-attention, prefill", (PREFILL_B, 16, PREFILL_T, 1500,
                                           64), 1, {"causal": False}),
    ("seamless cross-attention, decode", (PREFILL_B, 16, 1, 1500, 64), 1,
     {"causal": False}))
#: phase 9's models and their flash_attention launches a prefill call
#: (mamba2 has no attention; recurrentgemma one a third layer; seamless
#: its encoder's 24, its decoder's 24 and 24 cross-attentions)
NEW_ARCHS = {"mamba2-780m": 0, "recurrentgemma-2b": 8,
             "seamless-m4t-large-v2": 72}
#: their float32 cuts: decoder layers (recurrentgemma: one whole (rglru,
#: rglru, attn) cycle), and seamless' encoder layers
NEW_CUT_LAYERS = {"mamba2-780m": 4, "recurrentgemma-2b": 3,
                  "seamless-m4t-large-v2": 2}
#: serving (phases 7-9's timed decode loops): 4 requests, 16-token prompts,
#: 16 generated, 128 cache slots (64 and 32, 95 steps a loop, until the
#: smoke needed the time on slow hosts; every gate reads the loop as before)
SERVE_B, SERVE_PROMPT, SERVE_GEN, SERVE_CACHE = 4, 16, 16, 128
#: prefill/decode agreement: 2 sequences of 256 tokens
AGREE_B, AGREE_T = 2, 256
#: its tolerances: in float32 (the same weights, TF32 off) max |logit
#: difference| and the least share of equal greedy tokens; in bfloat16 the
#: largest max and mean |difference| (logits' std 2: random weights make 28
#: bfloat16 layers amplify rounding, and both bfloat16 paths lie as far from
#: float32 as from each other)
AGREE_TOL_F32, AGREE_SAME_F32 = 5e-3, 0.99
AGREE_TOL_BF16, AGREE_MEAN_BF16 = 4.0, 0.5
#: the MoE model's prefill/decode agreement: 1 x 8 tokens, where the
#: capacity (8 slots an expert) drops no (token, expert) pair on either
#: path, and the float32 cut: the dense first layer and 3 MoE layers
MOE_AGREE_T, MOE_CUT_LAYERS = 8, 4
#: kernel names (lower case) of a prefill trace: cuBLAS' and CUTLASS'
#: GEMMs, and the MoE dispatch (router top-k, rank cumsum, the slot
#: scatter and the gathers)
GEMM_KEYS = ("gemm", "nvjet", "sm90", "cutlass")
DISPATCH_KEYS = ("topk", "sort", "scan", "cumsum", "index", "scatter",
                 "gather")
#: the rows of the kernel bench: the reference's rows without interpret
#: mode, the library calls, then a kernel and an oracle row of each public
#: op the reference has no twin of (the registry parity's PA303)
BENCH_ROWS = (
    "kernel/flash_attention", "oracle/flash_attention",
    "library/flash_attention", "prod/chunked_attention",
    "kernel/gaia_select_1M", "oracle/gaia_select_1M",
    "kernel/dgc_sparsify_1M", "oracle/dgc_sparsify_1M",
    "oracle/dgc_quantile_1M", "library/dgc_quantile_1M",
    "kernel/rand_k_1M", "oracle/rand_k_1M",
    "kernel/neighbor_mix_ring8_128k", "oracle/neighbor_mix_ring8_128k",
    "oracle/neighbor_mix_dense", "library/neighbor_mix_dense",
    "kernel/group_norm", "oracle/group_norm", "library/group_norm") + tuple(
    f"{kind_}/{op_}" for op_ in (
        "gaia_select_many_1M", "rand_k_sparsify_many_1M",
        "abs_histogram_1M", "abs_histogram_fused_1M", "dgc_select_1M",
        "neighbor_mix_many_ring8_128k", "neighbor_mix_push_many_ring8_128k",
        "neighbor_mix_src_many_ring8_128k", "flash_attention_bthd")
    for kind_ in ("kernel", "oracle"))
#: the calls a bench row makes: 3 warm-up and 50 timed
#: (``kernels_bench.time_us``)
BENCH_CALLS = 53
#: the main path's runs: (label, strategy, CommConfig fields besides the
#: ring fabric); the SkewScout run's travel interval is set per phase
RUNS = (("bsp", "bsp", {}), ("gaia", "gaia", {}), ("dpsgd", "dpsgd", {}),
        ("adpsgd", "adpsgd", {"max_staleness": 2}),
        ("dgc", "dgc", {}),
        ("dgc-randk", "dgc", {"dgc_compressor": "randk"}),
        ("fedavg", "fedavg", {"iter_local": 5}),
        ("dpsgd-skewscout", "dpsgd", {"skewscout": True}))


#: the kernel launches of one step of each of RUNS (the others launch
#: none), as phase 4 holds its runs to them
STEP_LAUNCHES = {"gaia": {"gaia_select": 1},
                 "dgc-randk": {"rand_k_select": 1},
                 "dpsgd": {"neighbor_mix": 1},
                 "dpsgd-skewscout": {"neighbor_mix": 1},
                 "adpsgd": {"neighbor_mix_src": 1}}


#: the strategies the paper benches run that phase 4's comparison of two
#: designs leaves out, a step of each timed and traced: (label, strategy,
#: CommConfig fields, step keywords, steps apart of the steps taken:
#: FedAvg's averaging steps, every 5th; Gaia under SkewScout travels at
#: every step it takes)
BENCH_STEPS = (("bsp", "bsp", {}, {}, 1),
               ("dgc-topk", "dgc", {}, {"sparsity": 0.999}, 1),
               ("fedavg", "fedavg", {"iter_local": 5}, {"iter_local": 5}, 5),
               ("gaia-skewscout", "gaia",
                {"skewscout": True, "travel_every": 1}, {}, 1))


#: phase 11, LM training: qwen3-0.6b at full width, bfloat16, 2 pods of 2
#: x 1024 tokens, remat, lr 1e-2; one warm-up step, TRAIN_STEPS timed
#: steps (3 until phase 16 (d) and (e) needed the script's time) and one
#: step under PyTorch's sync debug mode a strategy
TRAIN_PODS, TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_LR = 2, 2, 1024, 1, 1e-2
#: its strategies and their CommConfig fields (a ring fabric), and the
#: AD-PSGD read's staleness slot
TRAIN_RUNS = (("bsp", {}), ("gaia", {"gaia_t0": 0.05}),
              ("fedavg", {"iter_local": 2}),
              ("dgc", {"dgc_sparsity": 0.999}), ("dpsgd", {}),
              ("adpsgd", {"max_staleness": 2}))
TRAIN_STALENESS = 1
#: (a) the attention's autograd route against autograd through the plain
#: version, max |difference| of dq, dk, dv over max |plain's|: bfloat16
#: 2e-2 (each side rounds its float32 gradient to bfloat16, and the plain
#: version's expanded KV heads sum their bfloat16 gradients in bfloat16:
#: a few ulps of the largest), float32 1e-4 (TF32 off; the sums over 512
#: keys in another order)
TRAIN_ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
#: (b) the exchange kernels on one step's own inputs against their plain
#: versions: Gaia's and DGC's selections, counts and DGC's threshold, and
#: AD-PSGD's pushed snapshot buffer bit for bit; the mixed leaves within
#: these (atol and rtol: the kernel and the plain matmul both sum in
#: float32 and round once, so they differ by a last bit at most)
TRAIN_MIX_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
#: (c) the step's params through the kernel route against the plain
#: route, on a float32 cut of qwen3 (TF32 off), per leaf: within 1e-3 of
#: the largest update plus 2 float32 ulps of the largest weight (an update
#: that differs by a last bit rounds the weight to its neighbour)
TRAIN_ROUTE_TOL, TRAIN_ROUTE_CUT = 1e-3, 4
#: (c) at full depth: in float32 (TF32 off) the two routes' velocities
#: (-lr x the gradient) within 1e-3 relative L2; in bfloat16 the kernel
#: route's velocity no further from the float32 plain route's than 1.25x
#: the bfloat16 plain route's is (both round every GEMM to bfloat16, and
#: 28 layers of random weights amplify a last-bit difference)
TRAIN_ROUTE_GRAD_TOL, TRAIN_BF16_FROM_F32 = 1e-3, 1.25


#: the phase that runs: its number and start
_PHASE: dict = {"n": None, "t": None}


def phase(n: int, title: str) -> None:
    """Ends the phase that runs (``end_phase``) and starts phase ``n``."""
    end_phase()
    _PHASE.update(n=n, t=time.perf_counter())
    print(f"[phase {n}] {title}", flush=True)


def end_phase() -> None:
    """Prints the running phase's own time and the script's so far, as
    ``phase N: X.XX s (script Y.YY s)``: a phase that runs in parts (8, 9
    and 4 continue after phase 10) prints one line a part."""
    if _PHASE["n"] is None:
        return
    now = time.perf_counter()
    print(f"phase {_PHASE['n']}: {now - _PHASE['t']:.2f} s (script "
          f"{now - _T_SCRIPT:.2f} s)", flush=True)
    _PHASE["n"] = None


def time_ms(fn, reps: int = 50) -> float:
    """Median device time of one ``fn()`` over ``reps`` launches, each
    between two CUDA events.  A spin kernel queued first holds the
    device while the host enqueues, so the events bracket device work
    and not the host's launch latency."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


@contextlib.contextmanager
def tf32_off():
    """Full float32 matmuls and convolutions, then the flags as they were."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def thetas(history):
    """SkewScout's (step, θ, new θ) sequence, schedules by name."""
    name = lambda th: getattr(th, "name", th)
    return [(h.step, name(h.theta), name(h.new_theta)) for h in history]


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms (its default backward convolutions
    may sum in a different order on every call), then the flag as it was."""
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = flag


def bound_ms(n_bytes: float, flops: float,
             flops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attention_work(shape, dtype_bytes: int, causal: bool = True,
                   dv: int = None, hkv: int = None):
    """(bytes, flops) attention must move and do: q, k (head dim D), v
    and o (head dim ``dv``, D by default) read and written once, k and v
    over ``hkv`` KV heads (H by default); 2 (D + dv) flops (two
    multiply-adds) a valid (query, key) pair, causal over Tq = Tk
    counting T (T + 1) / 2 pairs a head."""
    B, H, Tq, Tk, D = shape
    dv = D if dv is None else dv
    hkv = H if hkv is None else hkv
    pairs = Tq * (Tq + 1) // 2 if causal else Tq * Tk
    return ((B * H * Tq + B * hkv * Tk) * (D + dv) * dtype_bytes,
            2 * B * H * (D + dv) * pairs)


@contextlib.contextmanager
def swapped(module, name: str, fn):
    """``module.name`` replaced by ``fn``, then restored."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def demangle(name: str) -> str:
    """A kernel's C++ name by ``c++filt``, cut to the function and its
    template arguments; the mangled name where there is no ``c++filt``."""
    try:
        name = subprocess.run(["c++filt"], input=name, capture_output=True,
                              text=True, timeout=30).stdout.strip() or name
    except OSError:
        return name
    m = re.search(r"([A-Za-z_]\w*(?:<[^()]*?>)?)\(", name)
    return m.group(1) if m else name


def ptxas_lines(kname: str, log: str):
    """ptxas' register and spill lines of a kernel's build log, each with
    its entry function's name."""
    entry, lines = "", []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = demangle(line.split("'")[1])
        elif "registers" in line or "spill" in line:
            lines.append(f"  {kname} {entry}: {line.strip()}")
    return lines


def fused_qkv(gen, dev, shape, group, dtype):
    """q (B, Tq, H * group, D) and k, v (B, Tk, H, D), for (B, H, Tq, Tk,
    D), as the views of one projection-shaped (B, T, (H * group + 2 H) D)
    tensor that the model's attention takes: none contiguous."""
    B, H, Tq, Tk, D = shape
    Hq = H * group
    fused = torch.randn(B, max(Tq, Tk), (Hq + 2 * H) * D,
                        generator=gen).to(dev, dtype)
    return (fused[:, :Tq, :Hq * D].unflatten(2, (Hq, D)),
            fused[:, :Tk, Hq * D:(Hq + H) * D].unflatten(2, (H, D)),
            fused[:, :Tk, (Hq + H) * D:].unflatten(2, (H, D)))


def tree_to(tree, to):
    """A parameter tree (dicts, lists, tensors, None) with every tensor
    moved or cast by ``tensor.to(to)``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, to) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, to) for v in tree]
    return None if tree is None else tree.to(to)


def device_profile(fn, marks=()):
    """Run ``fn()`` once under ``torch.profiler`` and sum the card's kernel
    time: (busy ms, kernel launches, {kernel name: ms}).  With ``marks``,
    the names of ``record_function`` ranges (``marked``) inside ``fn``,
    also {kernel name: ms} of the kernels launched inside them, and the
    ranges' own device-side spans are left out of the sums."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_kernel, launches = {}, 0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA") or e.key in marks:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / 1e3
        launches += e.count
    if not marks:
        return sum(per_kernel.values()), launches, per_kernel
    inside = {}

    def walk(ev):
        for k_ in ev.kernels:
            inside[k_.name] = inside.get(k_.name, 0.0) + k_.duration / 1e3
        for ch_ in ev.cpu_children:
            walk(ch_)
    for e in prof.events():
        if e.name in marks and str(e.device_type).endswith("CPU"):
            walk(e)
    return sum(per_kernel.values()), launches, per_kernel, inside


def marked(fn, label: str):
    """``fn`` run inside a ``torch.profiler.record_function`` range named
    ``label``."""
    from torch.profiler import record_function

    def run(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return run


def count_syncs(fn):
    """Host syncs ``fn()`` makes, by PyTorch's sync debug mode
    (``step_audit.host_syncs``, the step audit's JA401 capture)."""
    from repro_torch.analysis.step_audit import host_syncs
    torch.cuda.synchronize()
    with host_syncs() as syncs:
        fn()
    return len(syncs)


def prefill_and_decode(lm, params, cfg, tokens, extra=None):
    """``forward``'s logits at every position of ``tokens`` (B, T) and
    ``decode_step``'s after the same tokens: the kernel's causal prefill
    and the kernel-free decode path, (B, T, V) each.  ``extra`` (an
    enc-dec's ``"frames"``) goes into every batch."""
    B, T = tokens.shape
    extra = extra or {}
    full, _ = lm.forward(params, cfg, {"tokens": tokens, **extra})
    cache = lm.init_cache(cfg, B, T, device=tokens.device)
    steps_ = []
    for t_ in range(T):
        step_logits, cache = lm.decode_step(
            params, cfg, {"token": tokens[:, t_],
                          "t": torch.full((B,), t_, dtype=torch.int32,
                                          device=tokens.device), **extra},
            cache)
        steps_.append(step_logits)
    return full, torch.stack(steps_, dim=1)


def logit_gap(a, b):
    """(max |a - b|, mean |a - b|, positions whose greedy tokens agree)."""
    d = (a - b).abs()
    same = int((a.argmax(-1) == b.argmax(-1)).sum())
    return float(d.max()), float(d.mean()), same


def sdpa_backends(q, k, v, **kw):
    """The fused backends of ``F.scaled_dot_product_attention`` (flash,
    memory-efficient, cuDNN) that take attention over q, k, v (B, H, T,
    D), causal unless ``kw`` says otherwise; each refusal is the
    backend's own ``RuntimeError``."""
    kw = {"is_causal": True, **kw}
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    ok = []
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                with sdpa_kernel([b]):
                    F.scaled_dot_product_attention(q, k, v, **kw)
            except RuntimeError:
                continue
        ok.append(b.name)
    torch.cuda.synchronize()
    return ok


def tree_numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_numel(v) for v in tree)
    return 0 if tree is None else tree.numel()


def sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def bench_step(algo_name, fields, kw, cfg, parts, batch, lr, device):
    """One of ``BENCH_STEPS`` as the trainer makes it on ``device``: a step
    function ``(state, t) -> state`` with the trainer's host read of the
    step's floats, and the state to start from.  Gaia under SkewScout also
    books each step with the scout and travels at ``travel_every``: one
    probe a node, its model scored on 256 samples at home and 256 away."""
    from repro_torch.configs.base import CommConfig, FabricConfig
    from repro_torch.core import trainer
    from repro_torch.core.algorithms.base import tree_size
    from repro_torch.core.skewscout import SkewScout
    from repro_torch.data.pipeline import DecentralizedLoader
    from repro_torch.models.cnn import init_cnn
    from repro_torch.topology import LINK_PROFILES, CommLedger, build_schedule
    comm = CommConfig(fabric=FabricConfig(topology="ring"), **fields)
    fns, eval_acc = trainer.make_cnn_fns(cfg)
    algo = trainer.make_algorithm(algo_name, fns, K, comm)
    p0, s0 = init_cnn(torch.Generator().manual_seed(0), cfg)
    state = algo.init(tree_to(p0, device), tree_to(s0, device))
    scout = loader = None
    if comm.skewscout:
        ledger = CommLedger(build_schedule("ring", K),
                            LINK_PROFILES[comm.fabric.profile],
                            config=comm.fabric)
        scout = SkewScout(comm, algo_name, tree_size(p0), eval_acc,
                          ledger=ledger)
        loader = DecentralizedLoader(parts, 20, seed=0)

    def step(state_, t_):
        kw_ = dict(kw)
        if scout is not None:
            kw_["t0"] = torch.tensor(scout.theta, dtype=torch.float32,
                                     device=device)
        new, met = algo.step(state_, batch, lr, t_, **kw_)
        cf = float(met["comm_floats"])
        if scout is not None:
            scout.record_step(cf)
            scout.maybe_travel(t_, algo, new,
                               lambda node: loader.sample_train_subset(
                                   node, 256, seed=t_))
        return new
    return step, state, scout


def drive_bench_path(device: str, out_dir: Path):
    """Phase 10: the paper benches' path through the port's entry points on
    ``device``, every training run's launch counts set to 0 just before it
    and read just after: (a) ``benchmarks.run --only fig4 --json
    out_dir``, its CSV captured; (b) ``fig_topology.smoke_async()`` and
    ``smoke_links()``; (c) ``smoke_scale()`` on the host; (d)
    ``examples.quickstart``.  Returns what ``check_bench_path`` holds to
    the contract; the smokes' own assertions run inside them."""
    import io
    from repro_torch.benchmarks import fig_topology
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.examples import quickstart
    from repro_torch.kernels import ops
    runs = []

    def counted(train):
        def run_counted(cfg_, algo_name, *args, **kwargs):
            for k_ in ops.launches:
                ops.launches[k_] = 0
            sync(device)
            t0 = time.perf_counter()
            r = train(cfg_, algo_name, *args, **kwargs)
            sync(device)
            runs[-1][1].append({
                "algo": algo_name, "steps": kwargs["steps"],
                "wall_s": time.perf_counter() - t0,
                "launches": {k_: c for k_, c in ops.launches.items() if c},
                "val_acc": r.val_acc, "comm_savings": r.comm_savings,
                "sim_time_s": r.sim_time_s})
            return r
        return run_counted

    out = {}
    for k_ in ops.launches:
        ops.launches[k_] = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = bench_run.main(["--only", "fig4", "--json", str(out_dir),
                             "--device", device])
    sync(device)
    out["fig4"] = {"rc": rc, "stdout": buf.getvalue(),
                   "wall_s": time.perf_counter() - t0,
                   "launches": {k_: c for k_, c in ops.launches.items() if c},
                   "bench": json.loads((out_dir / "BENCH_fig4.json")
                                       .read_text())}
    print(buf.getvalue(), end="", flush=True)
    with swapped(fig_topology, "train_decentralized",
                 counted(fig_topology.train_decentralized)):
        for smoke in ("smoke_async", "smoke_links"):
            runs.append((smoke, []))
            out[smoke] = getattr(fig_topology, smoke)(device=device)
    out["smoke_scale"] = fig_topology.smoke_scale()
    runs.append(("quickstart", []))
    with swapped(quickstart, "train_decentralized",
                 counted(quickstart.train_decentralized)):
        out["quickstart_rc"] = quickstart.main(["--device", device])
    out["runs"] = dict(runs)
    return out


def check_bench_path(b10, card_name: str, power_limit: str):
    """Phase 10's checks on ``drive_bench_path``'s result: the fig4 CSV row
    and ``BENCH_fig4.json`` (this card, non-IID μ_B above IID), one gossip
    launch a D-PSGD or AD-PSGD step and none of the other kind, one
    ``gaia_select`` launch a quickstart step.  Returns the phase's
    summary."""
    fig4 = b10["fig4"]
    assert fig4["rc"] == 0, fig4
    row = [ln for ln in fig4["stdout"].splitlines()
           if ln.startswith("fig4,")]
    assert len(row) == 1, fig4["stdout"]
    _, us, derived = row[0].split(",", 2)
    means = dict(part.split(":mean_div=") for part in derived.split(";"))
    iid, noniid = float(means["iid"]), float(means["noniid"])
    bench = fig4["bench"]
    assert bench["device"] == card_name and \
        bench["power_limit"] == power_limit, bench
    assert bench["derived"] == derived and float(us) > 0
    assert np.all(np.isfinite([r["mu_divergence"] for r in bench["rows"]]))
    assert noniid > iid, (iid, noniid)
    gossip = {"dpsgd": "neighbor_mix", "adpsgd": "neighbor_mix_src"}
    for smoke in ("smoke_async", "smoke_links"):
        runs = b10["runs"][smoke]
        assert sorted(r["algo"] for r in runs) == ["adpsgd", "dpsgd"], runs
        for r in runs:
            want = {gossip[r["algo"]]: r["steps"]}
            assert r["launches"] == want, (smoke, r)
    qs = b10["runs"]["quickstart"]
    assert b10["quickstart_rc"] == 0 and len(qs) == 2, qs
    for r in qs:
        assert r["launches"] == {"gaia_select": r["steps"]}, r
    scale = b10["smoke_scale"][-1]
    return {"fig4": {"iid_mean_mu_divergence": iid,
                     "noniid_mean_mu_divergence": noniid,
                     "ratio": noniid / iid, "wall_s": fig4["wall_s"],
                     "launches": fig4["launches"]},
            "smokes": {s: b10["runs"][s] for s in ("smoke_async",
                                                   "smoke_links")},
            "smoke_scale_10k": {k_: scale[k_] for k_ in (
                "nodes", "edges", "active_edges", "wall_s",
                "per_round_ms")},
            "quickstart": qs}


def lm_train_phase(dev: torch.device, out_dir: Path):
    """Phase 11: LM training on the card.  (a) the attention's autograd
    route (``ops.FlashAttention``: the kernel forward, the plain chunked
    backward) against autograd through ``ref.flash_attention_bthd_ref``,
    at qwen3's shape in bfloat16 and at a float32 shape with a window and
    a softcap, timed beside SDPA's forward and backward; and Gaia's
    float32-v, bfloat16-w ``gaia_select`` instance at qwen3's leaves,
    bit-exact; (b) qwen3-0.6b at full width under the six strategies,
    every launch count set to 0 just before a strategy's timed steps and
    read just after, then each exchange op held against its plain
    version on one more step's own inputs; (c) one bsp step through the
    kernel route against the plain route, at full depth in float32 and
    in bfloat16 (held against the float32 step) and on 4-layer cuts; (d)
    the training example for gaia and dpsgd; (e) a checkpoint round
    trip.  Returns (summary, the kernels' phase 11
    figures by kernel name); a failed check raises."""
    import shutil
    import torch.nn.functional as F
    from repro_torch import checkpointing as ckpt
    from repro_torch import pytree
    from repro_torch.configs.base import CommConfig, FabricConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.examples import train_lm_decentralized as lm_example
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import steps as lsteps
    from repro_torch.models import model as lm
    from repro_torch.topology.graphs import build_demo_schedule
    t_phase = time.perf_counter()
    cfg = get_config("qwen3-0.6b")
    a = cfg.attention
    gen = torch.Generator(device=dev).manual_seed(11)
    summary, kern = {}, {}

    def zero_counts():
        for k_ in ops.launches:
            ops.launches[k_] = 0

    # (a) the attention's gradients, and its times
    def views(f, H_, Hkv_, D_):
        return (f[..., :H_ * D_].unflatten(2, (H_, D_)),
                f[..., H_ * D_:(H_ + Hkv_) * D_].unflatten(2, (Hkv_, D_)),
                f[..., (H_ + Hkv_) * D_:].unflatten(2, (Hkv_, D_)))

    attn = {}
    for label, (B_, T_, H_, Hkv_, D_), dtype, kw in (
            ("qwen3 bf16 causal", (TRAIN_B, TRAIN_T, a.n_heads,
                                   a.n_kv_heads, a.head_dim),
             torch.bfloat16, {"causal": True}),
            ("f32 window 256 softcap 30", (2, 512, 8, 2, 64), torch.float32,
             {"causal": True, "window": 256, "logit_softcap": 30.0})):
        fused = torch.randn(B_, T_, (H_ + 2 * Hkv_) * D_, device=dev,
                            generator=gen).to(dtype)
        dout = torch.randn(B_, T_, H_, D_, device=dev, generator=gen).to(
            dtype)
        grads = {}
        with tf32_off():
            for route, fn in (("function", ops.flash_attention_bthd),
                              ("plain", ref.flash_attention_bthd_ref)):
                f_ = fused.detach().requires_grad_()
                zero_counts()
                fn(*views(f_, H_, Hkv_, D_), **kw).backward(dout)
                torch.cuda.synchronize()
                assert ops.launches["flash_attention"] == (
                    route == "function"), (label, route, ops.launches)
                grads[route] = f_.grad
        r = {}
        for part, g_k, g_p in zip(("dq", "dk", "dv"),
                                  views(grads["function"], H_, Hkv_, D_),
                                  views(grads["plain"], H_, Hkv_, D_)):
            scale_ = float(g_p.float().abs().max())
            err = float((g_k.float() - g_p.float()).abs().max())
            r[part] = {"max_abs_err": err, "max_abs": scale_,
                       "mean_abs_err": float((g_k.float() - g_p.float())
                                             .abs().mean())}
            assert err <= TRAIN_ATTN_TOL[dtype] * scale_, (label, part, err,
                                                          scale_)
        print(f"(a) attention gradients, {label} (B {B_}, T {T_}, {H_} over "
              f"{Hkv_} heads of {D_}): autograd route against autograd "
              f"through the plain version " + ", ".join(
                  f"{k_} max |err| {v_['max_abs_err']:.4g} of max "
                  f"{v_['max_abs']:.4g} (mean {v_['mean_abs_err']:.3g})"
                  for k_, v_ in r.items())
              + f"; bound {TRAIN_ATTN_TOL[dtype]} x max", flush=True)
        attn[label] = r
        if dtype != torch.bfloat16:
            continue
        q, k, v = views(fused, H_, Hkv_, D_)
        leaves_ = [t_.detach().requires_grad_() for t_ in (q, k, v)]
        tl = [t_.detach().transpose(1, 2).requires_grad_() for t_ in (q, k, v)]
        dt_ = dout.transpose(1, 2)
        r.update({
            "fwd_ms": time_ms(lambda: ops.flash_attention_bthd(q, k, v)),
            "bwd_ms": time_ms(lambda: ref.flash_attention_bthd_bwd_ref(
                q, k, v, dout), reps=20),
            "fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
                ops.flash_attention_bthd(*leaves_), leaves_, dout), reps=20),
            "plain_fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
                ref.flash_attention_bthd_ref(*leaves_), leaves_, dout),
                reps=20),
            "sdpa_fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(*tl, is_causal=True,
                                               enable_gqa=True), tl, dt_),
                reps=20),
            "sdpa_fwd_ms": time_ms(lambda: F.scaled_dot_product_attention(
                *(t_.detach() for t_ in tl), is_causal=True,
                enable_gqa=True))})
        pairs = T_ * (T_ + 1) // 2
        q_bytes, kv_bytes = B_ * T_ * H_ * D_ * 2, B_ * T_ * Hkv_ * D_ * 2
        r["fwd_bound_ms"], r["fwd_bound_by"] = bound_ms(
            2 * q_bytes + 2 * kv_bytes, 4 * B_ * H_ * D_ * pairs,
            BF16_FLOPS_PER_S)
        # backward: q, k, v, dout read, dq, dk, dv written; five products
        # a valid (query, key) pair (the scores again, dp, dq, dk, dv)
        r["bwd_bound_ms"], r["bwd_bound_by"] = bound_ms(
            4 * q_bytes + 4 * kv_bytes, 10 * B_ * H_ * D_ * pairs,
            BF16_FLOPS_PER_S)
        print(f"(a) times at {label}: forward kernel {r['fwd_ms']:.4f} ms "
              f"(bound {r['fwd_bound_ms']:.5f}), backward (plain, chunked) "
              f"{r['bwd_ms']:.4f} ms (bound {r['bwd_bound_ms']:.5f}, "
              f"{r['bwd_bound_by']}; {r['bwd_ms'] / r['bwd_bound_ms']:.1f}x), "
              f"autograd route forward + backward {r['fwd_bwd_ms']:.4f} ms, "
              f"through the plain version {r['plain_fwd_bwd_ms']:.4f} ms; "
              f"SDPA (enable_gqa, same views) forward {r['sdpa_fwd_ms']:.4f}"
              f" ms, forward + backward {r['sdpa_fwd_bwd_ms']:.4f} ms "
              f"(a yardstick: it rounds p to bfloat16)", flush=True)
        del q, k, v, leaves_, tl, dt_
        del fused, dout, grads
    summary["attention"] = attn
    kern["flash_attention"] = {k_: attn["qwen3 bf16 causal"][k_] for k_ in (
        "fwd_ms", "bwd_ms", "fwd_bound_ms", "bwd_bound_ms", "fwd_bwd_ms",
        "plain_fwd_bwd_ms", "sdpa_fwd_ms", "sdpa_fwd_bwd_ms")}

    # (b) qwen3-0.6b at full width, every strategy
    t0 = time.perf_counter()
    base = lm.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                         dev)
    torch.cuda.synchronize()
    base_leaves = pytree.leaves(base)
    groups = lsteps.dtype_groups(base_leaves)
    n_param = sum(t_.numel() for t_ in base_leaves)
    print(f"qwen3-0.6b: {n_param} parameters in {len(base_leaves)} leaves "
          f"({', '.join(f'{len(i_)} {str(d_)[6:]}' for d_, i_ in groups.items())}"
          f"), drawn in {time.perf_counter() - t0:.2f} s", flush=True)

    # Gaia's mixed instance at the stacked bf16 leaves: float32 v, bf16 w
    bf = [base_leaves[i] for i in groups[torch.bfloat16]]
    ws = [w_.unsqueeze(0).repeat(TRAIN_PODS, *([1] * w_.dim())) for w_ in bf]
    vs = [torch.randn(w_.shape, device=dev, generator=gen) * 1e-3
          for w_ in ws]
    thr = torch.full((), 0.05, device=dev)
    outs, counts = ops.gaia_select_many(vs, ws, thr)
    for v_, w_, o_, c_ in zip(vs, ws, outs, counts):
        rsel, rcnt = ref.gaia_select_ref(v_, w_, thr)
        assert o_.dtype == torch.float32 and torch.equal(o_, rsel)
        assert int(c_) == int(rcnt)
    n_el = sum(w_.numel() for w_ in ws)
    outs_ = [torch.empty_like(v_) for v_ in vs]
    cnt_ = torch.zeros(len(vs), dtype=torch.int32, device=dev)
    g = {"ms": time_ms(lambda: ops.launch_gaia_select(
             vs, ws, thr.reshape(1), outs_, cnt_), reps=20),
         "f32_copy_ms": time_ms(lambda: ops.gaia_select_many(
             vs, [w_.float() for w_ in ws], thr), reps=20),
         "plain_ms": time_ms(lambda: ref.gaia_select_many_ref(vs, ws, thr),
                             reps=5), "elements": n_el}
    g["bound_ms"], g["bound_by"] = bound_ms(10 * n_el, 3 * n_el)
    print(f"gaia_select float32 v over bfloat16 w at qwen3's {len(ws)} "
          f"stacked bf16 leaves ({n_el} elements), bit-exact: one launch "
          f"{g['ms']:.4f} ms (bound {g['bound_ms']:.4f}, {g['bound_by']}; "
          f"{g['ms'] / g['bound_ms']:.2f}x), with a float32 copy of w "
          f"instead {g['f32_copy_ms']:.4f} ms, plain {g['plain_ms']:.4f} ms",
          flush=True)
    kern["gaia_select"] = {"mixed_" + k_: v_ for k_, v_ in g.items()}
    del ws, vs, outs, outs_, counts
    torch.cuda.empty_cache()

    rs = np.random.default_rng(11)
    seqs = torch.from_numpy(rs.integers(
        0, cfg.vocab, (TRAIN_STEPS + 2, TRAIN_PODS, TRAIN_B,
                       TRAIN_T + 1))).to(dev)
    batches = [{"tokens": s_[..., :-1], "labels": s_[..., 1:]}
               for s_ in seqs]
    sched = build_demo_schedule("ring", TRAIN_PODS)
    n_attn = cfg.n_layers * TRAIN_PODS * 2      # and again under remat
    want_kernel = {"bsp": {}, "fedavg": {},
                   "gaia": {"gaia_select": len(groups)},
                   "dgc": {"dgc_sparsify": TRAIN_PODS * len(base_leaves)},
                   "dpsgd": {"neighbor_mix": len(groups)},
                   "adpsgd": {"neighbor_mix_src": len(groups)}}
    runs = {}
    exchange_op = {"gaia": "gaia_select_many", "dgc": "dgc_sparsify",
                   "dpsgd": "neighbor_mix_many",
                   "adpsgd": "neighbor_mix_push_many"}

    def exchange_against_plain(strategy, run_step):
        """One more step with the strategy's exchange op recorded, then
        each recorded call's plain version on the same inputs, gated as
        ``TRAIN_MIX_TOL`` says: (max |err| of the mixed leaves, entries
        checked, entries that differ)."""
        name_, calls = exchange_op[strategy], []
        op = getattr(ops, name_)

        def recorded(*args):
            out = op(*args)
            calls.append((args, out))
            return out
        with swapped(ops, name_, recorded):
            run_step()
        torch.cuda.synchronize()
        worst, n_el, differ = 0.0, 0, 0
        with tf32_off():
            for args, out in calls:
                if strategy == "gaia":
                    sel, cnt = ref.gaia_select_many_ref(*args)
                    assert all(torch.equal(a_, b_)
                               for a_, b_ in zip(out[0], sel)), strategy
                    assert torch.equal(out[1], cnt), strategy
                    n_el += sum(v_.numel() for v_ in args[0])
                    continue
                if strategy == "dgc":
                    sel, cnt, t_ = ref.dgc_sparsify_ref(*args)
                    assert float(out[2]) == float(t_), (float(out[2]),
                                                        float(t_))
                    assert int(out[1]) == int(cnt), (int(out[1]), int(cnt))
                    assert torch.equal(out[0], sel), strategy
                    n_el += args[0].numel()
                    continue
                xs, mix_ = args[0], args[-1]
                if strategy == "dpsgd":
                    got, want = out, ref.neighbor_mix_many_ref(
                        xs, mix_.idx, mix_.w, mix_.self_w)
                else:
                    got = out[0]
                    want, pushed = ref.neighbor_mix_push_many_ref(
                        xs, args[1], mix_.idx, mix_.w, mix_.self_w)
                    assert torch.equal(out[1], pushed), strategy
                    del pushed
                for o_, e_ in zip(got, want):
                    d_ = (o_.float() - e_.float()).abs()
                    worst = max(worst, float(d_.max()))
                    differ += int((d_ > 0).sum())
                    n_el += o_.numel()
                    tol = TRAIN_MIX_TOL[o_.dtype]
                    torch.testing.assert_close(o_.float(), e_.float(),
                                               atol=tol, rtol=tol)
                del want
        del calls
        torch.cuda.empty_cache()
        return worst, n_el, differ

    for strategy, fields in TRAIN_RUNS:
        comm = CommConfig(strategy=strategy,
                          fabric=FabricConfig(topology="ring"), **fields)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = lsteps.make_train_state(base, comm, TRAIN_PODS)
        step = lsteps.make_train_step(cfg, comm, lr=TRAIN_LR, remat=True)
        kw = {}
        if strategy in lsteps.GOSSIP_STRATEGIES:
            kw["mix"] = lsteps.gossip_operands(
                sched, 0, device=dev, **({
                    "staleness": TRAIN_STALENESS,
                    "max_staleness": comm.max_staleness}
                    if strategy == "adpsgd" else {}))
        losses, times = [], []
        state, m = step(state, batches[0], 0, **kw)      # warm-up
        losses.append(m["loss"])
        torch.cuda.synchronize()
        zero_counts()
        for i in range(1, TRAIN_STEPS + 1):
            t0 = time.perf_counter()
            state, m = step(state, batches[i], i, **kw)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(m["loss"])
        per_step = {k_: c_ / TRAIN_STEPS for k_, c_ in ops.launches.items()
                    if c_}
        box = [state]
        syncs = count_syncs(lambda: box.__setitem__(0, step(
            box[0], batches[-1], TRAIN_STEPS + 1, **kw)[0]))
        state = box[0]
        losses = [float(x_) for x_ in losses]
        r = {"losses": losses, "wall_ms": times,
             "median_ms": float(np.median(times)),
             "tokens_per_s": TRAIN_PODS * TRAIN_B * TRAIN_T
             / (float(np.median(times)) / 1e3),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "syncs_per_step": syncs, "launches_per_step": per_step,
             "metrics": {k_: float(v_) for k_, v_ in m.items()}}
        assert np.all(np.isfinite(losses)), (strategy, losses)
        assert per_step == {"flash_attention": n_attn,
                            **want_kernel[strategy]}, (strategy, per_step)
        finite = all(bool(torch.isfinite(t_).all())
                     for t_ in pytree.leaves(state["params"]))
        assert finite, strategy
        print(f"(b) {strategy}: losses {[round(x_, 4) for x_ in losses]}, "
              f"{r['median_ms']:.1f} ms a step (median of {TRAIN_STEPS}: "
              f"{[round(x_, 1) for x_ in times]}; "
              f"{r['tokens_per_s']:.0f} tokens/s), peak "
              f"{r['peak_gb']:.2f} GB, {syncs} host syncs a step, launches "
              f"a step {per_step}, metrics {r['metrics']}", flush=True)
        if strategy in exchange_op:
            err, n_el, differ = exchange_against_plain(
                strategy, lambda: box.__setitem__(0, step(
                    box[0], batches[-1], TRAIN_STEPS + 2, **kw)[0]))
            state = box[0]
            r["exchange_check"] = {"max_abs_err": err, "elements": n_el,
                                   "differ": differ}
            print(f"(b) {strategy}: one more step's {exchange_op[strategy]} "
                  f"calls against the plain version on the same inputs, "
                  f"{n_el} entries: " + (
                      "selections, counts and thresholds bit for bit"
                      if strategy in ("gaia", "dgc") else
                      f"mixed leaves max |err| {err:.4g} ({differ} entries "
                      f"differ; tol {TRAIN_MIX_TOL[torch.bfloat16]} bf16, "
                      f"{TRAIN_MIX_TOL[torch.float32]} f32)"
                      + (", the pushed buffer bit for bit"
                         if strategy == "adpsgd" else "")), flush=True)
        if strategy == "bsp":
            # one more step under torch.profiler, the attention's plain
            # backward marked: device busy time by kind
            with swapped(ref, "flash_attention_bthd_bwd_ref",
                         marked(ref.flash_attention_bthd_bwd_ref,
                                "attention_bwd")):
                busy, n_kern, per_kernel, inside = device_profile(
                    lambda: box.__setitem__(0, step(
                        box[0], batches[-1], TRAIN_STEPS + 2)[0]),
                    marks=("attention_bwd",))
            state = box[0]
            split = {"flash_attention": 0.0, "attention_bwd": 0.0,
                     "gemm": 0.0, "other": 0.0}
            for k_, v_ in per_kernel.items():
                low = k_.lower()
                split["flash_attention" if "flash_attention" in low else
                      "gemm" if any(w_ in low for w_ in GEMM_KEYS) else
                      "other"] += v_
            for k_, v_ in inside.items():       # the backward's own kernels
                split["gemm" if any(w_ in k_.lower() for w_ in GEMM_KEYS)
                      else "other"] -= v_
                split["attention_bwd"] += v_
            r["profile"] = {"kernels": n_kern, "busy_ms": busy,
                            "idle": 1 - busy / r["median_ms"],
                            "split_ms": split, "top": {
                                k_[:60]: round(v_, 3) for k_, v_ in sorted(
                                    per_kernel.items(),
                                    key=lambda kv: -kv[1])[:8]}}
            print(f"(b) bsp step under torch.profiler: {n_kern} kernels, "
                  f"device busy {busy:.1f} ms of the unprofiled "
                  f"{r['median_ms']:.1f} ms wall (idle "
                  f"{100 * r['profile']['idle']:.1f}%): " + ", ".join(
                      f"{k_} {v_:.1f} ms ({100 * v_ / busy:.1f}%)"
                      for k_, v_ in split.items())
                  + "; top kernels " + json.dumps(r["profile"]["top"]),
                  flush=True)
            full_params = state["params"]
        runs[strategy] = r
        del state, step, m
    summary["strategies"] = runs
    for name_, strat in (("gaia_select", "gaia"), ("dgc_sparsify", "dgc"),
                         ("neighbor_mix", "dpsgd"),
                         ("neighbor_mix_src", "adpsgd"),
                         ("flash_attention", "bsp")):
        kern.setdefault(name_, {})["lm_train_launches_per_step"] = \
            runs[strat]["launches_per_step"][name_]
        if "exchange_check" in runs[strat]:
            kern[name_]["lm_train_check"] = runs[strat]["exchange_check"]

    # (c) the kernel route against the plain route, one bsp step from the
    # same state: qwen3-0.6b at full depth in float32 (TF32 off; gated)
    # and in bfloat16 (gated against float32), and 4-layer cuts of both
    # (the float32 one gated)
    route = {}
    bsp = CommConfig(strategy="bsp", fabric=FabricConfig(topology="ring"))

    def bsp_step(cfg_, p_, side):
        """One bsp step of a fresh state of ``p_`` with the attention's
        kernel route or its plain version swapped in: (params' leaves,
        vel's leaves, loss)."""
        step = lsteps.make_train_step(cfg_, bsp, lr=TRAIN_LR, remat=True)
        with contextlib.ExitStack() as stack:
            if cfg_.dtype == "float32":
                stack.enter_context(tf32_off())
            if side == "plain":
                stack.enter_context(swapped(ops, "flash_attention_bthd",
                                            ref.flash_attention_bthd_ref))
            zero_counts()
            st, m_ = step(lsteps.make_train_state(p_, bsp, TRAIN_PODS),
                          batches[0], 0)
            assert (ops.launches["flash_attention"] > 0) == \
                (side == "kernel"), (cfg_.dtype, side, ops.launches)
        return (pytree.leaves(st["params"]), pytree.leaves(st["vel"]),
                float(m_["loss"]))

    def rel_l2(xs, ys):
        """||xs - ys|| / ||ys|| over the leaves, in float32."""
        num = sum(float((x_.float() - y_.float()).square().sum())
                  for x_, y_ in zip(xs, ys))
        return (num / sum(float(y_.float().square().sum()) for y_ in ys)
                ) ** 0.5

    def routes(label, p_, kernel, plain):
        """The two routes' steps from ``p_`` compared, printed, returned."""
        worst, differ, total = 0.0, 0, 0
        for o_, k_, q_ in zip(pytree.leaves(p_), kernel[0], plain[0]):
            d_ = (k_.float() - q_.float()).abs()
            upd = (q_.float() - o_.float())
            bound = TRAIN_ROUTE_TOL * float(upd.abs().max()) + 2 * float(
                torch.finfo(q_.dtype).eps) * float(q_.float().abs().max())
            worst = max(worst, float(d_.max()) / bound)
            differ += int((d_ > 0).sum())
            total += d_.numel()
        old = [o_.float() for o_ in pytree.leaves(p_)]
        r = {"max_over_bound": worst, "share_differing": differ / total,
             "update_rel_l2": rel_l2(
                 [k_.float() - o_ for k_, o_ in zip(kernel[0], old)],
                 [q_.float() - o_ for q_, o_ in zip(plain[0], old)]),
             # the velocity, -lr times the float32 gradient: the
             # gradients' agreement before the weights round the update
             "vel_rel_l2": rel_l2(kernel[1], plain[1]),
             "loss": {"kernel": kernel[2], "plain": plain[2]}}
        print(f"(c) {label}: bsp step, kernel route against the plain "
              f"route: loss {kernel[2]:.6f} and {plain[2]:.6f}; params: "
              f"{100 * r['share_differing']:.3f}% of entries differ, the "
              f"update's relative L2 difference {r['update_rel_l2']:.3g} "
              f"(the velocity's, before the weights round it: "
              f"{r['vel_rel_l2']:.3g}), the worst leaf at "
              f"{r['max_over_bound']:.3g} of the bound (1e-3 of its largest "
              f"update + 2 ulps of its largest weight)", flush=True)
        route[label] = r
        return r

    full32 = dataclasses.replace(cfg, dtype="float32")
    p32 = pytree.tree_map(lambda t_: t_.float(), base)
    anchor = bsp_step(full32, p32, "plain")
    r = routes("float32 full depth", p32, bsp_step(full32, p32, "kernel"),
               anchor)
    print(f"(c) float32 full depth: the velocities' relative L2 difference "
          f"{r['vel_rel_l2']:.3g}, gated at {TRAIN_ROUTE_GRAD_TOL}",
          flush=True)
    assert r["vel_rel_l2"] <= TRAIN_ROUTE_GRAD_TOL, r
    del p32
    torch.cuda.empty_cache()
    kernel16, plain16 = (bsp_step(cfg, base, side_)
                         for side_ in ("kernel", "plain"))
    r = routes("bf16 full depth", base, kernel16, plain16)
    r["kernel_from_f32"] = rel_l2(kernel16[1], anchor[1])
    r["plain_from_f32"] = rel_l2(plain16[1], anchor[1])
    print(f"(c) bf16 full depth against the float32 plain route's step "
          f"from the same weights: the velocity's relative L2 distance "
          f"{r['kernel_from_f32']:.4g} through the kernel route, "
          f"{r['plain_from_f32']:.4g} through the plain route (gated: "
          f"kernel <= {TRAIN_BF16_FROM_F32} x plain)", flush=True)
    assert r["kernel_from_f32"] <= TRAIN_BF16_FROM_F32 * r["plain_from_f32"], r
    del anchor, kernel16, plain16
    torch.cuda.empty_cache()
    for dtype_ in ("bfloat16", "float32"):
        cfg_ = dataclasses.replace(cfg, n_layers=TRAIN_ROUTE_CUT,
                                   dtype=dtype_)
        p_ = lm.init_model(torch.Generator(device=dev).manual_seed(1), cfg_,
                           dev)
        r = routes(f"{dtype_}, first {TRAIN_ROUTE_CUT} layers", p_,
                   *(bsp_step(cfg_, p_, side_)
                     for side_ in ("kernel", "plain")))
        if dtype_ == "float32":
            assert r["max_over_bound"] <= 1.0, r
        del p_
    summary["routes"] = route
    del base
    torch.cuda.empty_cache()

    # (d) the training example, gaia and dpsgd
    examples = {}
    for strategy in ("gaia", "dpsgd"):
        zero_counts()
        run = lm_example.train(lm_example.parse_args(
            ["--strategy", strategy, "--device", "cuda"]))
        made = {k_: c_ for k_, c_ in ops.launches.items() if c_}
        n_steps = 200
        n_layers = run["cfg"].n_layers
        want = {"flash_attention": n_layers * lm_example.N_PODS * n_steps,
                {"gaia": "gaia_select", "dpsgd": "neighbor_mix"}[strategy]:
                n_steps}
        assert made == want, (strategy, made, want)
        assert run["final_loss"] < lm_example.TARGET_LOSS, run["losses"]
        examples[strategy] = {"losses": run["losses"],
                              "seconds": run["seconds"],
                              "steps_per_s": n_steps / run["seconds"],
                              "launches": made, "state": run["state"]}
        print(f"(d) train_lm_decentralized --strategy {strategy}: final loss "
              f"{run['final_loss']:.4f} < {lm_example.TARGET_LOSS} in "
              f"{run['seconds']:.2f} s ({n_steps / run['seconds']:.1f} "
              f"steps/s, the loss read every 20 steps), launches {made}",
              flush=True)

    # (e) checkpoints: (d)'s gaia state and (b)'s full-width pod params
    ck_dir = out_dir / "ckpt_smoke"
    ckr = {}
    for label, tree, step_ in (("example state", examples["gaia"]["state"],
                                200),
                               ("qwen3-0.6b pod params", full_params, None)):
        target = ck_dir / label.replace(" ", "_")
        t0 = time.perf_counter()
        ckpt.save(str(target), tree, step=step_)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ckpt.restore(str(target), pytree.tree_map(torch.empty_like,
                                                         tree), step=step_)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        for x_, y_ in zip(pytree.leaves(back), pytree.leaves(tree)):
            assert x_.dtype == y_.dtype and x_.device == y_.device
            bits = torch.int16 if x_.dtype == torch.bfloat16 else None
            assert torch.equal(x_.view(bits) if bits else x_,
                               y_.view(bits) if bits else y_), label
        if step_ is not None:
            assert ckpt.latest_step(str(target)) == step_
        size = sum(f_.stat().st_size for f_ in target.rglob("*")
                   if f_.is_file())
        ckr[label] = {"leaves": len(pytree.leaves(tree)), "bytes": size,
                      "save_s": t_save, "restore_s": t_restore}
        print(f"(e) checkpoint of the {label}: {ckr[label]['leaves']} leaves, "
              f"{size / 1e9:.3f} GB on disk, saved in {t_save:.2f} s, "
              f"restored bit for bit in {t_restore:.2f} s", flush=True)
        del back
    shutil.rmtree(ck_dir)
    summary["checkpoints"] = ckr
    summary["examples"] = {k_: {x_: y_ for x_, y_ in v_.items()
                                if x_ != "state"}
                           for k_, v_ in examples.items()}
    del examples, full_params
    torch.cuda.empty_cache()
    summary["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 11: {summary['wall_s']:.2f} s")
    return summary, kern


# ---------------------------------------------------------------------------
# Phase 12: the pod axis across processes
# ---------------------------------------------------------------------------

#: phase 12, the pod axis across processes: two gloo ranks on the one card,
#: one phase 11 pod each (qwen3-0.6b at full width, DIST_TIMED_LAYERS
#: deep, bf16, 2 x 1024 tokens,
#: remat, phase 11's lr and strategies); (c) a float32 cut of DIST_CUT
#: layers at full width, its velocity gated at phase 11's 1e-3; (d) NCCL
#: at world size 1 (the two pods on the one rank, a bf16 cut), its steps
#: timed and one under the sync debug mode
DIST_RANKS, DIST_CUT, DIST_VEL_TOL, DIST_NCCL_STEPS = 2, 2, 1e-3, 3
#: (a)'s steps a strategy: one warm-up, then DIST_STEPS timed, the last
#: of which records the exchange (b) holds and counts the host syncs (3
#: until phase 16 (d) and (e) needed the script's time; an odd count, so
#: that fedavg's last step averages)
DIST_STEPS = 1
#: the depth of (a)'s timed steps and (b)'s exchange, at full width: 4 of
#: qwen3-0.6b's 28 layers (full depth until phase 14 needed the script's
#: time, 7 until phase 15 did; the exchange's leaves, and so its
#: launches, are the full model's in number)
DIST_TIMED_LAYERS = 4
#: the ranks' deadline (the process group's timeout and the parent's join)
DIST_TIMEOUT = 900


def _differ(a, b) -> int:
    """Entries where ``a`` and ``b`` (one shape and dtype) differ, counted
    2**26 at a time (a sum over a whole bool tensor would widen it to
    int64: 8 bytes an entry)."""
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                      a.dtype, b.dtype)
    if torch.equal(a, b):
        return 0
    return sum(int(torch.count_nonzero(x_ != y_)) for x_, y_ in zip(
        a.reshape(-1).split(1 << 26), b.reshape(-1).split(1 << 26)))


def _pod_axis(parts):
    """(tensor, its pod axis) for every tensor of an exchange's parts in
    ``pytree.leaves``' order: the leaves' axis 0, the snapshot buffers'
    axis 1."""
    from repro_torch import pytree
    return [(t_, 1 if k_ == "snaps" else 0) for k_ in sorted(parts)
            for t_ in pytree.leaves(parts[k_])]


def _requested() -> int:
    """Bytes the live CUDA tensors asked the caching allocator for, before
    its rounding (512 B a block; a large block left unsplit keeps up to
    1 MiB more in ``memory_allocated``)."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def _own_rows(t, axis, rank, rows):
    """Rank ``rank``'s ``rows`` pods of a stacked tensor's pod ``axis``."""
    return t.narrow(axis, rank * rows, rows)


def _dist_batches(dev, n):
    """``n`` global batches of phase 11's shape, made from the train spec
    (``launch.specs``) and seed 12: the same on every rank."""
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.specs import train_batch_specs
    (P, b, T), _ = train_batch_specs(
        get_config("qwen3-0.6b"), InputShape("phase 12", TRAIN_T,
                                             TRAIN_PODS * TRAIN_B, "train"),
        n_pods=TRAIN_PODS)["tokens"]
    seqs = torch.from_numpy(np.random.default_rng(12).integers(
        0, get_config("qwen3-0.6b").vocab, (n, P, b, T + 1))).to(dev)
    return [{"tokens": s_[..., :-1], "labels": s_[..., 1:]} for s_ in seqs]


def dist_rank(rank: int, dev: torch.device) -> dict:
    """One gloo rank of phase 12 (``procs.spawn``): (a) each strategy on
    its pod; (b) the last timed step's exchange inputs all-gathered, the
    one-card exchange run on them, and this rank's rows of its output
    against the two-rank exchange's; (c) a float32 cut's step against
    the one-card step that each rank runs itself (the same seeded state
    and batch).  Returns host numbers; a failed check raises."""
    from repro_torch import pytree
    from repro_torch.configs.base import CommConfig, FabricConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import meta as meta_lib
    from repro_torch.launch import sharding
    from repro_torch.launch import steps as lsteps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as lm
    from repro_torch.topology.graphs import build_demo_schedule
    t_rank = time.perf_counter()
    mesh = make_mesh((DIST_RANKS, 1, 1), device=dev)
    rows = TRAIN_PODS // DIST_RANKS
    cfg = dataclasses.replace(get_config("qwen3-0.6b"),
                              n_layers=DIST_TIMED_LAYERS)
    base = lm.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                         dev)
    batches = _dist_batches(dev, DIST_STEPS + 1)
    sched = build_demo_schedule("ring", TRAIN_PODS)
    out = {"rank": rank, "device": str(dev), "strategies": {}, "cut": {}}

    def operands(comm, mesh_):
        if comm.strategy not in lsteps.GOSSIP_STRATEGIES:
            return {}
        return {"mix": lsteps.gossip_operands(
            sched, 0, device=dev, mesh=mesh_, **({
                "staleness": TRAIN_STALENESS,
                "max_staleness": comm.max_staleness}
                if comm.strategy == "adpsgd" else {}))}

    for strategy, fields in TRAIN_RUNS:
        comm = CommConfig(strategy=strategy,
                          fabric=FabricConfig(topology="ring"), **fields)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step = lsteps.make_train_step(cfg, comm, mesh=mesh, lr=TRAIN_LR,
                                      remat=True)
        standin = rank == 0 and strategy in STANDIN_RUNS
        m0 = torch.cuda.memory_allocated()
        q0 = _requested()
        kw = operands(comm, mesh)
        box = [lsteps.make_train_state(base, comm, TRAIN_PODS, mesh=mesh),
               None]
        if standin:         # phase 17 (b): the state's and operands' bytes,
            #                 the rank's rows of the batch
            placed = sharding.batch_shardings(batches[0], mesh,
                                              pod_stacked=True)
            rec = {"arg_bytes": _requested() - q0,
                   "arg_alloc_bytes": torch.cuda.memory_allocated() - m0,
                   "arg_tensors": len(meta_lib.tensors_of((box[0], kw))),
                   "rows": {k_: (tuple(sharding.local_block(
                       v_, placed[k_], mesh).shape), str(v_.dtype))
                       for k_, v_ in batches[0].items()}}

        def one(i):
            box[0], box[1] = step(box[0], batches[i], i, **kw)
            losses.append(box[1]["loss"])
        losses = []
        if standin:             # phase 17 (b): the warm-up step recorded
            before = dict(ops.launches)
            m_step = torch.cuda.memory_allocated()
            with meta_lib.record_collectives(mesh) as colls:
                one(0)
            torch.cuda.synchronize()
            rec.update(
                collectives=[c_.key() for c_ in colls],
                launches={k_: n_ - before[k_] for k_, n_ in
                          ops.launches.items() if n_ != before[k_]},
                max_allocated=torch.cuda.max_memory_allocated(),
                step_rise=torch.cuda.max_memory_allocated() - m_step)
        else:
            one(0)                                           # warm-up
        torch.cuda.synchronize()
        for k_ in ops.launches:
            ops.launches[k_] = 0
        # the last timed step (where fedavg syncs) also counts its host
        # syncs and records its exchange for (b)
        ex, calls, times, syncs = step.exchange, [], [], None
        for i in range(1, DIST_STEPS + 1):
            t0 = time.perf_counter()
            if i < DIST_STEPS:
                one(i)
            else:
                def recorded(parts, **kw_):
                    got_ = ex(parts, **kw_)
                    calls.append((parts, kw_, got_))
                    return got_
                step.exchange = recorded
                syncs = count_syncs(lambda: one(i))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        per_step = {k_: c_ / DIST_STEPS for k_, c_ in ops.launches.items()
                    if c_}
        if rank == 0:
            print(f"phase 12 rank 0: {strategy} timed at "
                  f"{time.perf_counter() - t_rank:.1f} s", flush=True)
        r = {"losses": [float(x_) for x_ in losses], "wall_ms": times,
             "median_ms": float(np.median(times)),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "syncs_per_step": syncs, "launches_per_step": per_step,
             "finite": all(bool(torch.isfinite(t_).all())
                           for t_ in pytree.leaves(box[0]["params"])),
             "metrics": {k_: float(v_) for k_, v_ in box[1].items()}}
        if standin:
            r["standin"] = rec
        del box, step
        (parts, kw_, got), = calls
        del calls
        torch.cuda.empty_cache()        # (a)'s blocks, for the other rank
        # (b): every pod's inputs, the one-card exchange on them
        full = [mesh.all_gather(t_.movedim(ax_, 0).contiguous()).movedim(
            0, ax_).contiguous() for t_, ax_ in _pod_axis(parts)]
        full = pytree.unflatten(parts, full)
        del parts
        n_el, differ = 0, 0
        for turn in range(DIST_RANKS):      # one rank's one-card exchange
            if turn == rank:                # on the card at a time
                want = lsteps.make_exchange(comm, lr=TRAIN_LR)(
                    full, **{**kw_, **operands(comm, None)})
                del full
                for (g_, ax_), (w_, _) in zip(_pod_axis(got),
                                              _pod_axis(want)):
                    w_ = _own_rows(w_, ax_, rank, rows)
                    n_el += w_.numel()
                    differ += _differ(g_, w_.contiguous())
                del got, want
                torch.cuda.empty_cache()
            mesh.barrier()
        r["exchange_check"] = {"elements": n_el, "differ": differ}
        out["strategies"][strategy] = r
        if rank == 0:
            print(f"phase 12 rank 0: {strategy} exchange held at "
                  f"{time.perf_counter() - t_rank:.1f} s", flush=True)
        torch.cuda.empty_cache()
    del base
    torch.cuda.empty_cache()

    # (c) a float32 cut at full width, one step each way (TF32 off)
    cfg32 = dataclasses.replace(cfg, n_layers=DIST_CUT, dtype="float32")
    p32 = lm.init_model(torch.Generator(device=dev).manual_seed(1), cfg32,
                        dev)
    with tf32_off():
        for strategy, fields in TRAIN_RUNS:
            comm = CommConfig(strategy=strategy,
                              fabric=FabricConfig(topology="ring"), **fields)
            mine, _ = lsteps.make_train_step(
                cfg32, comm, mesh=mesh, lr=TRAIN_LR, remat=True)(
                lsteps.make_train_state(p32, comm, TRAIN_PODS, mesh=mesh),
                batches[0], 1, **operands(comm, mesh))
            one_card, _ = lsteps.make_train_step(
                cfg32, comm, lr=TRAIN_LR, remat=True)(
                lsteps.make_train_state(p32, comm, TRAIN_PODS),
                batches[0], 1, **operands(comm, None))
            r, num, den = {"vel_worst": 0.0, "worst_leaf": 0}, 0.0, 0.0
            for i_, (g_, w_) in enumerate(zip(
                    pytree.leaves(mine["vel"]),
                    pytree.leaves(one_card["vel"]))):
                w_ = _own_rows(w_, 0, rank, rows).double()
                d_ = g_.double() - w_
                num += float(d_.square().sum())
                den += float(w_.square().sum())
                rel = float(d_.abs().max()) / max(float(w_.abs().max()),
                                                  1e-30)
                if rel > r["vel_worst"]:
                    r["vel_worst"], r["worst_leaf"] = rel, i_
            r["vel_rel_l2"] = (num / max(den, 1e-300)) ** 0.5
            out["cut"][strategy] = r
            del mine, one_card
            torch.cuda.empty_cache()
    if rank == 0:
        print(f"phase 12 rank 0: (c) done at "
              f"{time.perf_counter() - t_rank:.1f} s", flush=True)
    return out


def dist_nccl_rank(rank: int, dev: torch.device) -> dict:
    """Phase 12 (d): a world-size-1 NCCL group through the same step, bsp
    and dpsgd on a bf16 cut (both pods on the rank): wall ms a step,
    launches, and one step's host syncs; then ``gossip_route_times``."""
    from repro_torch.configs.base import CommConfig, FabricConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as lsteps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as lm
    from repro_torch.topology.graphs import build_demo_schedule
    import torch.distributed as dist
    mesh = make_mesh((1, 1, 1), device=dev)
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=DIST_CUT)
    p = lm.init_model(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    batches = _dist_batches(dev, DIST_NCCL_STEPS + 2)
    out = {"backend": dist.get_backend(), "strategies": {}}
    for strategy in ("bsp", "dpsgd"):
        comm = CommConfig(strategy=strategy,
                          fabric=FabricConfig(topology="ring"))
        state = lsteps.make_train_state(p, comm, TRAIN_PODS, mesh=mesh)
        step = lsteps.make_train_step(cfg, comm, mesh=mesh, lr=TRAIN_LR)
        kw = ({"mix": lsteps.gossip_operands(
            build_demo_schedule("ring", TRAIN_PODS), 0, device=dev,
            mesh=mesh)} if strategy == "dpsgd" else {})
        state, m = step(state, batches[0], 0, **kw)
        torch.cuda.synchronize()
        for k_ in ops.launches:
            ops.launches[k_] = 0
        times = []
        for i in range(1, DIST_NCCL_STEPS + 1):
            t0 = time.perf_counter()
            state, m = step(state, batches[i], i, **kw)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        per_step = {k_: c_ / DIST_NCCL_STEPS
                    for k_, c_ in ops.launches.items() if c_}
        box = [state]
        syncs = count_syncs(lambda: box.__setitem__(0, step(
            box[0], batches[-1], DIST_NCCL_STEPS + 1, **kw)[0]))
        out["strategies"][strategy] = {
            "loss": float(m["loss"]), "median_ms": float(np.median(times)),
            "wall_ms": times, "syncs_per_step": syncs,
            "launches_per_step": per_step}
        del state, box, step
    del p
    torch.cuda.empty_cache()
    out["routes"] = gossip_route_times(dev, mesh)
    return out


def gossip_route_times(dev: torch.device, mesh) -> dict:
    """Phase 12 (d): the gossip exchanges of both routes on one card, on one
    set of full-width inputs (qwen3-0.6b, bf16, both pods on the rank; pod
    1's rows negated, and AD-PSGD's slot 1 halved, so that rows differ):
    the one-card route's fused kernels (``neighbor_mix_many``;
    ``neighbor_mix_push_many``) against the mesh route at world size 1
    (the rows gathered, or pushed and picked, NCCL's collective to itself,
    then ``neighbor_mix_src_many``).  Each exchange's median device ms
    over CUDA-event-timed calls, and the entries where the two differ."""
    from repro_torch import pytree
    from repro_torch.configs.base import CommConfig, FabricConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps as lsteps
    from repro_torch.models import model as lm
    from repro_torch.topology.graphs import build_demo_schedule
    params = lm.init_model(torch.Generator(device=dev).manual_seed(0),
                           get_config("qwen3-0.6b"), dev)
    sched = build_demo_schedule("ring", TRAIN_PODS)
    out = {}
    for strategy, fields in TRAIN_RUNS:
        if strategy not in lsteps.GOSSIP_STRATEGIES:
            continue
        comm = CommConfig(strategy=strategy,
                          fabric=FabricConfig(topology="ring"), **fields)
        state = lsteps.make_train_state(params, comm, TRAIN_PODS)
        parts = {"params": pytree.leaves(state["params"])}
        for t_ in parts["params"]:
            t_[1].neg_()
        kw = {}
        if strategy == "adpsgd":
            parts["snaps"] = state["snaps"]
            for v_ in parts["snaps"].values():
                v_[:, 1].neg_()
                v_[1].mul_(0.5)
            kw = {"staleness": TRAIN_STALENESS,
                  "max_staleness": comm.max_staleness}
        del state
        routes = {"one_card": (lsteps.make_exchange(comm),
                               lsteps.gossip_operands(sched, 0, device=dev,
                                                      **kw)),
                  "mesh": (lsteps.make_exchange(comm, mesh=mesh),
                           lsteps.gossip_operands(sched, 0, device=dev,
                                                  mesh=mesh, **kw))}
        a_, b_ = (ex_(parts, mix=m_) for ex_, m_ in routes.values())
        r = {"elements": sum(t_.numel() for t_ in pytree.leaves(a_)),
             "differ": sum(_differ(x_, y_) for x_, y_ in zip(
                 pytree.leaves(a_), pytree.leaves(b_)))}
        del a_, b_
        for name_, (ex_, m_) in routes.items():
            r[f"{name_}_ms"] = time_ms(lambda: ex_(parts, mix=m_), reps=10)
        out[strategy] = r
        del parts, routes
        torch.cuda.empty_cache()
    return out


def src_many_times(dev: torch.device) -> dict:
    """Row 2's body as phase 12's dpsgd step launches it on rank 0: the
    rank's qwen3-0.6b pod (its bf16 leaves, L = 1) mixed with both pods'
    gathered rows as the source.  The kernel alone, the op, the plain
    version and a dense W @ src (the neighbour term alone; a yardstick),
    each the median of CUDA-event-timed calls, the bound (x, src and the
    output moved once), and the kernel against the plain version: bit for
    bit (both accumulate in float32 and round once; with the ring's
    weights of 1/2 every product is exact)."""
    from repro_torch import pytree
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import steps as lsteps
    from repro_torch.launch.mesh import AXES, Mesh
    from repro_torch.models import model as lm
    from repro_torch.topology.graphs import build_demo_schedule
    leaves = pytree.leaves(lm.init_model(
        torch.Generator(device=dev).manual_seed(0), get_config("qwen3-0.6b"),
        dev))
    xs = [leaves[i].unsqueeze(0) for i in
          lsteps.dtype_groups(leaves)[torch.bfloat16]]
    flat = torch.cat([x_.reshape(1, -1) for x_ in xs], dim=1)
    src = torch.cat([flat, flat.roll(1, dims=1)])       # both pods' rows
    rank0 = Mesh((TRAIN_PODS, 1, 1), AXES, coords=(0, 0, 0))
    mix = lsteps.gossip_operands(build_demo_schedule("ring", TRAIN_PODS), 0,
                                 device=dev, mesh=rank0).mix
    outs = [torch.empty_like(x_) for x_ in xs]
    W = torch.zeros(1, TRAIN_PODS, dtype=torch.bfloat16, device=dev)
    W[0].index_add_(0, mix.idx[0].long(), mix.w[0].to(torch.bfloat16))
    with tf32_off():
        got = ops.neighbor_mix_src_many(xs, src, mix)
        want = ref.neighbor_mix_src_many_ref(xs, src, mix.idx, mix.w,
                                             mix.self_w)
    err = max(float((g_.float() - w_.float()).abs().max())
              for g_, w_ in zip(got, want))
    differ = sum(_differ(g_, w_) for g_, w_ in zip(got, want))
    del got, want
    n_el = flat.numel()
    r = {"elements": n_el, "max_abs_err": err, "differ": differ,
         "ms": time_ms(lambda: ops.launch_neighbor_mix_src_many(
             xs, src, mix, outs), reps=20),
         "op_ms": time_ms(lambda: ops.neighbor_mix_src_many(xs, src, mix),
                          reps=20),
         "plain_ms": time_ms(lambda: ref.neighbor_mix_src_many_ref(
             xs, src, mix.idx, mix.w, mix.self_w), reps=5),
         "library_ms": time_ms(lambda: W @ src, reps=20)}
    # x, src (2 rows) read and the output written, bf16; 2 float32 flops
    # an entry a term (self and one neighbour)
    r["bound_ms"], r["bound_by"] = bound_ms(4 * 2 * n_el, 4 * n_el)
    assert differ == 0, r
    return r


def dist_phase(dev: torch.device, background=None):
    """Phase 12: the pod axis across processes.  The kernels are built (the
    parent built them in phase 2); the parent empties its CUDA cache, then
    ``procs.spawn`` starts two gloo ranks on the card (``dist_rank``) and
    one NCCL rank (``dist_nccl_rank``); every check is gated here.
    ``background``, a thread, is started just before the gloo ranks
    (phase 17's sweep, host work on ``meta`` tensors while the parent
    waits).  Returns (summary, the kernels' phase 12 figures by kernel
    name); the summary's ``"standin"`` holds rank 0's phase 17 (b)
    records."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import procs
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n_layers = DIST_TIMED_LAYERS
    parent_gb = torch.cuda.memory_allocated() / 1e9
    mix_t = src_many_times(dev)
    print(f"neighbor_mix_src_many at phase 12's dpsgd shape (one pod's "
          f"{mix_t['elements']} bf16 entries, 2 gathered rows): kernel "
          f"{mix_t['ms']:.4f} ms (bound {mix_t['bound_ms']:.4f}, "
          f"{mix_t['bound_by']}; {mix_t['ms'] / mix_t['bound_ms']:.2f}x), op "
          f"{mix_t['op_ms']:.4f}, plain {mix_t['plain_ms']:.4f}, dense W @ src "
          f"{mix_t['library_ms']:.4f} (the neighbour term alone); against the "
          f"plain version max |err| {mix_t['max_abs_err']:.3g}, "
          f"{mix_t['differ']} entries differ (gate: bit for bit)", flush=True)
    torch.cuda.empty_cache()
    if background is not None:
        background.start()
    t0 = time.perf_counter()
    ranks = procs.spawn(dist_rank, DIST_RANKS, backend="gloo", device=dev,
                        timeout=DIST_TIMEOUT)
    t_gloo = time.perf_counter() - t0
    want_kernel = {"bsp": {}, "fedavg": {}, "gaia": {"gaia_select": 2},
                   "dgc": {"dgc_sparsify": 13},
                   "dpsgd": {"neighbor_mix_src": 2},
                   "adpsgd": {"neighbor_mix_src": 2}}
    summary = {"ranks": DIST_RANKS, "backend": "gloo", "strategies": {},
               "cut_by_rank": [r_["cut"] for r_ in ranks],
               "gloo_spawn_s": t_gloo, "parent_allocated_gb": parent_gb,
               "standin": {s_: ranks[0]["strategies"][s_]["standin"]
                           for s_ in STANDIN_RUNS}}
    tokens = TRAIN_PODS * TRAIN_B * TRAIN_T
    for strategy, _ in TRAIN_RUNS:
        rs = [r_["strategies"][strategy] for r_ in ranks]
        slow = max(r_["median_ms"] for r_ in rs)
        s = {"median_ms_by_rank": [r_["median_ms"] for r_ in rs],
             "wall_ms_by_rank": [r_["wall_ms"] for r_ in rs],
             "tokens_per_s": tokens / (slow / 1e3),
             "peak_gb_by_rank": [r_["peak_gb"] for r_ in rs],
             "syncs_per_step_by_rank": [r_["syncs_per_step"] for r_ in rs],
             "launches_per_step": rs[0]["launches_per_step"],
             "losses": rs[0]["losses"], "metrics": rs[0]["metrics"],
             "exchange_check": {k_: sum(r_["exchange_check"][k_]
                                        for r_ in rs)
                                for k_ in ("elements", "differ")}}
        summary["strategies"][strategy] = s
        print(f"(a) {strategy}, {DIST_RANKS} gloo ranks on the card, one "
              f"pod each: {slow:.1f} ms a step (the slower rank's median "
              f"of {DIST_STEPS}; by rank "
              f"{[round(x_, 1) for x_ in s['median_ms_by_rank']]}), "
              f"{s['tokens_per_s']:.0f} tokens/s, peak "
              f"{[round(x_, 2) for x_ in s['peak_gb_by_rank']]} GB a rank, "
              f"{s['syncs_per_step_by_rank']} host syncs a step (the calling "
              f"thread's; gloo stages CUDA tensors through the host on its "
              f"own threads), launches a step a rank {s['launches_per_step']}"
              f", losses {[round(x_, 4) for x_ in s['losses']]}", flush=True)
        ec = s["exchange_check"]
        print(f"(b) {strategy}: the two-rank exchange against the one-card "
              f"exchange on the same inputs (all-gathered), each rank its "
              f"rows: {ec['differ']} of {ec['elements']} entries differ",
              flush=True)
        for r_ in rs:
            assert r_["finite"] and np.all(np.isfinite(r_["losses"])), (
                strategy, r_["losses"])
            assert r_["launches_per_step"] == {
                "flash_attention": 2 * n_layers, **want_kernel[strategy]}, (
                strategy, r_["launches_per_step"])
        assert rs[0]["losses"] == rs[1]["losses"], (strategy, "loss")
        assert ec["elements"] > 0 and ec["differ"] == 0, (strategy, ec)
    for strategy, _ in TRAIN_RUNS:
        l2 = [c_[strategy]["vel_rel_l2"] for c_ in summary["cut_by_rank"]]
        worst = [(c_[strategy]["vel_worst"], c_[strategy]["worst_leaf"])
                 for c_ in summary["cut_by_rank"]]
        print(f"(c) {strategy}, float32 {DIST_CUT}-layer cut (TF32 off): the "
              f"two-rank step against the one-card step, each rank its rows: "
              f"the velocity's relative L2 difference {l2} (gate "
              f"{DIST_VEL_TOL}); the worst velocity leaf by rank (max |err| "
              f"over its largest entry, leaf) {worst}", flush=True)
        assert max(l2) <= DIST_VEL_TOL, (strategy, l2)
    t0 = time.perf_counter()
    nccl = procs.spawn(dist_nccl_rank, 1, backend="nccl", device=dev,
                       timeout=DIST_TIMEOUT)[0]
    summary["nccl"] = {**nccl, "spawn_s": time.perf_counter() - t0}
    for strategy, r_ in nccl["strategies"].items():
        print(f"(d) {strategy}, NCCL at world size 1 ({nccl['backend']}), "
              f"both pods on the rank, a bf16 {DIST_CUT}-layer cut: "
              f"{r_['median_ms']:.1f} ms a step, {r_['syncs_per_step']} host "
              f"syncs a step, launches {r_['launches_per_step']}, loss "
              f"{r_['loss']:.4f}", flush=True)
        assert nccl["backend"] == "nccl" and r_["syncs_per_step"] == 0, r_
        assert np.isfinite(r_["loss"]), r_
    for strategy, r_ in nccl["routes"].items():
        print(f"(d) {strategy}'s exchange on one card, qwen3-0.6b at full "
              f"width, both pods on the rank: the one-card route (fused "
              f"kernels) {r_['one_card_ms']:.4f} ms, the mesh route at world "
              f"size 1 {r_['mesh_ms']:.4f} ms "
              f"({r_['mesh_ms'] / r_['one_card_ms']:.2f}x); {r_['differ']} of "
              f"{r_['elements']} entries differ", flush=True)
        assert r_["differ"] == 0, (strategy, r_)
    kern = {}
    for name_, strat in (("gaia_select", "gaia"), ("dgc_sparsify", "dgc"),
                         ("neighbor_mix_src", "adpsgd"),
                         ("flash_attention", "bsp")):
        kern[name_] = {"dist_launches_per_step_a_rank": summary[
            "strategies"][strat]["launches_per_step"][name_]}
    kern["neighbor_mix_src"]["dist_dpsgd_launches_per_step_a_rank"] = \
        summary["strategies"]["dpsgd"]["launches_per_step"]["neighbor_mix_src"]
    kern["neighbor_mix_src"]["dist_src_many"] = mix_t
    summary["src_many"] = mix_t
    summary["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 12: {summary['wall_s']:.2f} s")
    return summary, kern


# ---------------------------------------------------------------------------
# Phase 13: the intra-pod axes
# ---------------------------------------------------------------------------

#: phase 13, a pod split over a data x model grid of ranks: eight gloo
#: ranks on the one card, mesh (pod, data, model) = (2, 2, 2), one CUDA
#: context each.  (a) a float32 INTRA_CUT-layer cut at full width, one
#: step of each strategy against the one-card step (relative L2 of the
#: gathered params and velocities within INTRA_L2_TOL; the exchange on the
#: one-card step's own inputs bit for bit), which rank 0 runs once and
#: every rank cuts its blocks of through CUDA IPC (each of the eight ranks
#: ran it in turn until phase 16 (d) and (e) needed the script's time);
#: (b) a cut of
#: INTRA_TIMED_LAYERS at full width, bf16, remat, INTRA_TIMED
#: strategies, 2 x 1024 tokens a pod, one warm-up and
#: INTRA_STEPS timed steps; (c) (b)'s bsp params saved on the mesh and
#: restored on one device
INTRA_MESH, INTRA_CUT, INTRA_L2_TOL = (2, 2, 2), 2, 1e-5
#: strategies whose exchange selects entries by a threshold: an entry at
#: it may fall either side where the sharded sums round otherwise, so
#: their state after the step is reported, and the step held by its
#: exchange's inputs (within INTRA_L2_TOL) and by the exchange on the
#: one-card inputs (bit for bit); the others by the state (bsp's inputs
#: are gradients, whose relative L2 is the rounding of their own sums)
INTRA_SELECTS = ("gaia", "dgc")
INTRA_TIMED = ("bsp", "dpsgd")
#: (b)'s depth at full width: 2 of qwen3-0.6b's 28 layers (full depth
#: until phase 14 needed the script's time, 7 until phase 15 did, 4 until
#: phase 16 (d) and (e) did; (a)'s float32 cut was 4 layers until phase
#: 15), and its timed steps after a warm-up (3 until phase 16 (d) and (e))
INTRA_TIMED_LAYERS, INTRA_STEPS = 2, 2
INTRA_TIMEOUT = 900


def _sha(t) -> str:
    """The SHA-256 of a tensor's bytes (bf16 as its 16-bit patterns)."""
    import hashlib
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def _intra_blocks(tree_leaves, specs, mesh, rows):
    """This rank's blocks of stacked one-card leaves: its pods' ``rows``
    and its ``data`` and ``model`` blocks (``specs``: the unstacked
    leaves'), contiguous copies."""
    from repro_torch.launch import sharding
    return [sharding.local_block(t_[rows], (None,) + tuple(s_), mesh)
            .contiguous() for t_, s_ in zip(tree_leaves, specs)]


def intra_rank(rank: int, dev: torch.device, ckpt_dir: str) -> dict:
    """One gloo rank of phase 13 (``procs.spawn``).  Returns host numbers;
    a failed check raises."""
    from repro_torch import checkpointing as ckpt
    from repro_torch import pytree
    from repro_torch.configs.base import CommConfig, FabricConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding
    from repro_torch.launch import steps as lsteps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as lm
    from repro_torch.topology.graphs import build_demo_schedule
    from torch.multiprocessing.reductions import reduce_tensor
    import torch.distributed as dist
    t_rank = time.perf_counter()
    cfg = get_config("qwen3-0.6b")
    mesh = make_mesh(INTRA_MESH, device=dev, cfg=cfg)
    world = dist.get_world_size()
    pods = lsteps.local_pods(TRAIN_PODS, mesh)
    rows = slice(pods.start, pods.stop)
    sched = build_demo_schedule("ring", TRAIN_PODS)
    batches = _dist_batches(dev, INTRA_STEPS + 1)
    out = {"rank": rank, "coords": mesh.coords, "cut": {}, "timed": {}}

    def comm_of(strategy):
        return CommConfig(strategy=strategy,
                          fabric=FabricConfig(topology="ring"),
                          **dict(TRAIN_RUNS)[strategy])

    def operands(comm, mesh_):
        if comm.strategy not in lsteps.GOSSIP_STRATEGIES:
            return {}
        return {"mix": lsteps.gossip_operands(
            sched, 0, device=dev, mesh=mesh_, **({
                "staleness": TRAIN_STALENESS,
                "max_staleness": comm.max_staleness}
                if comm.strategy == "adpsgd" else {}))}

    def recording(step):
        """``step`` with its exchange's (parts, kwargs, result) kept."""
        calls, ex = [], step.exchange

        def recorded(parts, **kw_):
            got_ = ex(parts, **kw_)
            calls.append((parts, kw_, got_))
            return got_
        step.exchange = recorded
        return calls

    # (a) a float32 cut at full width (TF32 off), one step each way
    cfg32 = dataclasses.replace(cfg, n_layers=INTRA_CUT, dtype="float32")
    p32 = lm.init_model(torch.Generator(device=dev).manual_seed(0), cfg32,
                        dev)
    specs = sharding.leaf_specs(p32, mesh)
    like = pytree.leaves(p32)
    with tf32_off():
        # every rank's first step at once, on the reduced config: the
        # kernels, handles and workspaces a process loads on its first
        # step would otherwise load in the one-card turns, one rank after
        # another
        small = dataclasses.replace(cfg32.reduced(), dtype="float32")
        lsteps.make_train_step(small, comm_of("bsp"), lr=TRAIN_LR,
                               remat=True)(
            lsteps.make_train_state(lm.init_model(
                torch.Generator(device=dev).manual_seed(0), small, dev),
                comm_of("bsp"), TRAIN_PODS),
            {k_: v_[..., :16] % small.vocab for k_, v_ in batches[0].items()},
            1)
        torch.cuda.synchronize()
        del small
        dist.barrier()
        for strategy, _ in TRAIN_RUNS:
            comm = comm_of(strategy)
            # the one-card step once, on rank 0: every rank cuts its
            # blocks of the new state and of the step's exchange (inputs
            # and result) from rank 0's tensors, mapped through CUDA IPC
            # (one handle set a receiving rank: PyTorch counts one release
            # a handle, and frees the memory once the count is back to 0)
            t_turns = time.perf_counter()
            box = [None]
            if rank == 0:
                step = lsteps.make_train_step(cfg32, comm, lr=TRAIN_LR,
                                              remat=True)
                calls = recording(step)
                new, _ = step(lsteps.make_train_state(p32, comm, TRAIN_PODS),
                              batches[0], 1, **operands(comm, None))
                (parts, kw_, got), = calls
                whole = ({k_: pytree.leaves(new[k_])
                          for k_ in ("params", "vel")}, parts, got)
                torch.cuda.empty_cache()    # the step's temporaries
                box = [(pytree.tree_map(lambda t_: 0, whole),
                        [[reduce_tensor(t_.detach())
                          for t_ in pytree.leaves(whole)]
                         for _ in range(world - 1)],
                        {k_: v_.cpu() if torch.is_tensor(v_) else v_
                         for k_, v_ in kw_.items() if k_ != "mix"})]
            dist.broadcast_object_list(box, src=0)
            like_whole, handles, kw_ = box[0]
            kw_ = {k_: v_.to(dev) if torch.is_tensor(v_) else v_
                   for k_, v_ in kw_.items()}
            if rank != 0:
                whole = pytree.unflatten(like_whole, [
                    fn_(*args_) for fn_, args_ in handles[rank - 1]])
            new_, parts_, got_ = whole
            for turn in range(world):   # one rank's cuts at a time
                if turn == rank:
                    want = {k_: _intra_blocks(new_[k_], specs, mesh, rows)
                            for k_ in ("params", "vel")}
                    ex_in = {k_: _intra_blocks(v_, specs, mesh, rows)
                             for k_, v_ in parts_.items() if k_ != "snaps"}
                    ex_out = {k_: _intra_blocks(v_, specs, mesh, rows)
                              for k_, v_ in got_.items() if k_ != "snaps"}
                    if "snaps" in parts_:
                        ex_in["snaps"] = _intra_snaps(parts_["snaps"], like,
                                                      specs, mesh, rows)
                        ex_out["snaps"] = _intra_snaps(got_["snaps"], like,
                                                       specs, mesh, rows)
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                dist.barrier()
            del whole, new_, parts_, got_, box, handles
            dist.barrier()      # no rank maps rank 0's tensors any more
            if rank == 0:
                # rank 0's blocks through the host while the step's
                # memory goes: a block kept on the card would pin the
                # segment it was cut from; the step refers to itself (its
                # closure reads ``train_step.exchange``), so only the
                # collector frees it and the recorded tensors
                want, ex_in, ex_out = pytree.tree_map(
                    lambda t_: t_.cpu(), (want, ex_in, ex_out))
                calls.clear()
                del step, calls, new, parts, got
                gc.collect()
                torch.cuda.ipc_collect()
                torch.cuda.empty_cache()
                want, ex_in, ex_out = pytree.tree_map(
                    lambda t_: t_.to(dev), (want, ex_in, ex_out))
            dist.barrier()      # rank 0's one-card memory given back
            if rank == 0:
                print(f"phase 13 rank 0: (a) {strategy} the one-card step "
                      f"{time.perf_counter() - t_turns:.1f} s", flush=True)
            # the mesh step on the same weights and batch
            for k_ in ops.launches:
                ops.launches[k_] = 0
            step = lsteps.make_train_step(cfg32, comm, mesh=mesh,
                                          lr=TRAIN_LR, remat=True)
            exchange = step.exchange
            calls = recording(step)
            kw_mesh = operands(comm, mesh)
            box = [lsteps.make_train_state(p32, comm, TRAIN_PODS, mesh=mesh)]
            syncs = count_syncs(lambda: box.append(step(
                box.pop(), batches[0], 1, **kw_mesh)))
            mine, _ = box[0]
            launches = {k_: c_ for k_, c_ in ops.launches.items() if c_}
            # the state after the step, and the exchange's inputs (what
            # the forward, backward and local step computed), each rank's
            # blocks against the one-card step's: sums of squares
            sums = {"state": _sq_diff(
                [t_ for k_ in ("params", "vel")
                 for t_ in pytree.leaves(mine[k_])],
                [t_ for k_ in ("params", "vel") for t_ in want[k_]]),
                "inputs": _sq_diff(pytree.leaves(calls[0][0]),
                                   pytree.leaves(ex_in))}
            calls.clear()
            del step, box, mine, want, calls
            gc.collect()
            torch.cuda.empty_cache()
            # the mesh exchange on the one-card step's own inputs
            got = exchange(ex_in, **{**kw_, **kw_mesh})
            n_el, differ = 0, 0
            for g_, w_ in zip(pytree.leaves(got), pytree.leaves(ex_out)):
                n_el += w_.numel()
                differ += _differ(g_.contiguous(), w_)
            out["cut"][strategy] = {
                "sums": sums, "syncs": syncs, "launches": launches,
                "elements": n_el, "differ": differ}
            del ex_in, ex_out, got, exchange
            gc.collect()
            torch.cuda.empty_cache()
            if rank == 0:
                print(f"phase 13 rank 0: (a) {strategy} done at "
                      f"{time.perf_counter() - t_rank:.1f} s", flush=True)
    del p32
    torch.cuda.empty_cache()

    # (b) a cut of INTRA_TIMED_LAYERS at full width, bf16, remat: timed
    # steps
    cfg = dataclasses.replace(cfg, n_layers=INTRA_TIMED_LAYERS)
    base = lm.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                         dev)
    for strategy in INTRA_TIMED:
        comm = comm_of(strategy)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step = lsteps.make_train_step(cfg, comm, mesh=mesh, lr=TRAIN_LR,
                                      remat=True)
        kw = operands(comm, mesh)
        box = [lsteps.make_train_state(base, comm, TRAIN_PODS, mesh=mesh),
               None]
        losses = []

        def one(i):
            box[0], box[1] = step(box[0], batches[i], i, **kw)
            losses.append(box[1]["loss"])
        one(0)
        torch.cuda.synchronize()
        for k_ in ops.launches:
            ops.launches[k_] = 0
        times, syncs, blocked = [], None, None
        for i in range(1, INTRA_STEPS + 1):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            if i == 1:              # the first timed step: its collectives
                with _timed_collectives() as blocked:
                    one(i)
            elif i < INTRA_STEPS:
                one(i)
            else:
                syncs = count_syncs(lambda: one(i))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        per_step = {k_: c_ / INTRA_STEPS for k_, c_ in ops.launches.items()
                    if c_}
        r = {"losses": [float(x_) for x_ in losses], "wall_ms": times,
             "median_ms": float(np.median(times)),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "syncs_per_step": syncs, "launches_per_step": per_step,
             "collectives": blocked,
             "finite": all(bool(torch.isfinite(t_).all())
                           for t_ in pytree.leaves(box[0]["params"]))}
        if strategy == "bsp":
            # (c) the params saved on the mesh, each rank's blocks
            # restored bit for bit and fingerprinted for the parent's
            # one-device restore
            state = box[0]["params"]
            pspecs = sharding.train_state_shardings(
                lsteps.train_state_shape(cfg, comm, TRAIN_PODS),
                mesh)["params"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.save(ckpt_dir, state, step=INTRA_STEPS, mesh=mesh,
                      specs=pspecs)
            r["save_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = ckpt.restore(ckpt_dir, pytree.tree_map(torch.empty_like,
                                                          state),
                                step=INTRA_STEPS, mesh=mesh, specs=pspecs)
            torch.cuda.synchronize()
            r["restore_s"] = time.perf_counter() - t0
            r["restored_equal"] = all(torch.equal(x_, y_) for x_, y_ in zip(
                pytree.leaves(back), pytree.leaves(state)))
            r["sha"] = [_sha(t_) for t_ in pytree.leaves(state)]
            del back, state
        out["timed"][strategy] = r
        del box, step
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:
            print(f"phase 13 rank 0: (b) {strategy} timed at "
                  f"{time.perf_counter() - t_rank:.1f} s", flush=True)
    return out


def _sq_diff(got, want):
    """(sum of squared differences, sum of squares of ``want``) over
    pairs of tensors, in float64, 2**24 entries at a time (eight ranks
    share the card)."""
    num, den = 0.0, 0.0
    for g_, w_ in zip(got, want, strict=True):
        for a_, b_ in zip(g_.reshape(-1).split(1 << 24),
                          w_.reshape(-1).split(1 << 24), strict=True):
            b_ = b_.double()
            num += float((a_.double() - b_).square().sum())
            den += float(b_.square().sum())
    return num, den


@contextlib.contextmanager
def _timed_collectives():
    """``torch.distributed``'s collectives wrapped for the block: a dict
    of the calls made (``calls``), the bytes of their input tensors
    (``bytes``) and the host's wall ms inside them (``ms``), summed over
    every thread (the backward's run on the autograd engine's), and the
    same three by collective (``by_name``).  Gloo returns from a call
    once its transfer is done, so ``ms`` is the time the rank waits on
    the wire and on its slower peers."""
    import threading
    import torch.distributed as dist
    out, lock, saved = {"calls": 0, "bytes": 0, "ms": 0.0, "by_name": {}}, \
        threading.Lock(), {}
    names = ("all_reduce", "all_gather_into_tensor", "all_gather_single",
             "reduce_scatter_tensor", "reduce_scatter_single",
             "all_to_all_single")
    for name_ in names:
        fn_ = getattr(dist, name_, None)
        if fn_ is None:
            continue
        saved[name_] = fn_

        def timed(*args, _fn=fn_, _name=name_, **kw):
            x_ = args[1] if len(args) > 1 and isinstance(
                args[1], torch.Tensor) else args[0]     # the input
            n_ = x_.numel() * x_.element_size()
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                ms_ = (time.perf_counter() - t0) * 1e3
                with lock:
                    out["calls"] += 1
                    out["bytes"] += n_
                    out["ms"] += ms_
                    e_ = out["by_name"].setdefault(
                        _name, {"calls": 0, "bytes": 0, "ms": 0.0})
                    e_["calls"] += 1
                    e_["bytes"] += n_
                    e_["ms"] += ms_
        setattr(dist, name_, timed)
    try:
        yield out
    finally:
        for name_, fn_ in saved.items():
            setattr(dist, name_, fn_)


def _intra_snaps(snaps, like, specs, mesh, rows):
    """This rank's layout of one-card snapshot buffers: each dtype
    group's (S + 1, n_pods, N) buffer cut back into the leaves ``like``
    (whole, unstacked), each leaf's pods and blocks taken, and laid side
    by side again (``steps.make_train_state``'s layout on a mesh)."""
    from repro_torch import pytree
    from repro_torch.launch import sharding
    from repro_torch.launch import steps as lsteps
    out = {}
    for dt_, idx in lsteps.dtype_groups(like).items():
        buf = snaps[pytree.dtype_name(dt_)][:, rows]
        parts = buf.split([like[i].numel() for i in idx], dim=2)
        out[pytree.dtype_name(dt_)] = torch.cat([
            sharding.local_block(p_.reshape(p_.shape[:2] + like[i].shape),
                                 (None, None) + tuple(specs[i]), mesh)
            .reshape(p_.shape[0], p_.shape[1], -1)
            for p_, i in zip(parts, idx)], dim=2)
    return out


def intra_phase(dev: torch.device):
    """Phase 13: the intra-pod axes.  The parent empties its CUDA cache,
    ``procs.spawn`` starts eight gloo ranks on the card (``intra_rank``),
    then the parent restores (c)'s checkpoint on the one device and
    checks each rank's blocks of it; every check is gated here.  Returns
    (summary, the kernels' phase 13 figures by kernel name)."""
    from repro_torch import checkpointing as ckpt
    from repro_torch import pytree
    from repro_torch.configs.base import CommConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import procs, sharding
    from repro_torch.launch import steps as lsteps
    from repro_torch.launch.mesh import AXES, Mesh
    import shutil
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("qwen3-0.6b"),
                              n_layers=INTRA_TIMED_LAYERS)
    ckpt_dir = str(ROOT / "build" / "intra_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    n_ranks = int(np.prod(INTRA_MESH))
    t0 = time.perf_counter()
    ranks = procs.spawn(intra_rank, n_ranks, backend="gloo", device=dev,
                        timeout=INTRA_TIMEOUT, args=(ckpt_dir,))
    summary = {"mesh": INTRA_MESH, "backend": "gloo",
               "spawn_s": time.perf_counter() - t0, "cut": {}, "timed": {}}
    # (a)
    n_sharded = 8               # embed, wq, wk, wv, wo, gate, up, down
    want_cut = {"bsp": {}, "fedavg": {}, "gaia": {"gaia_select": 1},
                "dgc": {"dgc_sparsify": 5, "abs_histogram": n_sharded,
                        "dgc_select": n_sharded},
                "dpsgd": {"neighbor_mix_src": 1},
                "adpsgd": {"neighbor_mix_src": 1}}
    for strategy, _ in TRAIN_RUNS:
        rs = [r_["cut"][strategy] for r_ in ranks]
        l2 = {k_: (sum(r_["sums"][k_][0] for r_ in rs) / max(sum(
            r_["sums"][k_][1] for r_ in rs), 1e-300)) ** 0.5
              for k_ in ("state", "inputs")}
        s = {"params_vel_rel_l2": l2["state"],
             "exchange_inputs_rel_l2": l2["inputs"],
             "syncs_by_rank": [r_["syncs"] for r_ in rs],
             "launches": rs[0]["launches"],
             "exchange_elements": sum(r_["elements"] for r_ in rs),
             "exchange_differ": sum(r_["differ"] for r_ in rs)}
        summary["cut"][strategy] = s
        print(f"(a) {strategy}, float32 {INTRA_CUT}-layer cut at full width "
              f"(TF32 off), mesh {INTRA_MESH} of gloo ranks on the card, "
              f"against the one-card step: the gathered params and "
              f"velocities, relative L2 {l2['state']:.3g}; the exchange's "
              f"inputs {l2['inputs']:.3g} (gate {INTRA_L2_TOL} on the "
              f"state, on the inputs where a selection decides: "
              f"{INTRA_SELECTS}); the exchange on the one-card step's "
              f"inputs: {s['exchange_differ']} of {s['exchange_elements']} "
              f"entries differ (gate: bit for bit); host syncs a step by rank "
              f"{s['syncs_by_rank']}; launches a rank {s['launches']}",
              flush=True)
        gated = "inputs" if strategy in INTRA_SELECTS else "state"
        assert l2[gated] <= INTRA_L2_TOL, (strategy, l2)
        assert s["exchange_elements"] > 0 and s["exchange_differ"] == 0, s
        assert all(x_ == 0 for x_ in s["syncs_by_rank"]), s
        for r_ in rs:
            assert r_["launches"] == {"flash_attention": 2 * INTRA_CUT,
                                      **want_cut[strategy]}, (strategy, r_)
    # (b)
    tokens = TRAIN_PODS * TRAIN_B * TRAIN_T
    for strategy in INTRA_TIMED:
        rs = [r_["timed"][strategy] for r_ in ranks]
        slow = max(r_["median_ms"] for r_ in rs)
        s = {"median_ms_by_rank": [r_["median_ms"] for r_ in rs],
             "wall_ms_by_rank": [r_["wall_ms"] for r_ in rs],
             "tokens_per_s": tokens / (slow / 1e3),
             "peak_gb_by_rank": [r_["peak_gb"] for r_ in rs],
             "syncs_per_step_by_rank": [r_["syncs_per_step"] for r_ in rs],
             "launches_per_step": rs[0]["launches_per_step"],
             "collectives_by_rank": [r_["collectives"] for r_ in rs],
             "losses": rs[0]["losses"]}
        summary["timed"][strategy] = s
        blocked = [c_["ms"] / r_["wall_ms"][0]
                   for c_, r_ in zip(s["collectives_by_rank"], rs)]
        c0 = s["collectives_by_rank"][0]
        print(f"(b) {strategy}: the first timed step's collectives, rank 0: "
              f"{c0['calls']} calls handed {c0['bytes'] / 1e9:.3f} GB, "
              f"{c0['ms']:.1f} ms of the host's wall inside them; the share "
              f"of the step's wall by rank "
              f"{[round(x_, 3) for x_ in blocked]}", flush=True)
        print(f"(b) {strategy}, {INTRA_TIMED_LAYERS} layers at full width, "
              f"bf16, remat, mesh {INTRA_MESH} "
              f"of gloo ranks on the card: {slow:.1f} ms a step (the slower "
              f"rank's median of {INTRA_STEPS}), {s['tokens_per_s']:.0f} "
              f"tokens/s, peak {max(s['peak_gb_by_rank']):.2f} GB a rank "
              f"(by rank {[round(x_, 2) for x_ in s['peak_gb_by_rank']]}), "
              f"{s['syncs_per_step_by_rank']} host syncs a step (the calling "
              f"thread's), launches a step a rank {s['launches_per_step']}, "
              f"losses {[round(x_, 4) for x_ in s['losses']]}", flush=True)
        want = {"flash_attention": 2 * cfg.n_layers}
        if strategy == "dpsgd":
            want["neighbor_mix_src"] = 2
        for r_ in rs:
            assert r_["finite"] and np.all(np.isfinite(r_["losses"])), r_
            assert r_["launches_per_step"] == want, (strategy, r_)
            assert r_["syncs_per_step"] == 0, (strategy, r_)
        assert len({tuple(r_["losses"]) for r_ in rs}) == 1, strategy
    # (c) the mesh's checkpoint restored on the one device: each rank's
    # blocks of it are that rank's state, bit for bit
    comm = CommConfig(strategy="bsp")
    like = pytree.tree_map(lambda t_: torch.empty(
        tuple(t_.shape), dtype=t_.dtype, device=dev),
        lsteps.train_state_shape(cfg, comm, TRAIN_PODS)["params"])
    t0 = time.perf_counter()
    whole = ckpt.restore(ckpt_dir, like, step=INTRA_STEPS)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    desc = Mesh(INTRA_MESH, AXES)
    specs = pytree.leaves_like(sharding.train_state_shardings(
        lsteps.train_state_shape(cfg, comm, TRAIN_PODS), desc)["params"],
        whole)
    equal = 0
    for r_ in ranks:
        desc.coords = dict(r_["coords"])
        shas = [_sha(sharding.local_block(t_, s_, desc))
                for t_, s_ in zip(pytree.leaves(whole), specs)]
        equal += shas == r_["timed"]["bsp"]["sha"]
    b = ranks[0]["timed"]["bsp"]
    summary["ckpt"] = {"bytes": sum(t_.numel() * t_.element_size()
                                    for t_ in pytree.leaves(whole)),
                       "save_s": b["save_s"], "mesh_restore_s":
                       b["restore_s"], "one_device_restore_s": restore_s,
                       "ranks_equal": equal,
                       "ranks_restore_equal": sum(
                           r_["timed"]["bsp"]["restored_equal"]
                           for r_ in ranks)}
    c = summary["ckpt"]
    print(f"(c) (b)'s bsp params ({c['bytes'] / 1e9:.3f} GB) saved on the "
          f"mesh in {c['save_s']:.2f} s, each rank's blocks restored on the "
          f"mesh in {c['mesh_restore_s']:.2f} s (equal on "
          f"{c['ranks_restore_equal']} of {n_ranks} ranks), restored on one "
          f"device in {restore_s:.2f} s: {equal} of {n_ranks} ranks' blocks "
          "of it equal the rank's state bit for bit", flush=True)
    assert equal == n_ranks and c["ranks_restore_equal"] == n_ranks, c
    del whole, like
    torch.cuda.empty_cache()
    kern = {
        "flash_attention": {
            "intra_launches_per_step_a_rank": summary["timed"]["bsp"][
                "launches_per_step"]["flash_attention"],
            "intra_cut_launches_a_rank": 2 * INTRA_CUT},
        "gaia_select": {"intra_cut_launches_a_rank": 1},
        "dgc_sparsify": {"intra_cut_launches_a_rank": 5},
        "abs_histogram": {"intra_cut_launches_a_rank": n_sharded},
        "dgc_select": {"intra_cut_launches_a_rank": n_sharded},
        "neighbor_mix_src": {
            "intra_launches_per_step_a_rank": summary["timed"]["dpsgd"][
                "launches_per_step"]["neighbor_mix_src"]}}
    summary["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 13: {summary['wall_s']:.2f} s")
    return summary, kern


# ---------------------------------------------------------------------------
# Phase 14: serving under a mesh
# ---------------------------------------------------------------------------

#: phase 14, the serve steps on a (1, D, M) mesh of gloo ranks sharing the
#: one card: each model's mesh
MESH_SHAPES = {"qwen3-0.6b": (1, 2, 2), "deepseek-v2-lite-16b": (1, 1, 4)}
#: 8 requests (the reference's batch_sharded rule: B >= 8), a 64-token
#: prompt fed through the serve step, 31 generated, 128 slots
MESH_B, MESH_PROMPT, MESH_GEN, MESH_CACHE = 8, 64, 31, SERVE_CACHE
#: (a)'s float32 parity (TF32 off): deepseek-v2-lite-16b on a MESH_CUT-layer
#: cut (1 dense and 3 MoE layers) over its first MESH_DS_F32_STEPS decode
#: steps under the flash-decode placement and its first MESH_BASE_STEPS
#: under the heads placement; qwen3-0.6b at full depth over its first
#: MESH_QWEN_F32_STEPS
#: steps under each (a float32 decode step on (1, 2, 2) gathers half the
#: weights over data through gloo's host staging: ~2.5 s).  Every logit
#: row within MESH_F32_TOL relative L2 of the one-card serve, or within
#: MESH_WITNESS_X times the model's own rounding floor where that is
#: higher: the largest row distance of the one-card serve with every
#: weight moved by a relative 2**-24 normal (two draws), which at these
#: depths and 2048 positions lies above 1e-5 (PERF.md, PR 25)
MESH_CUT, MESH_QWEN_F32_STEPS, MESH_BASE_STEPS = 4, 4, 16
#: the deepseek cut's decode steps under the flash-decode placement (all
#: 95 of the prompt and the generated tokens until phase 15 needed the
#: script's time; 8 qwen3 steps and 32 deepseek steps under the heads
#: placement until then)
MESH_DS_F32_STEPS = 32
#: (b)'s deepseek-v2-lite-16b depth: 3 of its 27 layers (1 dense, 2 MoE,
#: phase 15 (c)'s cut; full depth until phase 15 needed the script's time,
#: 14 until phase 16 (d) and (e) did)
MESH_DS_LAYERS = 3
#: (b)'s qwen3-0.6b depth: 4 of its 28 layers (full depth until phase 16
#: (d) and (e) needed the script's time); its bf16 rule holds the mesh's
#: logits against the one-card bf16 and float32 serves of the same cut
MESH_QWEN_LAYERS = 4
MESH_F32_TOL, MESH_WITNESS_X = 1e-5, 1.25
#: the EP route's decode steps in (a): the dense route's function at one
#: token a step (the reference's rule), run to show the route takes it
MESH_EP_STEPS = 8
#: (b)'s timing: one warm-up call or step, then MESH_TIMED timed (3 until
#: phase 16 (d) and (e) needed the script's time)
MESH_TIMED = 2
MESH_TIMEOUT = 900
#: flash_attention at each rank's prefill shape: (B, T, Hq, Hkv, Dk, Dv)
MESH_FA_SHAPES = {"qwen3-0.6b": (2, PREFILL_T, 8, 4, 128, 128),
                  "deepseek-v2-lite-16b": (PREFILL_B, PREFILL_T, 4, 4, 192,
                                           128)}


def _mesh_tokens(vocab):
    """(the prefill's PREFILL_B x PREFILL_T prompts, the decode's MESH_B x
    MESH_PROMPT prompts), from seeds 140 and 141."""
    return (torch.from_numpy(np.random.default_rng(140).integers(
        0, vocab, (PREFILL_B, PREFILL_T))),
            torch.from_numpy(np.random.default_rng(141).integers(
                0, vocab, (MESH_B, MESH_PROMPT))))


def _decode_batch(fed, t, dev):
    return {"token": fed[:, t].to(dev),
            "t": torch.full((fed.shape[0],), t, dtype=torch.int32,
                            device=dev)}


def _one_card_serve(cfg, params, dev, n_steps, fed=None):
    """The one-card serve of ``params``: (the prefill's next-token logits
    (PREFILL_B, V), each decode step's logits (n_steps, MESH_B, V), the
    tokens fed (MESH_B, n_steps): the prompt, then the greedy tokens of
    the step before, unless ``fed`` gives them), float32 on the host."""
    from repro_torch.launch import steps as lsteps
    from repro_torch.models import model as lm
    pre_tok, prompt = _mesh_tokens(cfg.vocab)
    with torch.inference_mode():
        pre = lsteps.make_prefill_step(cfg)(params,
                                            {"tokens": pre_tok.to(dev)})
        cache = lm.init_cache(cfg, MESH_B, MESH_CACHE, device=dev)
        step = lsteps.make_serve_step(cfg)
        toks = torch.zeros(MESH_B, n_steps, dtype=torch.long)
        out = []
        for t in range(n_steps):
            if fed is not None:
                toks[:, t] = fed[:, t]
            elif t < MESH_PROMPT:
                toks[:, t] = prompt[:, t]
            else:
                toks[:, t] = out[-1].argmax(dim=-1)
            logits, cache = step.logits(params, cache,
                                        _decode_batch(toks, t, dev))
            out.append(logits.float().cpu())
    return pre.float().cpu(), torch.stack(out), toks


def _rounding_witness(cfg, params, dev, n_steps, fed, pre, dec):
    """How far the model carries differences of rounding size: the
    one-card float32 serve of ``params`` with every float weight moved by
    a relative 2**-24 normal (float32's half ulp), against the unmoved
    serve's ``pre`` and ``dec``: the largest logit row's relative L2 at
    prefill and over the decode steps, the larger of two draws."""
    from repro_torch import pytree
    out = {"prefill": 0.0, "decode": 0.0}
    for seed in (7, 8):
        gen = torch.Generator(device=dev).manual_seed(seed)
        moved = pytree.tree_map(lambda t_: t_ * (1 + 2 ** -24 * torch.randn(
            t_.shape, generator=gen, device=dev)) if t_.is_floating_point()
            else t_, params)
        pre_w, dec_w, _ = _one_card_serve(cfg, moved, dev, n_steps, fed)
        del moved
        out = {"prefill": max(out["prefill"], _row_rel(pre_w, pre)),
               "decode": max(out["decode"], _row_rel(dec_w, dec))}
    return out


def _row_rel(got, want):
    """The largest relative L2 difference of a logit row (last dim)."""
    d = (got.double() - want.double()).square().sum(-1).sqrt()
    n = want.double().square().sum(-1).sqrt().clamp_min(1e-300)
    return float((d / n).max())


def _sq(got, want):
    """(sum of squared differences, sum of squares of ``want``)."""
    g, w = got.double(), want.double()
    return float((g - w).square().sum()), float(w.square().sum())


def serve_mesh_rank(rank: int, dev: torch.device, ref_path: str) -> dict:
    """One gloo rank of phase 14 (``procs.spawn``): (a) float32 parity
    against the one-card serve of the parent (``ref_path``), (b) bf16 at
    full width (deepseek on a depth cut), timed.  Returns host numbers."""
    from repro_torch import pytree
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding
    from repro_torch.launch import steps as lsteps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.shard_hints import activation_sharding
    import torch.distributed as dist
    t_rank = time.perf_counter()
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    world = dist.get_world_size()
    out = {"rank": rank}

    def blocks(cfg_, mesh_):
        """This rank's blocks of the model drawn from seed 0, the ranks
        drawing the whole model in turns (kept: clones of the blocks)."""
        kept = None
        for turn in range(world):
            if turn == rank:
                whole = lm.init_model(torch.Generator(device=dev)
                                      .manual_seed(0), cfg_, dev)
                kept = pytree.tree_map(lambda t_: t_.clone(),
                                       sharding.local_params(whole, mesh_))
                del whole
                torch.cuda.empty_cache()
            mesh_.barrier()
        return kept

    def rows_of(t_, mesh_):
        """This rank's rows of a (B, ...) or (S, B, ...) host tensor."""
        D, i = mesh_.size_of("data"), mesh_.coords["data"]
        n = t_.shape[-2] // D
        return t_.narrow(t_.dim() - 2, i * n, n).to(dev)

    def timed(fn, mesh_):
        """MESH_TIMED timed calls of ``fn`` with no warm-up apart: their
        median leaves a slow first call (cuBLAS, the allocator) out."""
        torch.cuda.synchronize()
        for k_ in ops.launches:
            ops.launches[k_] = 0
        times, res = [], None
        for _ in range(MESH_TIMED):
            torch.cuda.synchronize()
            mesh_.barrier()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return res, times, {k_: c_ / MESH_TIMED
                            for k_, c_ in ops.launches.items() if c_}

    def parity(cfg_, mesh_, params, key, placements, routes):
        """(a): the prefill's rows and every decode step's rows against the
        one-card float32 logits: the largest row's relative L2.
        ``placements``: (moe route, batch_sharded, baseline_decode, decode
        steps) of each decode loop."""
        pre_tok, _ = _mesh_tokens(cfg_.vocab)
        fed = ref[key + "/fed"]
        res = {}
        with torch.inference_mode():
            for route in routes:
                pre = lsteps.make_prefill_step(cfg_, mesh=mesh_,
                                               moe_route=route)(
                    params, {"tokens": pre_tok.to(dev)})
                res[f"prefill_{route}"] = _row_rel(
                    pre, rows_of(ref[key + "/prefill"], mesh_))
            for route, bs, base, n_steps in placements:
                cache = lm.init_cache(cfg_, MESH_B, MESH_CACHE, device=dev,
                                      mesh=mesh_, batch_sharded=bs,
                                      baseline_decode=base)
                step = lsteps.make_serve_step(cfg_, mesh=mesh_,
                                              moe_route=route,
                                              batch_sharded=bs,
                                              baseline_decode=base)
                worst = 0.0
                for t in range(n_steps):
                    logits, cache = step.logits(params, cache,
                                                _decode_batch(fed, t, dev))
                    worst = max(worst, _row_rel(
                        logits, rows_of(ref[key + "/decode"][t], mesh_)))
                res[f"decode_{route}_bs{int(bs)}_base{int(base)}"] = worst
                res[f"steps_{route}_bs{int(bs)}_base{int(base)}"] = n_steps
                del cache
        return res

    def full(cfg_, mesh_, params, key, routes):
        """(b): timed prefill calls and decode steps, their launches, host
        syncs and collectives, and their logits against the one-card
        ones (sums of squares; greedy agreement)."""
        pre_tok, _ = _mesh_tokens(cfg_.vocab)
        fed = ref[key + "/fed"]
        res = {}
        with torch.inference_mode():
            for route in routes:
                prefill = lsteps.make_prefill_step(cfg_, mesh=mesh_,
                                                   moe_route=route)
                batch = {"tokens": pre_tok.to(dev)}
                pre, times, launches = timed(lambda: prefill(params, batch),
                                             mesh_)
                r = {"prefill_ms": times, "prefill_launches": launches,
                     "prefill_finite": bool(torch.isfinite(pre).all())}
                for what in ("bf16", "f32"):
                    want = rows_of(ref[f"{key}/prefill_{what}"], mesh_)
                    r[f"prefill_sq_{what}"] = _sq(pre, want)
                r["prefill_agree_bf16"] = [int((pre.argmax(-1) == rows_of(
                    ref[f"{key}/prefill_bf16"], mesh_).argmax(-1)).sum()),
                    pre.shape[0]]
                res[route] = r
            route = routes[0]
            cache = lm.init_cache(cfg_, MESH_B, MESH_CACHE, device=dev,
                                  mesh=mesh_)
            step = lsteps.make_serve_step(cfg_, mesh=mesh_, moe_route=route)
            r = res[route]
            r.update(decode_ms=[], decode_sq_bf16=[0.0, 0.0],
                     decode_sq_f32=[0.0, 0.0], decode_agree_bf16=[0, 0])
            for t in range(MESH_TIMED + 1):
                batch = _decode_batch(fed, t, dev)
                if t == 1:
                    for k_ in ops.launches:
                        ops.launches[k_] = 0
                torch.cuda.synchronize()
                mesh_.barrier()
                t0 = time.perf_counter()
                if t == 1:
                    with _timed_collectives() as coll_:
                        tok, cache = step(params, cache, batch)
                elif t == MESH_TIMED:
                    box = []
                    r["decode_syncs"] = count_syncs(lambda: box.append(
                        step(params, cache, batch)))
                    tok, cache = box[0]
                else:
                    tok, cache = step(params, cache, batch)
                torch.cuda.synchronize()
                if t:
                    r["decode_ms"].append((time.perf_counter() - t0) * 1e3)
                # the step's logits for the comparison: the same step
                # again, which writes the same entries to the same slots
                logits, cache = step.logits(params, cache, batch)
                for what in ("bf16", "f32"):
                    want = rows_of(ref[f"{key}/decode_{what}"][t], mesh_)
                    a_, b_ = _sq(logits, want)
                    r[f"decode_sq_{what}"][0] += a_
                    r[f"decode_sq_{what}"][1] += b_
                r["decode_agree_bf16"][0] += int((logits.argmax(-1) == rows_of(
                    ref[f"{key}/decode_bf16"][t], mesh_).argmax(-1)).sum())
                r["decode_agree_bf16"][1] += logits.shape[0]
                r["decode_tokens_in_range"] = bool(
                    (tok >= 0).all() and (tok < cfg_.vocab).all())
            r["decode_launches"] = {k_: c_ for k_, c_ in
                                    ops.launches.items() if c_}
            r["decode_collectives"] = coll_
            del cache
        return res

    walls, last = {}, [time.perf_counter()]

    def mark(label):
        """The wall since the last mark, under ``label`` (rank 0 prints)."""
        now = time.perf_counter()
        walls[label] = now - last[0]
        last[0] = now
        if rank == 0:
            print(f"phase 14 rank 0: {label} {walls[label]:.1f} s (at "
                  f"{now - t_rank:.1f} s)", flush=True)

    # qwen3-0.6b over (1, 2, 2)
    qcfg = get_config("qwen3-0.6b")
    mesh = make_mesh(MESH_SHAPES["qwen3-0.6b"], device=dev, cfg=qcfg,
                     mode="serve")
    out["qwen3_coords"] = mesh.coords
    q32 = dataclasses.replace(qcfg, dtype="float32")
    mark("start")
    with tf32_off():
        params = blocks(q32, mesh)
        mark("(a) qwen3 float32 draw")
        out["qwen3_f32"] = parity(
            q32, mesh, params, "qwen3_f32",
            (("dense", True, False, MESH_QWEN_F32_STEPS),
             ("dense", True, True, MESH_QWEN_F32_STEPS)), ("dense",))
    del params
    torch.cuda.empty_cache()
    mark("(a) qwen3 float32 prefill and decode")
    qcut = dataclasses.replace(qcfg, n_layers=MESH_QWEN_LAYERS)
    params = blocks(qcut, mesh)
    mark("(b) qwen3 bf16 draw")
    torch.cuda.reset_peak_memory_stats()
    out["qwen3_bf16"] = full(qcut, mesh, params, "qwen3", ("dense",))
    out["qwen3_bf16"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()
    mark("(b) qwen3 bf16 prefill and decode")

    # deepseek-v2-lite-16b over (1, 1, 4)
    dcfg = get_config("deepseek-v2-lite-16b")
    mesh = make_mesh(MESH_SHAPES["deepseek-v2-lite-16b"], device=dev,
                     cfg=dcfg, mode="serve")
    out["deepseek_coords"] = mesh.coords
    cut = dataclasses.replace(dcfg, n_layers=MESH_CUT, dtype="float32")
    with tf32_off():
        params = blocks(cut, mesh)
        mark("(a) deepseek float32 cut draw")
        out["deepseek_f32"] = parity(
            cut, mesh, params, "deepseek_f32",
            (("dense", True, False, MESH_DS_F32_STEPS),
             ("dense", True, True, MESH_BASE_STEPS),
             ("ep", True, False, MESH_EP_STEPS)), moe_mod.ROUTES)
        # the EP route's first MoE layer on the one-card run's own input,
        # against moe_apply_ep_ref (and the shared experts) there
        x = ref["deepseek_f32/ep_x"].to(dev)
        with torch.inference_mode(), activation_sharding(mesh):
            y, aux = moe_mod.moe_apply(pytree_first_moe(params), cut.moe, x,
                                       "ep")
        y_ref = ref["deepseek_f32/ep_y"].to(dev)
        num, den = _sq(y, y_ref)
        out["deepseek_f32"]["ep_layer_rel_l2"] = (num / max(den, 1e-300)
                                                  ) ** 0.5
        out["deepseek_f32"]["ep_layer_aux"] = (
            float(aux), float(ref["deepseek_f32/ep_aux"]))
        del x, y, y_ref
    del params
    torch.cuda.empty_cache()
    mark("(a) deepseek float32 cut prefill and decode")
    dcut = dataclasses.replace(dcfg, n_layers=MESH_DS_LAYERS)
    params = blocks(dcut, mesh)
    mark("(b) deepseek bf16 draw in turns")
    torch.cuda.reset_peak_memory_stats()
    out["deepseek_bf16"] = full(dcut, mesh, params, "deepseek",
                                moe_mod.ROUTES)
    out["deepseek_bf16"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()
    mark("(b) deepseek bf16 prefill and decode")
    out["walls_s"] = walls
    return out


def serve_mesh_nccl_rank(rank: int, dev: torch.device) -> dict:
    """Phase 14 (c): the serve steps on a world-size-1 NCCL mesh (a
    qwen3-0.6b bf16 2-layer cut): the logits against the steps without a
    mesh, bit for bit, ms a decode step and its host syncs."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps as lsteps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as lm
    import torch.distributed as dist
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2)
    mesh = make_mesh((1, 1, 1), device=dev, cfg=cfg, mode="serve")
    params = lm.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                           dev)
    pre_tok, prompt = _mesh_tokens(cfg.vocab)
    with torch.inference_mode():
        pre = lsteps.make_prefill_step(cfg, mesh=mesh)(
            params, {"tokens": pre_tok.to(dev)})
        pre1 = lsteps.make_prefill_step(cfg)(params,
                                             {"tokens": pre_tok.to(dev)})
        caches = [lm.init_cache(cfg, MESH_B, MESH_CACHE, device=dev,
                                mesh=mesh),
                  lm.init_cache(cfg, MESH_B, MESH_CACHE, device=dev)]
        step = lsteps.make_serve_step(cfg, mesh=mesh)
        step1 = lsteps.make_serve_step(cfg)
        same, times, syncs = torch.equal(pre, pre1), [], None
        for t in range(MESH_TIMED + 1):
            batch = _decode_batch(prompt, t, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if t == MESH_TIMED:
                box = []
                syncs = count_syncs(lambda: box.append(
                    step(params, caches[0], batch)))
                tok, caches[0] = box[0]
            else:
                tok, caches[0] = step(params, caches[0], batch)
            torch.cuda.synchronize()
            if t:
                times.append((time.perf_counter() - t0) * 1e3)
            tok1, caches[1] = step1(params, caches[1], batch)
            same = same and torch.equal(tok, tok1)
    return {"backend": dist.get_backend(), "same": same, "syncs": syncs,
            "decode_ms": times}


def serve_mesh_phase(dev: torch.device):
    """Phase 14: serving under a mesh.  The parent checks the kernel at
    the ranks' prefill shapes, runs the one-card serves the ranks are
    held against (float32 and bf16; each model freed before the next),
    saves their logits, then ``procs.spawn`` starts four gloo ranks on
    the card (``serve_mesh_rank``) and one NCCL rank
    (``serve_mesh_nccl_rank``); every check is gated here.  Returns
    (summary, the kernels' phase 14 figures by kernel name)."""
    import shutil
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops, ref as kref
    from repro_torch.launch import procs
    from repro_torch.models import model as lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import moe_ep
    from repro_torch.models.layers import gated_mlp_apply
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    summary = {"parent_allocated_gb": torch.cuda.memory_allocated() / 1e9,
               "fa": {}}
    failures = []

    def check(ok, what):
        """A failed gate, kept so that every number is printed first."""
        if not ok:
            failures.append(what)
            print(f"phase 14 FAILED: {what}", flush=True)
    # the kernel at each rank's prefill shape against its plain version
    gen = torch.Generator(device=dev).manual_seed(14)
    for arch, (b_, t_, hq, hkv, dk, dv) in MESH_FA_SHAPES.items():
        q = torch.randn(b_, t_, hq, dk, generator=gen, device=dev).to(
            torch.bfloat16)
        k = torch.randn(b_, t_, hkv, dk, generator=gen, device=dev).to(
            torch.bfloat16)
        v = torch.randn(b_, t_, hkv, dv, generator=gen, device=dev).to(
            torch.bfloat16)
        scale = (192 ** -0.5) if dk == 192 else None
        got = ops.flash_attention_bthd(q, k, v, causal=True, scale=scale)
        want = kref.flash_attention_bthd_ref(q, k, v, causal=True,
                                             scale=scale)
        err = (got.float() - want.float()).abs()
        summary["fa"][arch] = {"shape": [b_, t_, hq, hkv, dk, dv],
                               "max_abs_err": float(err.max()),
                               "mean_abs_err": float(err.mean())}
        print(f"flash_attention at {arch}'s rank prefill shape (B {b_}, T "
              f"{t_}, {hq} over {hkv} heads, (Dk, Dv) = ({dk}, {dv})), bf16 "
              f"causal, against the plain version: max |err| "
              f"{summary['fa'][arch]['max_abs_err']:.3g} (tol "
              f"{FA_PREFILL_TOL}), mean {summary['fa'][arch]['mean_abs_err']:.3g}"
              f" (tol {FA_PREFILL_MEAN_TOL})", flush=True)
        assert summary["fa"][arch]["max_abs_err"] <= FA_PREFILL_TOL
        assert summary["fa"][arch]["mean_abs_err"] <= FA_PREFILL_MEAN_TOL
        del q, k, v, got, want, err

    # the one-card serves
    saved = {}
    t0 = time.perf_counter()
    qcfg = get_config("qwen3-0.6b")
    with tf32_off():
        p = lm.init_model(torch.Generator(device=dev).manual_seed(0),
                          dataclasses.replace(qcfg, dtype="float32"), dev)
        q32 = dataclasses.replace(qcfg, dtype="float32")
        n_q = max(MESH_QWEN_F32_STEPS, MESH_TIMED + 1)
        pre, dec, fed = _one_card_serve(q32, p, dev, n_q)
        witness = {"qwen3_f32": _rounding_witness(q32, p, dev, n_q, fed, pre,
                                                  dec)}
    saved.update({"qwen3_f32/prefill": pre, "qwen3_f32/decode": dec,
                  "qwen3_f32/fed": fed, "qwen3/fed": fed})
    del p
    torch.cuda.empty_cache()
    # (b)'s cut, float32 (TF32 off) and bf16
    qcut = dataclasses.replace(qcfg, n_layers=MESH_QWEN_LAYERS)
    for dt_, tf32 in (("float32", tf32_off), ("bf16", contextlib.nullcontext)):
        cut_ = (dataclasses.replace(qcut, dtype="float32")
                if dt_ == "float32" else qcut)
        with tf32():
            p = lm.init_model(torch.Generator(device=dev).manual_seed(0),
                              cut_, dev)
            pre, dec, _ = _one_card_serve(cut_, p, dev, MESH_TIMED + 1, fed)
        key = "f32" if dt_ == "float32" else "bf16"
        saved.update({f"qwen3/prefill_{key}": pre,
                      f"qwen3/decode_{key}": dec})
        del p
        torch.cuda.empty_cache()
    dcfg = get_config("deepseek-v2-lite-16b")
    cut = dataclasses.replace(dcfg, n_layers=MESH_CUT, dtype="float32")
    D, M = MESH_SHAPES["deepseek-v2-lite-16b"][1:]
    with tf32_off():
        p = lm.init_model(torch.Generator(device=dev).manual_seed(0), cut,
                          dev)
        seen = []
        dense = moe_mod.moe_apply

        def record(p_, m_, x_, route="dense"):
            if not seen:
                seen.append(x_.clone())
            return dense(p_, m_, x_, route)
        with swapped(moe_mod, "moe_apply", record):
            pre, dec, fed = _one_card_serve(cut, p, dev, MESH_DS_F32_STEPS)
        witness["deepseek_f32"] = _rounding_witness(
            cut, p, dev, MESH_DS_F32_STEPS, fed, pre, dec)
        ffn = pytree_first_moe(p)
        with torch.inference_mode():
            y, aux = moe_ep.moe_apply_ep_ref(ffn, cut.moe, seen[0], D, M)
            y = y + gated_mlp_apply(ffn["shared"], seen[0])
    saved.update({"deepseek_f32/prefill": pre, "deepseek_f32/decode": dec,
                  "deepseek_f32/fed": fed, "deepseek/fed": fed,
                  "deepseek/prefill_f32": pre,
                  "deepseek/decode_f32": dec[:MESH_TIMED + 1],
                  "deepseek_f32/ep_x": seen[0].cpu(),
                  "deepseek_f32/ep_y": y.cpu(),
                  "deepseek_f32/ep_aux": aux.cpu()})
    del p, seen, y, ffn
    torch.cuda.empty_cache()
    dcut = dataclasses.replace(dcfg, n_layers=MESH_DS_LAYERS)
    p = lm.init_model(torch.Generator(device=dev).manual_seed(0), dcut, dev)
    pre, dec, _ = _one_card_serve(dcut, p, dev, MESH_TIMED + 1, fed)
    saved.update({"deepseek/prefill_bf16": pre, "deepseek/decode_bf16": dec})
    # the cut's float32 logits are not the full model's: (b)'s deepseek
    # distances are taken to the one-card bf16 run only
    del p
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    summary["one_card_s"] = time.perf_counter() - t0
    summary["rounding_witness"] = witness
    mesh_dir = ROOT / "build" / "serve_mesh"
    shutil.rmtree(mesh_dir, ignore_errors=True)
    mesh_dir.mkdir(parents=True)
    ref_path = str(mesh_dir / "one_card.pt")
    torch.save({k_: v_.contiguous() for k_, v_ in saved.items()}, ref_path)
    # the one-card bf16 logits' distance to the float32 ones (qwen3): the
    # 1.25x rule's yardstick
    one_sq = {w_: _sq(saved[f"qwen3/{w_}_bf16"], saved[f"qwen3/{w_}_f32"])
              for w_ in ("prefill", "decode")}
    del saved
    print(f"phase 14: the one-card serves in {summary['one_card_s']:.1f} s",
          flush=True)

    t0 = time.perf_counter()
    ranks = procs.spawn(serve_mesh_rank, 4, backend="gloo", device=dev,
                        timeout=MESH_TIMEOUT, args=(ref_path,))
    summary["spawn_s"] = time.perf_counter() - t0
    # (a) float32 parity
    for key, arch in (("qwen3_f32", "qwen3-0.6b"),
                      ("deepseek_f32", "deepseek-v2-lite-16b")):
        worst = {k_: max(r_[key][k_] for r_ in ranks)
                 for k_ in ranks[0][key] if k_.startswith(("prefill",
                                                             "decode"))}
        summary[key + "_steps"] = {k_: v_ for k_, v_ in ranks[0][key].items()
                                   if k_.startswith("steps")}
        summary[key] = worst
        print(f"(a) {arch}, float32 ({'full depth' if arch == 'qwen3-0.6b' else f'{MESH_CUT}-layer cut'}, "
              f"TF32 off) on {MESH_SHAPES[arch]} against the one-card serve: "
              f"the largest logit row's relative L2 over the ranks, prefill "
              f"{PREFILL_B} x {PREFILL_T} and teacher-forced decode steps of "
              f"{MESH_B} requests ({summary[key + '_steps']}): "
              + json.dumps({k_: float(f"{v_:.3g}") for k_, v_ in
                            worst.items()})
              + "; the EP route's prefill is another function "
              "(reported); the rounding floor, the one-card serve with "
              "every weight moved by a relative 2**-24 normal, against the "
              "unmoved one (the larger of two draws): "
              + json.dumps({k_: float(f"{v_:.3g}") for k_, v_ in
                            witness[key].items()}), flush=True)
        gates = {k_: max(MESH_F32_TOL, MESH_WITNESS_X * witness[key][
            k_.split("_")[0]]) for k_ in worst if k_ != "prefill_ep"}
        summary[key + "_gates"] = gates
        print(f"(a) {arch}: the gates, each max({MESH_F32_TOL}, "
              f"{MESH_WITNESS_X} x the rounding floor): "
              + json.dumps({k_: float(f"{v_:.3g}") for k_, v_ in
                            gates.items()}), flush=True)
        for k_, g_ in gates.items():
            check(worst[k_] <= g_, (arch, k_, worst[k_], g_))
    ep_l2 = max(r_["deepseek_f32"]["ep_layer_rel_l2"] for r_ in ranks)
    aux = ranks[0]["deepseek_f32"]["ep_layer_aux"]
    summary["deepseek_f32"]["ep_layer_rel_l2"] = ep_l2
    summary["deepseek_f32"]["ep_layer_aux"] = aux
    print(f"(a) the EP route's first MoE layer on the one-card run's input "
          f"({PREFILL_B} x {PREFILL_T} tokens, float32): against "
          f"moe_apply_ep_ref, relative L2 "
          f"{ep_l2:.3g} (gate {MESH_F32_TOL}); aux {aux[0]:.6g} against "
          f"{aux[1]:.6g}", flush=True)
    check(ep_l2 <= MESH_F32_TOL and abs(aux[0] - aux[1]) <=
          MESH_F32_TOL * abs(aux[1]), ("ep layer", ep_l2, aux))
    # (b) bf16 at full width, qwen3 and deepseek cut
    kern_launches = {}
    for key, arch in (("qwen3_bf16", "qwen3-0.6b"),
                      ("deepseek_bf16", "deepseek-v2-lite-16b")):
        cfg_ = dataclasses.replace(get_config(arch), n_layers=(
            MESH_QWEN_LAYERS if arch == "qwen3-0.6b" else MESH_DS_LAYERS))
        s = {"peak_gb_by_rank": [r_[key]["peak_gb"] for r_ in ranks]}
        for route, r0 in ranks[0][key].items():
            if not isinstance(r0, dict):
                continue
            rs = [r_[key][route] for r_ in ranks]
            pre_ms = max(float(np.median(r_["prefill_ms"])) for r_ in rs)
            sq = {w_: [sum(r_[f"prefill_sq_{w_}"][j] for r_ in rs)
                       for j in (0, 1)] for w_ in ("bf16", "f32")}
            e = {"prefill_ms": pre_ms,
                 "prefill_tokens_per_s": PREFILL_B * PREFILL_T / (
                     pre_ms / 1e3),
                 "prefill_launches_a_rank": r0["prefill_launches"],
                 "prefill_rel_l2_to_one_card_bf16": (
                     sq["bf16"][0] / sq["bf16"][1]) ** 0.5,
                 "prefill_rel_l2_to_one_card_f32": (
                     sq["f32"][0] / sq["f32"][1]) ** 0.5,
                 "prefill_greedy_agree_bf16": sum(
                     r_["prefill_agree_bf16"][0] for r_ in rs) / sum(
                     r_["prefill_agree_bf16"][1] for r_ in rs)}
            for r_ in rs:
                check(r_["prefill_finite"], (arch, route, "finite"))
                check(r_["prefill_launches"] == {
                    "flash_attention": cfg_.n_layers}, (arch, route, r_[
                        "prefill_launches"]))
            kern_launches[f"{arch} {route}"] = r0["prefill_launches"][
                "flash_attention"]
            if "decode_ms" in r0:
                dec_ms = max(float(np.median(r_["decode_ms"])) for r_ in rs)
                dsq = {w_: [sum(r_[f"decode_sq_{w_}"][j] for r_ in rs)
                            for j in (0, 1)] for w_ in ("bf16", "f32")}
                e.update({
                    "decode_ms": dec_ms,
                    "decode_tokens_per_s": MESH_B / (dec_ms / 1e3),
                    "decode_ms_by_rank": [r_["decode_ms"] for r_ in rs],
                    "decode_syncs_by_rank": [r_["decode_syncs"] for r_ in rs],
                    "decode_launches_a_rank": r0["decode_launches"],
                    "decode_collectives_by_rank": [r_["decode_collectives"]
                                                   for r_ in rs],
                    "decode_rel_l2_to_one_card_bf16": (
                        dsq["bf16"][0] / dsq["bf16"][1]) ** 0.5,
                    "decode_rel_l2_to_one_card_f32": (
                        dsq["f32"][0] / dsq["f32"][1]) ** 0.5,
                    "decode_greedy_agree_bf16": sum(
                        r_["decode_agree_bf16"][0] for r_ in rs) / sum(
                        r_["decode_agree_bf16"][1] for r_ in rs)})
                for r_ in rs:
                    check(r_["decode_syncs"] == 0, (arch, r_["decode_syncs"]))
                    check(r_["decode_tokens_in_range"], (arch, "tokens"))
                    check(r_["decode_launches"] == {}, (arch, r_[
                        "decode_launches"]))
            s[route] = e
        summary[key] = s
        for route, e in s.items():
            if not isinstance(e, dict):
                continue
            c0 = e.get("decode_collectives_by_rank", [{}])[0]
            print(f"(b) {arch}, bf16, full width, {cfg_.n_layers} layers, "
                  f"{route} route, "
                  f"{MESH_SHAPES[arch]} of gloo ranks on the card: prefill "
                  f"{PREFILL_B} x {PREFILL_T} {e['prefill_ms']:.1f} ms a call "
                  f"(the slowest rank's median of {MESH_TIMED}), "
                  f"{e['prefill_tokens_per_s']:.0f} tokens/s, launches a call "
                  f"a rank {e['prefill_launches_a_rank']}; relative L2 to the "
                  f"one-card bf16 logits {e['prefill_rel_l2_to_one_card_bf16']:.4g}"
                  f", greedy tokens equal {e['prefill_greedy_agree_bf16']:.3f}"
                  + (f"; decode {e['decode_ms']:.1f} ms a step, "
                     f"{e['decode_tokens_per_s']:.1f} tokens/s, host syncs a "
                     f"step {e['decode_syncs_by_rank']}, launches "
                     f"{e['decode_launches_a_rank']}, one step's collectives "
                     f"(rank 0) {c0.get('calls')} calls handed "
                     f"{c0.get('bytes', 0) / 1e6:.1f} MB, "
                     f"{c0.get('ms', 0.0):.1f} ms inside them; relative L2 "
                     f"to the one-card bf16 logits "
                     f"{e['decode_rel_l2_to_one_card_bf16']:.4g}, greedy "
                     f"equal {e['decode_greedy_agree_bf16']:.3f}"
                     if "decode_ms" in e else "")
                  + f"; peak {max(s['peak_gb_by_rank']):.2f} GB a rank",
                  flush=True)
    # qwen3's bf16 rule: the mesh no farther from the float32 one-card
    # logits than 1.25x the one-card bf16 logits are
    q = summary["qwen3_bf16"]["dense"]
    for what in ("prefill", "decode"):
        one = (one_sq[what][0] / one_sq[what][1]) ** 0.5
        got = q[f"{what}_rel_l2_to_one_card_f32"]
        q[f"{what}_one_card_bf16_rel_l2_to_f32"] = one
        print(f"(b) qwen3-0.6b bf16 {what}: the mesh's logits {got:.4g} from "
              f"the float32 one-card logits, the one-card bf16 logits "
              f"{one:.4g} (gate: mesh <= {TRAIN_BF16_FROM_F32} x one card)",
              flush=True)
        check(got <= TRAIN_BF16_FROM_F32 * one, (what, got, one))
    # (c) NCCL at world size 1
    t0 = time.perf_counter()
    nccl = procs.spawn(serve_mesh_nccl_rank, 1, backend="nccl", device=dev,
                       timeout=MESH_TIMEOUT)[0]
    summary["nccl"] = {**nccl, "spawn_s": time.perf_counter() - t0}
    print(f"(c) NCCL at world size 1 ({nccl['backend']}), qwen3-0.6b bf16 "
          f"2-layer cut: the serve steps on the (1, 1, 1) mesh equal the "
          f"steps without one: {nccl['same']}; decode "
          f"{float(np.median(nccl['decode_ms'])):.2f} ms a step, "
          f"{nccl['syncs']} host syncs a step", flush=True)
    check(nccl["backend"] == "nccl" and nccl["same"] and nccl["syncs"] == 0,
          ("nccl", nccl))
    shutil.rmtree(mesh_dir, ignore_errors=True)
    summary["rank_walls_s"] = ranks[0]["walls_s"]
    summary["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 14: {summary['wall_s']:.2f} s (rank 0's parts: "
          f"{json.dumps(summary['rank_walls_s'])})")
    assert not failures, failures
    kern = {"flash_attention": {
        "serve_mesh_launches_per_call_a_rank": kern_launches,
        "serve_mesh_shapes": summary["fa"]}}
    return summary, kern


# ---------------------------------------------------------------------------
# Phase 15: training MLA + MoE inside a pod, and a model axis wider than
# n_kv_heads
# ---------------------------------------------------------------------------

#: phase 15, four gloo ranks sharing the card, one spawn.  (a)
#: deepseek-v2-lite-16b at full width, float32 (TF32 off), its first
#: MOE_CUT layers (layer 0 dense, layer 1 MoE: 64 experts, 16 a rank) over
#: (1, 1, 4), a pod batch of MOE_B x MOE_T tokens: one bsp step with each
#: MoE route against the one-card step (the dense route gated at phase
#: 13's INTRA_L2_TOL, its loss at 1e-6 relative; the EP route, another
#: function, reported), every (token, k) pair's expert against the
#: one-card router's (a flip allowed only where the one-card top-k margin
#: is below MOE_FLIP_MARGIN relative), and the EP route's MoE layer on
#: seeded tokens: its gradients against ``moe_apply_ep_ref``'s autograd
MOE_MESH, MOE_CUT, MOE_B, MOE_T = (1, 1, 4), 2, 2, 256
MOE_FLIP_MARGIN, MOE_LOSS_TOL, MOE_AUX_WEIGHT = 1e-5, 1e-6, 100.0
#: (b) (a)'s cut in bf16 (float32 norms) over (2, 1, 2): each strategy's
#: exchange on seeded inputs, each rank's blocks against the one-card
#: exchange's, bit for bit by ``_fingerprint``: rank 0 runs the one-card
#: exchange once (at this cut it needs most of the card), the ranks keep
#: fingerprints
MOE_EX_MESH = (2, 1, 2)
#: (c) deepseek-v2-lite-16b bf16, remat, MOE_TIMED_CUT layers (1 dense, 2
#: MoE; 4 until the script's time asked for the cut) over (1, 1, 4), 2 x
#: 1024 tokens, bsp, both routes: one warm-up and PHASE15_TIMED timed
#: steps (3 until phase 16 (d) and (e) needed the script's time)
MOE_TIMED_CUT, PHASE15_TIMED = 3, 1
#: (d) starcoder2-3b at full width (24 heads over 2 KV heads: each KV head
#: serves two of the four model ranks), float32, KV_CUT layers over (1, 1,
#: 4): one bsp step against one card (INTRA_L2_TOL); a prefill of KV_PRE_B
#: x KV_PRE_T and KV_DECODE teacher-forced decode steps of MESH_B requests
#: over MESH_CACHE slots under each cache placement, against the one-card
#: serve by phase 14's float32 gate (C12)
KV_CUT, KV_PRE_B, KV_PRE_T, KV_DECODE = 2, 4, 512, 8
#: (e) starcoder2-3b bf16, remat, KV_TIMED_CUT layers (8 until the
#: script's time asked for the cut), 1 x 1024 tokens, bsp: one warm-up and
#: KV_TIMED timed steps (2 until phase 16 (d) and (e) needed the time)
KV_TIMED_CUT, KV_TIMED = 4, 1
PHASE15_TIMEOUT = 600


def _p15_tokens(vocab, B, T, seed, dev):
    """A train batch of one pod: tokens and next-token labels (1, B, T)."""
    seqs = torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (1, B, T + 1))).to(dev)
    return {"tokens": seqs[..., :-1], "labels": seqs[..., 1:]}


def _replicas(spec, mesh) -> int:
    """The ranks that hold one block of a leaf placed by ``spec``: the
    pod's ranks along the axes it is not split over."""
    return int(np.prod([mesh.size_of(a) for a in ("data", "model")
                        if a not in spec]))


def _p15_sq(got, want, specs, mesh):
    """(sum of squared differences, sum of squares of ``want``) over this
    rank's blocks, each leaf weighted by 1 / its replicas: summed over the
    ranks, the whole leaves' (float64)."""
    num, den = 0.0, 0.0
    for g_, w_, s_ in zip(got, want, specs, strict=True):
        n_, d_ = _sq_diff([g_], [w_])
        r_ = _replicas(s_, mesh)
        num, den = num + n_ / r_, den + d_ / r_
    return num, den


def _fingerprint(t, chunk: int = 1 << 26) -> torch.Tensor:
    """Two int64 sums of a tensor's bit patterns on its device, plain and
    weighted by each entry's index (wrapping): one entry that differs
    changes the plain sum, two that trade places the weighted one."""
    bits = t.contiguous().reshape(-1).view(
        {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[
            t.element_size()])
    out = torch.zeros(2, dtype=torch.int64, device=t.device)
    for lo in range(0, bits.numel(), chunk):
        b_ = bits[lo:lo + chunk].long()
        idx = torch.arange(lo + 1, lo + 1 + b_.numel(), device=t.device)
        out[0] += b_.sum()
        out[1] += (b_ * idx).sum()
    return out


def _top_margin(probs, k):
    """Each token's smallest relative gap among its k + 1 largest router
    probabilities: (p_j - p_(j+1)) / p_j, the least over j < k + 1."""
    top = torch.topk(probs.double(), k + 1, dim=-1).values
    return ((top[:, :-1] - top[:, 1:]) / top[:, :-1]).amin(dim=-1)


def _draw_inputs(strategy, like, n_pods, gen, comm, specs=None,
                 mesh=None):
    """The exchange's seeded inputs of ``strategy`` over stacked (n_pods,
    ...) leaves of ``like``'s shapes and dtypes, each leaf drawn in turn
    from ``gen``; with ``specs`` and ``mesh`` each leaf cut to this rank's
    block (its pods, its data and model blocks) as soon as it is drawn.
    AD-PSGD's snapshot buffers are drawn a leaf's (S + 1, n_pods, ...)
    slab at a time, laid side by side by dtype group."""
    from repro_torch import pytree
    from repro_torch.launch import sharding
    from repro_torch.launch import steps as lsteps
    dev = gen.device
    if mesh is None:
        pods, cut = range(n_pods), lambda t_, i_, lead: t_
    else:
        pods = lsteps.local_pods(n_pods, mesh)

        def cut(t_, i_, lead):
            return sharding.local_block(
                t_.narrow(lead, pods.start, len(pods)),
                (None,) * (lead + 1) + tuple(specs[i_]), mesh).clone()

    def draw(scale, dtype=None):
        out = []
        for i_, t_ in enumerate(like):
            w_ = torch.randn((n_pods,) + tuple(t_.shape), generator=gen,
                             device=dev).mul_(scale).to(dtype or t_.dtype)
            out.append(cut(w_, i_, 0))
            del w_
        return out
    if strategy == "bsp":
        return {"grads": draw(0.01)}
    parts = {"params": draw(0.1)}
    if strategy in ("gaia", "dgc"):
        parts["acc"] = draw(0.01, torch.float32)
    if strategy == "dgc":
        parts["vel"] = draw(0.01, torch.float32)
    if strategy == "adpsgd":
        S1 = comm.max_staleness + 1
        parts["snaps"] = {}
        for dt_, idx in lsteps.dtype_groups(like).items():
            slabs = []
            for i_ in idx:
                w_ = torch.randn((S1, n_pods) + tuple(like[i_].shape),
                                 generator=gen, device=dev).mul_(0.1).to(dt_)
                slabs.append(cut(w_, i_, 1).reshape(S1, len(pods), -1))
                del w_
            parts["snaps"][pytree.dtype_name(dt_)] = torch.cat(slabs, dim=2)
            del slabs
    return parts


def _turns(fn, rank: int, world: int) -> None:
    """``fn()`` on each rank of the process group in turn (the one-card
    runs: one whole model on the card at a time), every rank's cached
    blocks given back first."""
    import torch.distributed as dist
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    for turn in range(world):
        if rank == turn:
            fn()
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()


def _timed_train(cfg_, mesh_, batch_, route, n_timed, dev):
    """One warm-up and ``n_timed`` timed bsp steps of ``cfg_`` on this
    rank of ``mesh_``, the weights drawn from seed 0: walls, launches a
    step, host syncs (the last step), collectives of the first timed step
    (one step: both), losses, peak memory, the warm-up step's plain
    attention backward."""
    from repro_torch import pytree
    from repro_torch.configs.base import CommConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import steps as lsteps
    from repro_torch.models import model as lm
    bsp = CommConfig(strategy="bsp")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    whole_ = lm.init_model(torch.Generator(device=dev).manual_seed(0), cfg_,
                           dev)
    box = [lsteps.make_train_state(whole_, bsp, 1, mesh=mesh_), None]
    del whole_
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = lsteps.make_train_step(cfg_, bsp, mesh=mesh_, lr=TRAIN_LR,
                                  remat=True, moe_route=route)
    losses, bwd_ms = [], []
    orig_bwd = kref.flash_attention_bthd_bwd_ref

    def bwd(*args, **kw):
        # the warm-up step's plain attention backward, synchronised
        # around each call (the timed steps are not)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig_bwd(*args, **kw)
        torch.cuda.synchronize()
        bwd_ms.append((time.perf_counter() - t0) * 1e3)
        return res

    def one(i):
        box[0], box[1] = step(box[0], batch_, i)
        losses.append(box[1]["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with swapped(kref, "flash_attention_bthd_bwd_ref", bwd):
        one(0)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    for k_ in ops.launches:
        ops.launches[k_] = 0
    times, syncs, blocked = [], None, None
    for i in range(1, n_timed + 1):
        torch.cuda.synchronize()
        mesh_.barrier()
        t0 = time.perf_counter()
        if i == 1 == n_timed:
            with _timed_collectives() as blocked:
                syncs = count_syncs(lambda: one(i))
        elif i == 1:
            with _timed_collectives() as blocked:
                one(i)
        elif i < n_timed:
            one(i)
        else:
            syncs = count_syncs(lambda: one(i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    r_ = {"wall_ms": times, "median_ms": float(np.median(times)),
          "launches_per_step": {k_: c_ / n_timed for k_, c_ in
                                ops.launches.items() if c_},
          "syncs_per_step": syncs, "collectives": blocked,
          "losses": [float(x_) for x_ in losses],
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "warmup_ms": warm_ms, "warmup_attn_bwd_ms": sum(bwd_ms),
          "warmup_attn_bwd_calls": len(bwd_ms),
          "finite": all(bool(torch.isfinite(t_).all())
                        for t_ in pytree.leaves(box[0]["params"]))}
    del box, step
    gc.collect()
    torch.cuda.empty_cache()
    return r_


def moe_rank(rank: int, dev: torch.device, ref_path: str) -> dict:
    """One gloo rank of phase 15 (``procs.spawn``).  Returns host numbers;
    the parent gates them."""
    from repro_torch import pytree
    from repro_torch.configs.base import CommConfig, FabricConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding
    from repro_torch.launch import steps as lsteps
    from repro_torch.launch.mesh import AXES, Mesh, make_mesh
    from repro_torch.models import model as lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import moe_ep
    from repro_torch.models.layers import gated_mlp_apply
    from repro_torch.models.shard_hints import activation_sharding
    from repro_torch.topology.graphs import build_demo_schedule
    import torch.distributed as dist
    t_rank = time.perf_counter()
    world = dist.get_world_size()
    ref = torch.load(ref_path, weights_only=True)
    out = {"rank": rank, "walls_s": {}}
    last = [time.perf_counter()]
    bsp = CommConfig(strategy="bsp")

    def mark(label):
        now = time.perf_counter()
        out["walls_s"][label] = now - last[0]
        last[0] = now
        if rank == 0:
            print(f"phase 15 rank 0: {label} {out['walls_s'][label]:.1f} s "
                  f"(at {now - t_rank:.1f} s)", flush=True)

    def draw(cfg_):
        return lm.init_model(torch.Generator(device=dev).manual_seed(0),
                             cfg_, dev)

    def reset():
        for k_ in ops.launches:
            ops.launches[k_] = 0

    def launched():
        return {k_: c_ for k_, c_ in ops.launches.items() if c_}

    def recorder(calls, probs=False):
        """``moe.route_logits`` recording each call's experts (and
        probabilities)."""
        orig = moe_mod.route_logits

        def rec(m_, logits_):
            p_, g_, e_ = orig(m_, logits_)
            calls.append((e_.detach().clone(),
                          p_.detach().clone() if probs else None))
            return p_, g_, e_
        return rec

    # ----------------------------------------------------------------- (a)
    dcfg = get_config("deepseek-v2-lite-16b")
    cut = dataclasses.replace(dcfg, n_layers=MOE_CUT, dtype="float32")
    mesh = make_mesh(MOE_MESH, device=dev, cfg=cut)
    out["coords"] = mesh.coords
    specs = sharding.leaf_specs(lsteps.param_shape(cut), mesh)
    batch = _p15_tokens(cut.vocab, MOE_B, MOE_T, 150, dev)
    a = {}
    with tf32_off():
        whole = draw(cut)
        state = lsteps.make_train_state(whole, bsp, 1, mesh=mesh)
        del whole
        torch.cuda.empty_cache()
        mine = {}
        for route in moe_mod.ROUTES:
            step = lsteps.make_train_step(cut, bsp, mesh=mesh, lr=TRAIN_LR,
                                          remat=True, moe_route=route)
            calls, drops = [], []

            def dispatch(*args, _orig=moe_ep._dispatch):
                res = _orig(*args)
                keep = res[2][1]
                drops.append(((~keep).sum(), keep.numel()))
                return res
            reset()
            box = []
            with swapped(moe_mod, "route_logits", recorder(calls)), \
                    swapped(moe_ep, "_dispatch", dispatch):
                syncs = count_syncs(lambda: box.append(step(state, batch,
                                                            1)))
            new, metrics = box[0]
            mine[route] = [t_ for k_ in ("params", "vel")
                           for t_ in pytree.leaves(new[k_])]
            a[route] = {"loss": float(metrics["loss"]), "syncs": syncs,
                        "launches": launched()}
            if route == "dense":
                # the forward's routing, and the remat recompute's again
                fwd, again = calls[0][0], calls[-1][0]
                a[route]["recompute_routes_alike"] = len(calls) == 2 and \
                    torch.equal(fwd, again)
                mine["experts"] = fwd
            else:
                # the forward's dispatch (the recompute's repeats it)
                a[route]["dropped_pairs"] = [int(drops[0][0]), drops[0][1]]
                a[route]["dispatch_calls"] = len(drops)
            del step, box, new, calls, drops
            gc.collect()
            torch.cuda.empty_cache()
        mark("(a) the mesh steps")
        # the EP route's MoE layer on seeded tokens, its gradient blocks
        gen = torch.Generator(device=dev).manual_seed(151)
        x = torch.randn(MOE_B, MOE_T, cut.d_model, generator=gen, device=dev)
        wy = torch.randn(MOE_B, MOE_T, cut.d_model, generator=gen,
                         device=dev)
        ffn = pytree_first_moe(pytree.tree_map(lambda t_: t_[0],
                                               state["params"]))
        ffn = pytree.tree_map(lambda t_: t_.detach().clone()
                              .requires_grad_(), ffn)
        xr = x.clone().requires_grad_()
        reset()
        with activation_sharding(mesh):
            y, aux = moe_mod.moe_apply(ffn, cut.moe, xr, "ep")
        layer_grads = torch.autograd.grad(
            (y * wy).sum() + MOE_AUX_WEIGHT * aux, [xr] + pytree.leaves(ffn))
        ffn_shape = {"ffn": pytree_first_moe(lsteps.param_shape(cut))}
        ffn_specs = sharding.leaf_specs(ffn_shape, mesh)
        a["ep_layer_names"] = ["y", "x"] + [
            p_ for p_, _ in pytree.leaves_with_paths(ffn_shape)]
        a["ep_layer_aux_mesh"] = float(aux.detach())
        layer_y = y.detach()
        del state, ffn, y, aux, xr
        gc.collect()
        torch.cuda.empty_cache()
        mark("(a) the EP layer on the mesh")

        def one_card():
            whole_ = draw(cut)
            calls = []
            step = lsteps.make_train_step(cut, bsp, lr=TRAIN_LR, remat=True)
            with swapped(moe_mod, "route_logits", recorder(calls, True)):
                new, metrics = step(lsteps.make_train_state(whole_, bsp, 1),
                                    batch, 1)
            want = [t_ for k_ in ("params", "vel")
                    for t_ in pytree.leaves(new[k_])]
            stacked = [(None,) + tuple(s_) for s_ in specs] * 2
            blocks = _intra_blocks(want, list(specs) * 2, mesh, slice(0, 1))
            for route in moe_mod.ROUTES:
                a[route]["sq"] = _p15_sq(mine[route], blocks, stacked, mesh)
            a["one_card_loss"] = float(metrics["loss"])
            e1, p1 = calls[0]
            differ = (e1 != mine["experts"]).any(dim=-1)
            margin = _top_margin(p1, cut.moe.top_k)
            a["pairs"] = e1.numel()
            a["flipped_tokens"] = int(differ.sum())
            a["flip_margins"] = margin[differ].tolist()
            a["least_margin"] = float(margin.min())
            del new, want, blocks, calls, step, mine["experts"]
            # the EP layer in one process, whole weights, autograd
            f_ = pytree.tree_map(lambda t_: t_.detach().clone()
                                 .requires_grad_(), pytree_first_moe(whole_))
            del whole_
            xw = x.clone().requires_grad_()
            y_, aux_ = moe_ep.moe_apply_ep_ref(f_, cut.moe, xw, *MOE_MESH[1:])
            y_ = y_ + gated_mlp_apply(f_["shared"], xw)
            g_ = torch.autograd.grad((y_ * wy).sum() + MOE_AUX_WEIGHT * aux_,
                                     [xw] + pytree.leaves(f_))
            # per leaf: y, x's gradient (whole on every rank), each
            # leaf's gradient block
            a["ep_layer_sq"] = [_p15_sq([g1], [w1], [s1], mesh) for g1, w1, s1
                                in zip([layer_y] + list(layer_grads),
                                       [y_.detach(), g_[0]] + [
                                           sharding.local_block(t_, s_, mesh)
                                           for t_, s_ in zip(g_[1:],
                                                             ffn_specs)],
                                       [(), ()] + list(ffn_specs),
                                       strict=True)]
            a["ep_layer_aux"] = float(aux_)
        _turns(one_card, rank, world)
        del mine, layer_grads, layer_y
        gc.collect()
        torch.cuda.empty_cache()
    out["a"] = a
    mark("(a) the one-card steps in turns")

    # ----------------------------------------------------------------- (b)
    cut16 = dataclasses.replace(cut, dtype="bfloat16")
    ex_mesh = make_mesh(MOE_EX_MESH, device=dev, cfg=cut16)
    like16 = pytree.leaves(lsteps.param_shape(cut16))
    ex_specs = sharding.leaf_specs(lsteps.param_shape(cut16), ex_mesh)
    sched = build_demo_schedule("ring", TRAIN_PODS)
    b = {}
    for n_, (strategy, kw) in enumerate(TRAIN_RUNS):
        comm = CommConfig(strategy=strategy,
                          fabric=FabricConfig(topology="ring"), **kw)

        def operands(mesh_):
            if strategy not in lsteps.GOSSIP_STRATEGIES:
                return {}
            return {"mix": lsteps.gossip_operands(
                sched, 0, device=dev, mesh=mesh_, **(
                    {"staleness": TRAIN_STALENESS,
                     "max_staleness": comm.max_staleness}
                    if strategy == "adpsgd" else {}))}

        def inputs(**blocks_kw):
            return _draw_inputs(strategy, like16, TRAIN_PODS,
                                torch.Generator(device=dev).manual_seed(
                                    160 + n_), comm, **blocks_kw)
        parts = inputs(specs=ex_specs, mesh=ex_mesh)
        ex = lsteps.make_exchange(comm, mesh=ex_mesh, lr=TRAIN_LR,
                                  specs=ex_specs)
        kw_mesh = operands(ex_mesh)     # built and checked on the host
        reset()
        box = []
        syncs = count_syncs(lambda: box.append(ex(parts, step_idx=1,
                                                  **kw_mesh)))
        # each result leaf's fingerprint, in place of the leaf: the
        # one-card exchange of this cut needs most of the card; rank 0
        # runs it once and checks every rank's blocks of it
        r_ = {"launches": launched(), "syncs": syncs, "differ": 0,
              "elements": sum(t_.numel() for t_ in pytree.leaves(box[0]))}
        fps = [None] * world
        dist.all_gather_object(fps, [_fingerprint(t_).tolist()
                                     for t_ in pytree.leaves(box[0])])
        del parts, box
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:
            want = lsteps.make_exchange(comm, lr=TRAIN_LR)(
                inputs(), step_idx=1, **operands(None))
            desc = Mesh(MOE_EX_MESH, AXES)
            for r in range(world):
                desc.coords = dict(zip(AXES, map(int, np.unravel_index(
                    r, MOE_EX_MESH))))
                rows_r = lsteps.local_pods(TRAIN_PODS, desc)
                rows_r = slice(rows_r.start, rows_r.stop)
                for g_, w_ in zip(fps[r], pytree.leaves({
                        k_: _intra_snaps(v_, like16, ex_specs, desc, rows_r)
                        if k_ == "snaps" else
                        _intra_blocks(v_, ex_specs, desc, rows_r)
                        for k_, v_ in want.items()}), strict=True):
                    r_["differ"] += int(_fingerprint(w_).tolist() != g_)
            del want
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
        b[strategy] = r_
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:
            print(f"phase 15 rank 0: (b) {strategy} at "
                  f"{time.perf_counter() - t_rank:.1f} s", flush=True)
    out["b"] = b
    mark("(b) the exchanges")

    # ------------------------------------------------------- (c) and (e)
    tcfg = dataclasses.replace(dcfg, n_layers=MOE_TIMED_CUT)
    tbatch = _p15_tokens(tcfg.vocab, TRAIN_B, TRAIN_T, 152, dev)
    out["c"] = {route: _timed_train(tcfg, mesh, tbatch, route, PHASE15_TIMED,
                                    dev)
                for route in moe_mod.ROUTES}
    mark("(c) deepseek-lite bf16 timed")

    # ----------------------------------------------------------------- (d)
    scfg = get_config("starcoder2-3b")
    s32 = dataclasses.replace(scfg, n_layers=KV_CUT, dtype="float32")
    kv_mesh = make_mesh(MOE_MESH, device=dev, cfg=s32)
    s_specs = sharding.leaf_specs(lsteps.param_shape(s32), kv_mesh)
    d = {}
    with tf32_off():
        whole = draw(s32)
        state = lsteps.make_train_state(whole, bsp, 1, mesh=kv_mesh)
        params = pytree.tree_map(lambda t_: t_.clone(),
                                 sharding.local_params(whole, kv_mesh))
        del whole
        torch.cuda.empty_cache()
        sbatch = _p15_tokens(s32.vocab, MOE_B, MOE_T, 153, dev)
        reset()
        box = []
        d["syncs"] = count_syncs(lambda: box.append(lsteps.make_train_step(
            s32, bsp, mesh=kv_mesh, lr=TRAIN_LR, remat=True)(state, sbatch,
                                                             1)))
        new, metrics = box[0]
        d["launches"] = launched()
        d["loss"] = float(metrics["loss"])
        got = [t_ for k_ in ("params", "vel") for t_ in pytree.leaves(new[k_])]
        del state, box, new
        # the serve under each placement, against the parent's one-card run
        pre_tok = ref["kv/prefill_tokens"].to(dev)
        fed = ref["kv/fed"]
        with torch.inference_mode():
            pre = lsteps.make_prefill_step(s32, mesh=kv_mesh)(
                params, {"tokens": pre_tok})
            d["prefill"] = _row_rel(pre, ref["kv/prefill"].to(dev))
            for bs, base in ((True, False), (True, True)):
                cache = lm.init_cache(s32, MESH_B, MESH_CACHE, device=dev,
                                      mesh=kv_mesh, batch_sharded=bs,
                                      baseline_decode=base)
                step = lsteps.make_serve_step(s32, mesh=kv_mesh,
                                              batch_sharded=bs,
                                              baseline_decode=base)
                worst = 0.0
                for t in range(KV_DECODE):
                    logits, cache = step.logits(params, cache,
                                                _decode_batch(fed, t, dev))
                    worst = max(worst, _row_rel(logits,
                                                ref["kv/decode"][t].to(dev)))
                d[f"decode_base{int(base)}"] = worst
                del cache
        del params, pre
        mark("(d) starcoder2 the mesh step and serve")

        def one_card():
            whole_ = draw(s32)
            new_, m_ = lsteps.make_train_step(s32, bsp, lr=TRAIN_LR,
                                              remat=True)(
                lsteps.make_train_state(whole_, bsp, 1), sbatch, 1)
            del whole_
            want = [t_ for k_ in ("params", "vel")
                    for t_ in pytree.leaves(new_[k_])]
            d["sq"] = _p15_sq(got, _intra_blocks(want, list(s_specs) * 2,
                                                 kv_mesh, slice(0, 1)),
                              [(None,) + tuple(s_) for s_ in s_specs] * 2,
                              kv_mesh)
            d["one_card_loss"] = float(m_["loss"])
            del new_, want
        _turns(one_card, rank, world)
        del got
        gc.collect()
        torch.cuda.empty_cache()
    out["d"] = d
    mark("(d) starcoder2 the one-card steps in turns")

    # ----------------------------------------------------------------- (e)
    ecfg = dataclasses.replace(scfg, n_layers=KV_TIMED_CUT)
    ebatch = _p15_tokens(ecfg.vocab, 1, TRAIN_T, 154, dev)
    out["e"] = _timed_train(ecfg, kv_mesh, ebatch, "dense", KV_TIMED, dev)
    mark("(e) starcoder2 bf16 timed")
    return out


def _kv_serve(cfg, params, dev, fed):
    """The one-card float32 serve of phase 15 (d): the prefill's last
    logits of KV_PRE_B x KV_PRE_T seeded prompts, and each of KV_DECODE
    teacher-forced decode steps' logits of ``fed`` (MESH_B, KV_DECODE),
    on the host."""
    from repro_torch.launch import steps as lsteps
    from repro_torch.models import model as lm
    toks = torch.from_numpy(np.random.default_rng(155).integers(
        0, cfg.vocab, (KV_PRE_B, KV_PRE_T)))
    with torch.inference_mode():
        pre = lsteps.make_prefill_step(cfg)(params, {"tokens": toks.to(dev)})
        cache = lm.init_cache(cfg, MESH_B, MESH_CACHE, device=dev)
        step = lsteps.make_serve_step(cfg)
        dec = []
        for t in range(KV_DECODE):
            logits, cache = step.logits(params, cache,
                                        _decode_batch(fed, t, dev))
            dec.append(logits.float().cpu())
    return toks, pre.float().cpu(), torch.stack(dec)


def moe_phase(dev: torch.device):
    """Phase 15: training MLA + MoE inside a pod, and a model axis wider
    than n_kv_heads.  The parent runs (d)'s one-card serve and its
    rounding floor, then ``procs.spawn`` starts four gloo ranks on the
    card (``moe_rank``); every check is gated here, after every number is
    printed.  Returns (summary, the kernels' phase 15 figures by kernel
    name)."""
    import shutil
    from repro_torch import pytree
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import procs
    from repro_torch.models import model as lm
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    summary, failures = {}, []

    def check(ok, what):
        if not ok:
            failures.append(what)
            print(f"phase 15 FAILED: {what}", flush=True)

    def rel(num_den):
        return (num_den[0] / max(num_den[1], 1e-300)) ** 0.5

    # (d)'s one-card serve, and the model's rounding floor (phase 14's)
    s32 = dataclasses.replace(get_config("starcoder2-3b"), n_layers=KV_CUT,
                              dtype="float32")
    fed = torch.from_numpy(np.random.default_rng(156).integers(
        0, s32.vocab, (MESH_B, KV_DECODE)))
    with tf32_off():
        p = lm.init_model(torch.Generator(device=dev).manual_seed(0), s32,
                          dev)
        toks, pre, dec = _kv_serve(s32, p, dev, fed)
        witness = {"prefill": 0.0, "decode": 0.0}
        for seed in (7, 8):
            gen = torch.Generator(device=dev).manual_seed(seed)
            moved = pytree.tree_map(lambda t_: t_ * (
                1 + 2 ** -24 * torch.randn(t_.shape, generator=gen,
                                           device=dev)), p)
            _, pre_w, dec_w = _kv_serve(s32, moved, dev, fed)
            del moved
            witness = {"prefill": max(witness["prefill"],
                                      _row_rel(pre_w, pre)),
                       "decode": max(witness["decode"], _row_rel(dec_w, dec))}
    del p
    torch.cuda.empty_cache()
    out_dir = ROOT / "build" / "phase15"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    ref_path = str(out_dir / "one_card.pt")
    torch.save({"kv/prefill_tokens": toks, "kv/prefill": pre,
                "kv/decode": dec, "kv/fed": fed}, ref_path)
    summary["one_card_s"] = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    ranks = procs.spawn(moe_rank, 4, backend="gloo", device=dev,
                        timeout=PHASE15_TIMEOUT, args=(ref_path,))
    summary["spawn_s"] = time.perf_counter() - t0
    shutil.rmtree(out_dir, ignore_errors=True)

    # (a)
    dcfg = get_config("deepseek-v2-lite-16b")
    n_fa = lambda cfg_, n_: n_ + n_ - (cfg_.moe.first_dense_layers
                                       if cfg_.moe.n_experts else 0)
    a0 = ranks[0]["a"]
    a = {"mesh": MOE_MESH, "layers": MOE_CUT, "tokens": MOE_B * MOE_T}
    for route in ("dense", "ep"):
        sq = [sum(r_["a"][route]["sq"][j] for r_ in ranks) for j in (0, 1)]
        a[route] = {"params_vel_rel_l2": rel(sq),
                    "loss": a0[route]["loss"],
                    "syncs_by_rank": [r_["a"][route]["syncs"] for r_ in ranks],
                    "launches": a0[route]["launches"]}
    a["one_card_loss"] = a0["one_card_loss"]
    a["loss_rel_diff"] = abs(a["dense"]["loss"] - a0["one_card_loss"]) / abs(
        a0["one_card_loss"])
    a["pairs"] = a0["pairs"]
    a["flipped_tokens_by_rank"] = [r_["a"]["flipped_tokens"] for r_ in ranks]
    a["flip_margins"] = sorted({m_ for r_ in ranks
                                for m_ in r_["a"]["flip_margins"]})
    a["least_margin"] = a0["least_margin"]
    a["recompute_routes_alike"] = all(
        r_["a"]["dense"]["recompute_routes_alike"] for r_ in ranks)
    a["ep"]["dropped_pairs"] = a0["ep"]["dropped_pairs"]
    a["ep"]["dropped_pairs_by_rank"] = [r_["a"]["ep"]["dropped_pairs"]
                                        for r_ in ranks]
    names = a0["ep_layer_names"]
    a["ep_layer_rel_l2"] = {
        name_: rel([sum(r_["a"]["ep_layer_sq"][j][i] for r_ in ranks)
                    for i in (0, 1)]) for j, name_ in enumerate(names)}
    a["ep_layer_aux"] = (a0["ep_layer_aux_mesh"], a0["ep_layer_aux"])
    summary["a"] = a
    print(f"(a) deepseek-v2-lite-16b, float32 (TF32 off), full width, "
          f"{MOE_CUT}-layer cut (1 dense, 1 MoE: 64 experts, 16 a rank), "
          f"{MOE_MESH} of gloo ranks on the card, a pod batch of {MOE_B} x "
          f"{MOE_T}, one bsp step: dense route against the one-card step, "
          f"the gathered params and velocities' relative L2 "
          f"{a['dense']['params_vel_rel_l2']:.3g} (gate {INTRA_L2_TOL}), loss "
          f"{a['dense']['loss']:.9g} against {a['one_card_loss']:.9g} "
          f"(relative {a['loss_rel_diff']:.3g}, gate {MOE_LOSS_TOL}); "
          f"routing: {a['pairs']} pairs, tokens with a flipped expert by "
          f"rank {a['flipped_tokens_by_rank']}, their one-card top-k "
          f"margins {a['flip_margins']} (allowed below {MOE_FLIP_MARGIN}; "
          f"the least margin of any token {a['least_margin']:.3g}); the "
          f"remat recompute routes as the forward: "
          f"{a['recompute_routes_alike']}; host syncs by rank "
          f"{a['dense']['syncs_by_rank']}; launches a rank "
          f"{a['dense']['launches']}", flush=True)
    print(f"(a) EP route: the step's distance to the one-card (dense) step, "
          f"relative L2 {a['ep']['params_vel_rel_l2']:.3g} (another "
          f"function: reported), loss {a['ep']['loss']:.9g}; pairs dropped "
          f"(dropped, pairs) by rank {a['ep']['dropped_pairs_by_rank']}; "
          f"host syncs by rank {a['ep']['syncs_by_rank']}; the MoE layer on "
          f"seeded tokens against moe_apply_ep_ref's autograd, relative L2 "
          "by leaf " + json.dumps({k_: float(f"{v_:.3g}") for k_, v_ in
                                   a["ep_layer_rel_l2"].items()})
          + f" (gate {INTRA_L2_TOL}); aux {a['ep_layer_aux'][0]:.9g} "
          f"against {a['ep_layer_aux'][1]:.9g}", flush=True)
    check(a["dense"]["params_vel_rel_l2"] <= INTRA_L2_TOL, ("(a) dense", a))
    check(a["loss_rel_diff"] <= MOE_LOSS_TOL, ("(a) loss", a))
    check(all(m_ < MOE_FLIP_MARGIN for m_ in a["flip_margins"]),
          ("(a) routing flips", a["flip_margins"]))
    check(a["recompute_routes_alike"], "(a) the recompute's routing")
    check(all(v_ <= INTRA_L2_TOL for v_ in a["ep_layer_rel_l2"].values()),
          ("(a) EP layer", a["ep_layer_rel_l2"]))
    check(abs(a["ep_layer_aux"][0] - a["ep_layer_aux"][1]) <= INTRA_L2_TOL *
          abs(a["ep_layer_aux"][1]), ("(a) EP aux", a["ep_layer_aux"]))
    for route in ("dense", "ep"):
        check(a[route]["launches"].get("flash_attention") ==
              n_fa(dcfg, MOE_CUT), ("(a) launches", route, a[route]))
    # (b)
    b = {}
    for strategy, _ in TRAIN_RUNS:
        rs = [r_["b"][strategy] for r_ in ranks]
        b[strategy] = {"leaves_differ": sum(r_["differ"] for r_ in rs),
                       "elements": sum(r_["elements"] for r_ in rs),
                       "syncs_by_rank": [r_["syncs"] for r_ in rs],
                       "launches": rs[0]["launches"]}
        check(b[strategy]["elements"] > 0 and
              b[strategy]["leaves_differ"] == 0, ("(b)", strategy,
                                                   b[strategy]))
        check(all(x_ == 0 for x_ in b[strategy]["syncs_by_rank"]),
              ("(b) syncs", strategy, b[strategy]))
    summary["b"] = b
    print(f"(b) (a)'s cut in bf16 over {MOE_EX_MESH}, each strategy's "
          "exchange on seeded inputs against the one-card exchange, each "
          "rank's blocks by their bits' fingerprints (two int64 sums a "
          "leaf): (blocks differing, entries compared), host syncs by rank, "
          "launches a rank: " + json.dumps(
              {k_: [[v_["leaves_differ"], v_["elements"]],
                    v_["syncs_by_rank"], v_["launches"]]
               for k_, v_ in b.items()}), flush=True)

    # (c) and (e)
    def timed(key, cfg_, tokens, route=None):
        rs = [r_[key][route] if route else r_[key] for r_ in ranks]
        slow = max(r_["median_ms"] for r_ in rs)
        c0 = rs[0]["collectives"]
        s = {"median_ms_by_rank": [r_["median_ms"] for r_ in rs],
             "wall_ms_by_rank": [r_["wall_ms"] for r_ in rs],
             "slowest_median_ms": slow, "tokens_per_s": tokens / (slow / 1e3),
             "peak_gb_by_rank": [r_["peak_gb"] for r_ in rs],
             "syncs_per_step_by_rank": [r_["syncs_per_step"] for r_ in rs],
             "launches_per_step": rs[0]["launches_per_step"],
             "collectives_rank0": c0, "losses": rs[0]["losses"],
             "warmup_ms_rank0": rs[0]["warmup_ms"],
             "warmup_attn_bwd_ms_rank0": rs[0]["warmup_attn_bwd_ms"],
             "warmup_attn_bwd_calls": rs[0]["warmup_attn_bwd_calls"]}
        by = {k_: [v_["calls"], round(v_["bytes"] / 1e6, 1),
                   round(v_["ms"], 1)] for k_, v_ in c0["by_name"].items()}
        print(f"({key}) {cfg_.arch_id}, bf16, full width, "
              f"{cfg_.n_layers}-layer cut, remat, {MOE_MESH} of gloo ranks "
              f"on the card, "
              f"{tokens} tokens a step, bsp"
              + (f", {route} route" if route else "")
              + f": {slow:.1f} ms a step (the slowest rank's median of "
              f"{len(rs[0]['wall_ms'])}), {s['tokens_per_s']:.0f} tokens/s, "
              f"peak {max(s['peak_gb_by_rank']):.2f} GB a rank, host syncs a "
              f"step {s['syncs_per_step_by_rank']}, launches a step a rank "
              f"{s['launches_per_step']}; the first timed step's collectives "
              f"(rank 0): {c0['calls']} calls handed {c0['bytes'] / 1e9:.3f} "
              f"GB, {c0['ms']:.1f} ms of the host's wall inside them "
              f"({c0['ms'] / rs[0]['wall_ms'][0]:.3f} of the step), by "
              f"collective [calls, MB, ms] {json.dumps(by)}; the warm-up "
              f"step (rank 0) {s['warmup_ms_rank0']:.1f} ms, of it the plain "
              f"attention backward {s['warmup_attn_bwd_ms_rank0']:.1f} ms in "
              f"{s['warmup_attn_bwd_calls']} calls (synchronised around "
              f"each); losses {[round(x_, 4) for x_ in s['losses']]}",
              flush=True)
        for r_ in rs:
            check(r_["finite"] and np.all(np.isfinite(r_["losses"])),
                  (key, route, "finite"))
            check(r_["syncs_per_step"] == 0, (key, route, "syncs"))
            check(r_["launches_per_step"].get("flash_attention") ==
                  n_fa(cfg_, cfg_.n_layers), (key, route,
                                              r_["launches_per_step"]))
        return s
    tcfg = dataclasses.replace(dcfg, n_layers=MOE_TIMED_CUT)
    summary["c"] = {route: timed("c", tcfg, TRAIN_B * TRAIN_T, route)
                    for route in ("dense", "ep")}
    # (d)
    d0 = ranks[0]["d"]
    d = {"params_vel_rel_l2": rel([sum(r_["d"]["sq"][j] for r_ in ranks)
                                   for j in (0, 1)]),
         "loss": d0["loss"], "one_card_loss": d0["one_card_loss"],
         "syncs_by_rank": [r_["d"]["syncs"] for r_ in ranks],
         "launches": d0["launches"], "rounding_floor": witness,
         **{k_: max(r_["d"][k_] for r_ in ranks)
            for k_ in ("prefill", "decode_base0", "decode_base1")}}
    d["loss_rel_diff"] = abs(d["loss"] - d["one_card_loss"]) / abs(
        d["one_card_loss"])
    gates = {k_: max(MESH_F32_TOL, MESH_WITNESS_X * witness[
        "prefill" if k_ == "prefill" else "decode"])
        for k_ in ("prefill", "decode_base0", "decode_base1")}
    d["gates"] = gates
    summary["d"] = d
    print(f"(d) starcoder2-3b, float32 (TF32 off), full width (24 heads over "
          f"2 KV heads, each KV head serving two of the four model ranks), "
          f"{KV_CUT}-layer cut, {MOE_MESH}: one bsp step against the "
          f"one-card step, relative L2 {d['params_vel_rel_l2']:.3g} (gate "
          f"{INTRA_L2_TOL}), loss relative {d['loss_rel_diff']:.3g}; host "
          f"syncs by rank {d['syncs_by_rank']}, launches a rank "
          f"{d['launches']}; the serve against the one-card serve, the "
          f"largest logit row's relative L2 over the ranks: prefill "
          f"{KV_PRE_B} x {KV_PRE_T} {d['prefill']:.3g}, {KV_DECODE} decode "
          f"steps of {MESH_B} requests, flash-decode placement "
          f"{d['decode_base0']:.3g}, heads placement {d['decode_base1']:.3g}"
          f" (gates max({MESH_F32_TOL}, {MESH_WITNESS_X} x the rounding "
          "floor): " + json.dumps({k_: float(f"{v_:.3g}") for k_, v_ in
                                  gates.items()}) + "; the floor "
          + json.dumps({k_: float(f"{v_:.3g}") for k_, v_ in
                        witness.items()}) + ")", flush=True)
    check(d["params_vel_rel_l2"] <= INTRA_L2_TOL, ("(d) step", d))
    check(d["loss_rel_diff"] <= MOE_LOSS_TOL, ("(d) loss", d))
    check(d["launches"].get("flash_attention") == n_fa(s32, KV_CUT),
          ("(d) launches", d["launches"]))
    for k_, g_ in gates.items():
        check(d[k_] <= g_, ("(d) serve", k_, d[k_], g_))
    # (e)
    ecfg = dataclasses.replace(get_config("starcoder2-3b"),
                               n_layers=KV_TIMED_CUT)
    summary["e"] = timed("e", ecfg, TRAIN_T)
    summary["rank_walls_s"] = ranks[0]["walls_s"]
    summary["wall_s"] = time.perf_counter() - t_phase
    walls = {k_: round(v_, 1) for k_, v_ in summary["rank_walls_s"].items()}
    print(f"phase 15: {summary['wall_s']:.2f} s (the one-card serve "
          f"{summary['one_card_s']:.1f} s; rank 0's parts: "
          f"{json.dumps(walls)})", flush=True)
    assert not failures, failures
    kern = {"flash_attention": {
        "intrapod_moe_launches_per_step_a_rank": {
            "deepseek-v2-lite-16b dense": summary["c"]["dense"][
                "launches_per_step"]["flash_attention"],
            "deepseek-v2-lite-16b ep": summary["c"]["ep"][
                "launches_per_step"]["flash_attention"],
            "starcoder2-3b": summary["e"]["launches_per_step"][
                "flash_attention"]}}}
    for name_, key_ in (("gaia_select", "gaia_select"),
                        ("abs_histogram", "abs_histogram"),
                        ("dgc_select", "dgc_select"),
                        ("abs_histogram_fused", "dgc_sparsify"),
                        ("neighbor_mix_src", "neighbor_mix_src")):
        kern[name_] = {"intrapod_moe_exchange_launches_a_rank": {
            s_: v_["launches"][key_] for s_, v_ in b.items()
            if key_ in v_["launches"]}}
    return summary, kern


def pytree_first_moe(p):
    """The first MoE layer's FFN of an LM's params (the stacked body's
    first cycle)."""
    from repro_torch import pytree
    cyc = pytree.tree_map(lambda t_: t_[0], p["body"])
    return next(layer["ffn"] for layer in cyc if "router" in layer["ffn"])



# ---------------------------------------------------------------------------
# Phase 16: the SSM, RG-LRU hybrid, enc-dec and VLM families inside a pod
# ---------------------------------------------------------------------------

#: phase 16: four gloo ranks sharing the card, one site of a (1, 2, 2)
#: mesh (``data`` and ``model`` of 2 divide every width of the four)
FAM_MESH = (1, 2, 2)
FAM_ARCHS = ("mamba2-780m", "recurrentgemma-2b", "seamless-m4t-large-v2",
             "phi-3-vision-4.2b")
#: their depth cuts at full width, for the script's time: decoder layers
#: (recurrentgemma's one (rglru, rglru, attn) cycle), and seamless'
#: encoder layers as many
FAM_LAYERS = {"mamba2-780m": 2, "recurrentgemma-2b": 3,
              "seamless-m4t-large-v2": 2, "phi-3-vision-4.2b": 2}
#: (a) float32 (TF32 off): one bsp step on a pod batch of FAM_B x FAM_T
#: tokens (and 576 patches or 1500 frames a sequence) against the one-card
#: step each rank runs in turn; a prefill of FAM_PRE_B x FAM_PRE_T (and
#: patches or frames), then FAM_DECODE teacher-forced decode steps of
#: MESH_B requests over MESH_CACHE slots (the enc-dec's memory encoded
#: once), against the parent's one-card serve by phase 14's gate (C12),
#: and the cache gathered whole against the one-card cache
FAM_B, FAM_T = 2, 256
FAM_PRE_B, FAM_PRE_T, FAM_DECODE = 2, 512, 4
#: (b) bf16, remat, TRAIN_B x TRAIN_T tokens a pod (and patches or
#: frames), bsp: one warm-up and FAM_TIMED timed steps (2 until (d) and
#: (e) needed the script's time)
FAM_TIMED = 1
#: (c) bf16 serving of the two families whose decode caches are new to a
#: mesh: a FAM_SERVE_B x PREFILL_T prefill (one warm-up call, one timed),
#: then FAM_SERVE_STEPS decode steps of FAM_SERVE_B requests over
#: MESH_CACHE slots (the first a warm-up, one timed, the last's host syncs
#: counted; 8 until (d) and (e) needed the script's time)
FAM_SERVE = ("mamba2-780m", "recurrentgemma-2b")
FAM_SERVE_B, FAM_SERVE_STEPS = 4, 3
FAM_TIMEOUT = 600
#: flash_attention's float32 bound at the shapes the ranks launch it at:
#: |err| <= FAM_FA_F32_TOL * (1 + |plain|) an output (phase 5's allclose)
FAM_FA_F32_TOL = 2e-5
#: (d), what an axis does not divide (ROADMAP A11d): (a)'s float32 step
#: and serve of these archs re-meshed over (1, 1, 4): recurrentgemma's 10
#: query heads over 4 ranks (a column block of 640: 2.5 heads, every head
#: run on every rank), seamless' vocabulary of 256,206 whole on every
#: model rank
UNEVEN_MESH = (1, 1, 4)
UNEVEN_ARCHS = ("recurrentgemma-2b", "seamless-m4t-large-v2")
#: (e) one request at long_500k's placement over FAM_MESH (the request
#: whole on every rank, each decode cache's length over data): 2-layer
#: float32 cuts at full width, the cache seeded as it stands after
#: ONE_T0 tokens (qwen3's 4,096-slot window ring wrapped; mamba2's SSD
#: state and conv history), then ONE_DECODE decode steps from ONE_T0
#: against the one-card decode on the same cache by (a)'s gate (C12)
ONE_ARCHS = ("qwen3-0.6b", "mamba2-780m")
ONE_LAYERS, ONE_T0, ONE_DECODE = 2, 4160, 4


def _fam_cut(arch: str, dtype: str):
    """``arch`` at full width, cut to FAM_LAYERS decoder layers (and as
    many encoder layers), in ``dtype``."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    kw = {"n_layers": FAM_LAYERS[arch], "dtype": dtype}
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder,
                                            n_layers=FAM_LAYERS[arch])
    return dataclasses.replace(cfg, **kw)


def _fam_extras(cfg, B: int, seed: int, dev, dtype=torch.float32) -> dict:
    """The seeded frames (enc-dec: n_frames a request) or patches (VLM:
    n_tokens) of ``B`` requests on ``dev``, or none."""
    if cfg.encoder is not None:
        key, n = "frames", cfg.encoder.n_frames
    elif cfg.modality.kind == "vision":
        key, n = "patches", cfg.modality.n_tokens
    else:
        return {}
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {key: torch.randn(B, n, cfg.modality.feat_dim, generator=gen,
                             device=dev).to(dtype)}


def _fam_batch(cfg, B: int, T: int, seed: int, dev, dtype=torch.float32):
    """A train batch of one pod: (1, B, T) tokens and labels, and the
    arch's frames or patches (1, B, ...)."""
    batch = _p15_tokens(cfg.vocab, B, T, seed, dev)
    batch.update({k: v[None] for k, v in
                  _fam_extras(cfg, B, seed + 1, dev, dtype).items()})
    return batch


def _fa_per_step(cfg) -> int:
    """``flash_attention`` launches of one pod's remat train step, by the
    layer plan: every attention of the forward (the encoder's layers, the
    decoder's self- and cross-attention), and again those of the
    checkpointed body cycles (C14's rule)."""
    from repro_torch.models.transformer import layer_plan, layer_sig
    prefix, n_cycles, P, _ = layer_plan(cfg)
    per = [(layer_sig(cfg, i)[0] == "attn") + (cfg.encoder is not None)
           for i in range(cfg.n_layers)]
    body = per[len(prefix):len(prefix) + n_cycles * P]
    return sum(per) + sum(body) + (cfg.encoder.n_layers if cfg.encoder
                                   else 0)


def _fam_serve(cfg, params, dev, mesh=None):
    """Phase 16 (a)'s serve on the card (on ``mesh``: the rank's blocks,
    rows and cache block): the prefill's last logits of FAM_PRE_B x
    FAM_PRE_T seeded prompts (with their frames or patches), each of
    FAM_DECODE teacher-forced decode steps' logits of MESH_B requests
    (the enc-dec's memory encoded once), float32, and the cache after
    them."""
    from repro_torch.launch import steps as lsteps
    from repro_torch.models import model as lm
    toks = torch.from_numpy(np.random.default_rng(160).integers(
        0, cfg.vocab, (FAM_PRE_B, FAM_PRE_T))).to(dev)
    fed = torch.from_numpy(np.random.default_rng(161).integers(
        0, cfg.vocab, (MESH_B, FAM_DECODE)))
    with torch.inference_mode():
        pre = lsteps.make_prefill_step(cfg, mesh=mesh)(
            params, {"tokens": toks, **_fam_extras(cfg, FAM_PRE_B, 162,
                                                   dev)})
        memory = None
        if cfg.encoder is not None:
            memory = lsteps.make_encode_step(cfg, mesh=mesh)(
                params, _fam_extras(cfg, MESH_B, 163, dev))
        cache = lm.init_cache(cfg, MESH_B, MESH_CACHE, device=dev,
                              mesh=mesh)
        step = lsteps.make_serve_step(cfg, memory, mesh=mesh)
        dec = []
        for t in range(FAM_DECODE):
            logits, cache = step.logits(params, cache,
                                        _decode_batch(fed, t, dev))
            dec.append(logits.float())
    return pre.float(), torch.stack(dec), cache


def _one_cut(arch: str):
    """(e)'s ``arch``: full width, ONE_LAYERS layers, float32."""
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(arch), n_layers=ONE_LAYERS,
                               dtype="float32")


def _one_cache(cfg, dev):
    """(e)'s whole decode cache of one ``long_500k`` request, seeded on
    ``dev``: every float leaf from a generator, every position ring as
    it stands after ONE_T0 tokens (position t in slot t mod L)."""
    from repro_torch import pytree
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.models import model as lm
    whole = lm.init_cache(cfg, 1, INPUT_SHAPES["long_500k"].seq_len,
                          long_mode=True, device="meta")
    gen = torch.Generator(device=dev).manual_seed(190)
    out = []
    for t_ in pytree.leaves(whole):
        if t_.dtype == torch.int32:
            L = t_.shape[-1]
            pos = ONE_T0 - L + (torch.arange(L, device=dev) - (ONE_T0 - L)) % L
            out.append(pos.to(torch.int32).expand(t_.shape).contiguous())
        else:
            out.append(0.5 * torch.randn(t_.shape, generator=gen,
                                         device=dev))
    return pytree.unflatten(whole, out)


def _one_serve(cfg, params, cache, dev, mesh=None):
    """(e)'s ONE_DECODE decode steps of one request from ONE_T0 on
    ``cache`` (on ``mesh``: the rank's block, the request whole): each
    step's float32 logits (1, V), and the host syncs of each step's
    serve step (its greedy token, on a copy of the cache)."""
    from repro_torch import pytree
    from repro_torch.launch import steps as lsteps
    fed = torch.from_numpy(np.random.default_rng(191).integers(
        0, cfg.vocab, (1, ONE_DECODE)))
    step = lsteps.make_serve_step(cfg, mesh=mesh, batch_sharded=False)
    logits, syncs = [], []
    with torch.inference_mode():
        for i in range(ONE_DECODE):
            batch = {"token": fed[:, i].to(dev),
                     "t": torch.full((1,), ONE_T0 + i, dtype=torch.int32,
                                     device=dev)}
            copy = pytree.tree_map(torch.clone, cache)
            syncs.append(count_syncs(lambda: step(params, copy, batch)))
            lg, cache = step.logits(params, cache, batch)
            logits.append(lg.float())
    return torch.stack(logits), syncs


def _rel(got, want) -> float:
    """Relative L2 of two tensors, in float64."""
    num, den = _sq(got, want)
    return (num / max(den, 1e-300)) ** 0.5


def families_rank(rank: int, dev: torch.device, ref_path: str) -> dict:
    """One gloo rank of phase 16 (``procs.spawn``).  Returns host numbers;
    the parent gates them."""
    from repro_torch import pytree
    from repro_torch.configs.base import CommConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding
    from repro_torch.launch import steps as lsteps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as lm
    import torch.distributed as dist
    t_rank = time.perf_counter()
    world = dist.get_world_size()
    ref = torch.load(ref_path, weights_only=True)
    out = {"rank": rank, "walls_s": {}, "a": {}, "b": {}, "c": {}}
    last = [time.perf_counter()]
    bsp = CommConfig(strategy="bsp")

    def mark(label):
        now = time.perf_counter()
        out["walls_s"][label] = now - last[0]
        last[0] = now
        if rank == 0:
            print(f"phase 16 rank 0: {label} {out['walls_s'][label]:.1f} s "
                  f"(at {now - t_rank:.1f} s)", flush=True)

    def draw(cfg_):
        return lm.init_model(torch.Generator(device=dev).manual_seed(0),
                             cfg_, dev)

    def reset():
        for k_ in ops.launches:
            ops.launches[k_] = 0

    def launched():
        return {k_: c_ for k_, c_ in ops.launches.items() if c_}

    fa_calls = {}
    fa_kernel = ops.flash_attention_bthd

    def fa_recorded(q, k, v, **kw):
        """``ops.flash_attention_bthd`` as the models call it, each call's
        shapes, dtype and mask counted for the parent's check."""
        key = (tuple(q.shape), tuple(k.shape), tuple(v.shape),
               str(q.dtype).removeprefix("torch."),
               tuple(sorted((k_, v_) for k_, v_ in kw.items()
                            if v_ is not None)))
        fa_calls[key] = fa_calls.get(key, 0) + 1
        return fa_kernel(q, k, v, **kw)
    ops.flash_attention_bthd = fa_recorded

    def step_and_serve(arch, mesh):
        """(a) on ``mesh``: one float32 bsp step, the serve and the cache
        against the one-card ones (the parent's serve; the step in
        turns)."""
        def own(t_, n_):
            """This rank's data block of ``n_`` requests' rows of ``t_``."""
            b_ = n_ // mesh.size_of("data")
            return t_[mesh.coords["data"] * b_:(mesh.coords["data"] + 1)
                      * b_]
        cut = _fam_cut(arch, "float32")
        for mode in ("train", "serve"):
            sharding.check_layout(cut, mesh, mode=mode)
        specs = sharding.leaf_specs(lsteps.param_shape(cut), mesh)
        batch = _fam_batch(cut, FAM_B, FAM_T, 170, dev)
        whole = draw(cut)
        state = lsteps.make_train_state(whole, bsp, 1, mesh=mesh)
        params = pytree.tree_map(lambda t_: t_.clone(),
                                 sharding.local_params(whole, mesh))
        del whole
        torch.cuda.empty_cache()
        reset()
        box = []
        syncs = count_syncs(lambda: box.append(lsteps.make_train_step(
            cut, bsp, mesh=mesh, lr=TRAIN_LR, remat=True)(state, batch,
                                                         1)))
        new, metrics = box[0]
        a = {"loss": float(metrics["loss"]), "syncs": syncs,
             "launches": launched()}
        mine = [t_ for k_ in ("params", "vel")
                for t_ in pytree.leaves(new[k_])]
        del state, box, new
        mark(f"(a) {arch} the mesh step on {tuple(mesh.shape.values())}")
        # the serve against the parent's one-card serve
        pre, dec, cache = _fam_serve(cut, params, dev, mesh)
        a["prefill"] = _row_rel(pre, own(ref[f"{arch}/prefill"],
                                         FAM_PRE_B).to(dev))
        a["decode"] = max(_row_rel(dec[t], own(
            ref[f"{arch}/decode"][t], MESH_B).to(dev))
            for t in range(FAM_DECODE))
        whole_c = lm.init_cache(cut, MESH_B, MESH_CACHE, device="meta")
        c_specs = pytree.leaves_like(sharding.cache_shardings(
            whole_c, mesh, batch_sharded=True), whole_c)
        a["cache"] = {}
        for (path, t_), s_, w_ in zip(
                pytree.leaves_with_paths(cache), c_specs,
                ref[f"{arch}/cache"], strict=True):
            g_ = sharding.gather_leaf(t_, s_, mesh)
            a["cache"][path] = (bool(torch.equal(g_.cpu(), w_))
                                if w_.dtype == torch.int32 else
                                _rel(g_, w_.to(dev)))
        del params, pre, dec, cache
        mark(f"(a) {arch} the mesh serve on {tuple(mesh.shape.values())}")

        def one_card():
            a["free_gib"] = torch.cuda.mem_get_info(dev)[0] / 2 ** 30
            torch.cuda.reset_peak_memory_stats(dev)
            whole_ = draw(cut)
            ops.flash_attention_bthd = fa_kernel   # not the mesh's
            new_, m_ = lsteps.make_train_step(cut, bsp, lr=TRAIN_LR,
                                              remat=True)(
                lsteps.make_train_state(whole_, bsp, 1), batch, 1)
            ops.flash_attention_bthd = fa_recorded
            del whole_
            want = [t_ for k_ in ("params", "vel")
                    for t_ in pytree.leaves(new_[k_])]
            a["sq"] = _p15_sq(mine, _intra_blocks(
                want, list(specs) * 2, mesh, slice(0, 1)),
                [(None,) + tuple(s_) for s_ in specs] * 2, mesh)
            a["one_card_loss"] = float(m_["loss"])
            a["one_card_peak_gib"] = (torch.cuda.max_memory_allocated(dev)
                                      / 2 ** 30)
            del new_, want
        _turns(one_card, rank, world)
        del mine
        mark(f"(a) {arch} the one-card step in turns")
        return a

    mesh = make_mesh(FAM_MESH, device=dev)
    out["coords"] = mesh.coords
    # ----------------------------------------------------------------- (a)
    with tf32_off():
        for arch in FAM_ARCHS:
            out["a"][arch] = step_and_serve(arch, mesh)
    # ------------------------------------------------------------ (d), (e)
    # what an axis does not divide: (a) re-meshed, and one request whole
    t_new = time.perf_counter()
    out["d"], out["e"] = {}, {}
    with tf32_off():
        mesh4 = make_mesh(UNEVEN_MESH, device=dev)
        out["coords4"] = mesh4.coords
        for arch in UNEVEN_ARCHS:
            out["d"][arch] = step_and_serve(arch, mesh4)
        for arch in ONE_ARCHS:
            cut = _one_cut(arch)
            whole = draw(cut)
            params = pytree.tree_map(lambda t_: t_.clone(),
                                     sharding.local_params(whole, mesh))
            del whole
            cache = pytree.tree_map(lambda t_: t_.clone(),
                                    sharding.local_cache(
                                        _one_cache(cut, dev), mesh,
                                        batch_sharded=False))
            blocks = {p_: list(t_.shape) for p_, t_ in
                      pytree.leaves_with_paths(cache)
                      if p_.startswith("body/0/")}
            logits, syncs = _one_serve(cut, params, cache, dev, mesh)
            out["e"][arch] = {
                "decode": [_row_rel(logits[i], ref[f"{arch}/one"][i].to(dev))
                           for i in range(ONE_DECODE)],
                "syncs": syncs, "blocks": blocks}
            del params, cache, logits
            torch.cuda.empty_cache()
            mark(f"(e) {arch} one request over {FAM_MESH}")
    out["new_checks_s"] = time.perf_counter() - t_new
    # ----------------------------------------------------------------- (b)
    for arch in FAM_ARCHS:
        cfg = _fam_cut(arch, "bfloat16")
        batch = _fam_batch(cfg, TRAIN_B, TRAIN_T, 171, dev, torch.bfloat16)
        out["b"][arch] = _timed_train(cfg, mesh, batch, "dense", FAM_TIMED,
                                      dev)
        mark(f"(b) {arch} bf16 timed")
    # ----------------------------------------------------------------- (c)
    for arch in FAM_SERVE:
        cfg = _fam_cut(arch, "bfloat16")
        torch.cuda.empty_cache()
        whole = draw(cfg)
        params = pytree.tree_map(lambda t_: t_.clone(),
                                 sharding.local_params(whole, mesh))
        del whole
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        toks = torch.from_numpy(np.random.default_rng(172).integers(
            0, cfg.vocab, (FAM_SERVE_B, PREFILL_T))).to(dev)
        fed = torch.from_numpy(np.random.default_rng(173).integers(
            0, cfg.vocab, (FAM_SERVE_B, FAM_SERVE_STEPS + 1)))
        prefill = lsteps.make_prefill_step(cfg, mesh=mesh)
        step = lsteps.make_serve_step(cfg, mesh=mesh)
        c = {"prefill_ms": [], "decode_ms": []}
        with torch.inference_mode():
            for i in range(2):               # a warm-up call, a timed one
                reset()
                torch.cuda.synchronize()
                mesh.barrier()
                t0 = time.perf_counter()
                logits = prefill(params, {"tokens": toks})
                torch.cuda.synchronize()
                c["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
            c["prefill_launches"] = launched()
            c["prefill_finite"] = bool(torch.isfinite(logits).all())
            cache = lm.init_cache(cfg, FAM_SERVE_B, MESH_CACHE, device=dev,
                                  mesh=mesh)
            reset()
            for t in range(FAM_SERVE_STEPS):
                batch = _decode_batch(fed, t, dev)
                torch.cuda.synchronize()
                mesh.barrier()
                t0 = time.perf_counter()
                if t < FAM_SERVE_STEPS - 1:
                    tok, cache = step(params, cache, batch)
                else:                        # the last step's host syncs
                    box = []
                    c["decode_syncs"] = count_syncs(lambda: box.append(
                        step(params, cache, batch)))
                    tok, cache = box[0]
                torch.cuda.synchronize()
                c["decode_ms"].append((time.perf_counter() - t0) * 1e3)
            c["decode_launches"] = launched()
            c["decode_tokens_in_vocab"] = bool(((tok >= 0) & (
                tok < cfg.vocab)).all())
        c["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del params, cache, box, logits, tok
        gc.collect()
        torch.cuda.empty_cache()
        out["c"][arch] = c
        mark(f"(c) {arch} bf16 serving")
    ops.flash_attention_bthd = fa_kernel
    out["fa_calls"] = sorted(fa_calls.items())
    return out


def families_phase(dev: torch.device):
    """Phase 16: the SSM, RG-LRU hybrid, enc-dec and VLM families trained
    and served inside a pod.  The parent runs (a)'s one-card serves and
    their rounding floors, then ``procs.spawn`` starts four gloo ranks on
    the card (``families_rank``), then holds ``flash_attention`` at every
    shape, dtype and mask the ranks called it at against its plain
    version; every check is gated here, after every number is printed.
    Returns (summary, the kernels' phase 16 figures by kernel name)."""
    import shutil
    from repro_torch import pytree
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import procs
    from repro_torch.models import model as lm
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    summary, failures = {}, []

    def check(ok, what):
        if not ok:
            failures.append(what)
            print(f"phase 16 FAILED: {what}", flush=True)

    # (a)'s one-card serves and each model's rounding floor (phase 14's)
    saved, floors = {}, {}
    with tf32_off():
        for arch in FAM_ARCHS:
            cut = _fam_cut(arch, "float32")
            p = lm.init_model(torch.Generator(device=dev).manual_seed(0),
                              cut, dev)
            pre, dec, cache = _fam_serve(cut, p, dev)
            saved[f"{arch}/prefill"] = pre.cpu()
            saved[f"{arch}/decode"] = dec.cpu()
            saved[f"{arch}/cache"] = [t_.cpu() for t_ in
                                      pytree.leaves(cache)]
            del cache
            floor = {"prefill": 0.0, "decode": 0.0}
            for seed in (7, 8):
                g_ = torch.Generator(device=dev).manual_seed(seed)
                moved = pytree.tree_map(lambda t_: t_ * (
                    1 + 2 ** -24 * torch.randn(t_.shape, generator=g_,
                                               device=dev)), p)
                pre_w, dec_w, _ = _fam_serve(cut, moved, dev)
                del moved
                floor = {"prefill": max(floor["prefill"],
                                        _row_rel(pre_w, pre)),
                         "decode": max(floor["decode"],
                                       _row_rel(dec_w, dec))}
            floors[arch] = floor
            del p, pre, dec
            torch.cuda.empty_cache()
    # (e)'s one-card decodes of one request on the seeded cache, and their
    # floors
    t_new = time.perf_counter()
    with tf32_off():
        for arch in ONE_ARCHS:
            cut = _one_cut(arch)
            p = lm.init_model(torch.Generator(device=dev).manual_seed(0),
                              cut, dev)
            dec, _ = _one_serve(cut, p, _one_cache(cut, dev), dev)
            saved[f"{arch}/one"] = dec.cpu()
            floor = 0.0
            for seed in (7, 8):
                g_ = torch.Generator(device=dev).manual_seed(seed)
                moved = pytree.tree_map(lambda t_: t_ * (
                    1 + 2 ** -24 * torch.randn(t_.shape, generator=g_,
                                               device=dev)), p)
                dec_w, _ = _one_serve(cut, moved, _one_cache(cut, dev), dev)
                del moved
                floor = max(floor, _row_rel(dec_w, dec))
            floors[arch, "one"] = floor
            del p, dec
            torch.cuda.empty_cache()
    summary["new_one_card_s"] = time.perf_counter() - t_new
    out_dir = ROOT / "build" / "phase16"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    ref_path = str(out_dir / "one_card.pt")
    torch.save(saved, ref_path)
    del saved
    summary["one_card_s"] = time.perf_counter() - t_phase

    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 16: the parent holds "
          f"{torch.cuda.memory_reserved(dev) / 2 ** 30:.2f} GiB of the card "
          "(reserved) as the ranks start", flush=True)
    t0 = time.perf_counter()
    ranks = procs.spawn(families_rank, 4, backend="gloo", device=dev,
                        timeout=FAM_TIMEOUT, args=(ref_path,))
    summary["spawn_s"] = time.perf_counter() - t0
    shutil.rmtree(out_dir, ignore_errors=True)

    # the kernel at every shape, dtype and mask the ranks called it at,
    # against its plain version on the same inputs
    calls = {}
    for r_ in ranks:
        for key, n_ in r_["fa_calls"]:
            calls[key] = calls.get(key, 0) + n_
    gen = torch.Generator(device=dev).manual_seed(16)
    summary["fa"] = []
    for (qs, ks, vs, dt, kw), n_ in sorted(calls.items()):
        dtype, kw = getattr(torch, dt), dict(kw)
        q, k, v = (torch.randn(s_, generator=gen, device=dev).to(dtype)
                   for s_ in (qs, ks, vs))
        with tf32_off():
            want = kref.flash_attention_bthd_ref(q, k, v, **kw).float()
        err = (ops.flash_attention_bthd(q, k, v, **kw).float()
               - want).abs()
        f = {"q": list(qs), "k": list(ks), "dtype": dt, "mask": kw,
             "calls_by_the_ranks": n_, "max_abs_err": float(err.max()),
             "mean_abs_err": float(err.mean())}
        if dtype == torch.bfloat16:
            ok = (f["max_abs_err"] <= FA_PREFILL_TOL
                  and f["mean_abs_err"] <= FA_PREFILL_MEAN_TOL)
            tol = f"max {FA_PREFILL_TOL}, mean {FA_PREFILL_MEAN_TOL}"
        else:
            ok = bool((err <= FAM_FA_F32_TOL * (1 + want.abs())).all())
            tol = f"{FAM_FA_F32_TOL} (1 + |plain|)"
        summary["fa"].append(f)
        print(f"flash_attention at q {qs}, k {ks} (B, T, heads, D), {dt}, "
              f"{kw}, as the ranks called it {n_} times: against the plain "
              f"version max |err| {f['max_abs_err']:.3g}, mean "
              f"{f['mean_abs_err']:.3g} (tol {tol})", flush=True)
        check(ok, ("flash_attention", f))
        del q, k, v, want, err
    check({f["dtype"] for f in summary["fa"]} == {"float32", "bfloat16"},
          ("flash_attention: the ranks' calls", summary["fa"]))

    def rel(num_den):
        return (num_den[0] / max(num_den[1], 1e-300)) ** 0.5

    # (a), and (d): (a) re-meshed where an axis does not divide a width
    summary["a"], summary["d"] = {}, {}
    for part, mesh_shape, arch in (
            [("a", FAM_MESH, a_) for a_ in FAM_ARCHS]
            + [("d", UNEVEN_MESH, a_) for a_ in UNEVEN_ARCHS]):
        cut = _fam_cut(arch, "float32")
        rs = [r_[part][arch] for r_ in ranks]
        a0 = rs[0]
        gate = {k_: max(MESH_F32_TOL, MESH_WITNESS_X * floors[arch][k_])
                for k_ in ("prefill", "decode")}
        a = {"params_vel_rel_l2": rel([sum(r_["sq"][j] for r_ in rs)
                                       for j in (0, 1)]),
             "loss": a0["loss"], "one_card_loss": a0["one_card_loss"],
             "syncs_by_rank": [r_["syncs"] for r_ in rs],
             "launches": a0["launches"],
             "prefill": max(r_["prefill"] for r_ in rs),
             "decode": max(r_["decode"] for r_ in rs),
             "cache": a0["cache"], "rounding_floor": floors[arch],
             "gates": gate,
             "one_card_peak_gib_by_rank": [r_["one_card_peak_gib"]
                                           for r_ in rs],
             "free_gib_before_by_rank": [r_["free_gib"] for r_ in rs]}
        a["loss_rel_diff"] = abs(a["loss"] - a["one_card_loss"]) / abs(
            a["one_card_loss"])
        summary[part][arch] = a
        floats = {k_: v_ for k_, v_ in a["cache"].items()
                  if not isinstance(v_, bool)}
        print(f"({part}) {arch}, float32 (TF32 off), full width, "
              f"{FAM_LAYERS[arch]}-layer cut"
              + (f" ({FAM_LAYERS[arch]} encoder layers)" if cut.encoder
                 else "")
              + f", {mesh_shape} of gloo ranks on the card: one bsp step on "
              f"{FAM_B} x {FAM_T} tokens against the one-card step, the "
              f"gathered params and velocities' relative L2 "
              f"{a['params_vel_rel_l2']:.3g} (gate {INTRA_L2_TOL}), loss "
              f"{a['loss']:.9g} against {a['one_card_loss']:.9g} (relative "
              f"{a['loss_rel_diff']:.3g}, gate {MOE_LOSS_TOL}); host syncs "
              f"by rank {a['syncs_by_rank']}, launches a rank "
              f"{a['launches']}; the serve, the largest logit row's "
              f"relative L2 over the ranks: prefill {FAM_PRE_B} x "
              f"{FAM_PRE_T} {a['prefill']:.3g}, {FAM_DECODE} decode steps "
              f"of {MESH_B} requests {a['decode']:.3g} (gates "
              + json.dumps({k_: float(f"{v_:.3g}") for k_, v_ in
                            gate.items()}) + ", the floor "
              + json.dumps({k_: float(f"{v_:.3g}") for k_, v_ in
                            floors[arch].items()})
              + "); the cache gathered whole, relative L2 by leaf (the "
              "largest) " + f"{max(floats.values()):.3g}, positions equal: "
              + str(all(v_ for v_ in a["cache"].values()
                        if isinstance(v_, bool)))
              + "; the one-card step in turns, a rank at a time: its peak "
              f"{max(a['one_card_peak_gib_by_rank']):.2f} GiB allocated, "
              "the card's least free memory before it "
              f"{min(a['free_gib_before_by_rank']):.2f} GiB", flush=True)
        check(a["params_vel_rel_l2"] <= INTRA_L2_TOL,
              (f"({part}) step", arch, a))
        check(a["loss_rel_diff"] <= MOE_LOSS_TOL, (f"({part}) loss", arch, a))
        check(a["launches"].get("flash_attention", 0) == _fa_per_step(cut),
              (f"({part}) launches", arch, a["launches"]))
        check(a["prefill"] <= gate["prefill"], (f"({part}) prefill", arch, a))
        check(a["decode"] <= gate["decode"], (f"({part}) decode", arch, a))
        check(all(v_ is True if isinstance(v_, bool) else
                  v_ <= gate["decode"] for v_ in a["cache"].values()),
              (f"({part}) cache", arch, a["cache"]))

    # (e)
    summary["e"] = {}
    for arch in ONE_ARCHS:
        rs = [r_["e"][arch] for r_ in ranks]
        gate = max(MESH_F32_TOL, MESH_WITNESS_X * floors[arch, "one"])
        e = {"decode_by_step": [max(r_["decode"][i] for r_ in rs)
                                for i in range(ONE_DECODE)],
             "syncs_by_rank": [r_["syncs"] for r_ in rs],
             "rank0_blocks": rs[0]["blocks"],
             "rounding_floor": floors[arch, "one"], "gate": gate}
        summary["e"][arch] = e
        print(f"(e) {arch}, float32 (TF32 off), full width, "
              f"{ONE_LAYERS}-layer cut, one long_500k request whole on "
              f"every rank of {FAM_MESH}, each decode cache's length over "
              f"data, seeded as after {ONE_T0} tokens: {ONE_DECODE} decode "
              "steps against the one-card decode on the same cache, the "
              "logit row's relative L2 by step (the largest over the "
              f"ranks) {[float(f'{x_:.3g}') for x_ in e['decode_by_step']]}"
              f" (gate {gate:.3g}, the floor {e['rounding_floor']:.3g}); "
              f"host syncs a step by rank {e['syncs_by_rank']}; rank 0's "
              f"blocks of layer 0's cache {json.dumps(e['rank0_blocks'])}",
              flush=True)
        check(max(e["decode_by_step"]) <= gate, ("(e) decode", arch, e))
        check(all(n_ == 0 for r_ in rs for n_ in r_["syncs"]),
              ("(e) syncs", arch, e["syncs_by_rank"]))
    summary["new_checks_s"] = summary["new_one_card_s"] + max(
        r_["new_checks_s"] for r_ in ranks)
    print(f"phase 16, the checks of what an axis does not divide ((d), (e) "
          f"and their one-card runs): {summary['new_checks_s']:.2f} s "
          f"(the ranks' {max(r_['new_checks_s'] for r_ in ranks):.2f} s, "
          f"the parent's one-card decodes {summary['new_one_card_s']:.2f} "
          "s)", flush=True)

    # (b)
    summary["b"] = {}
    for arch in FAM_ARCHS:
        cfg = _fam_cut(arch, "bfloat16")
        rs = [r_["b"][arch] for r_ in ranks]
        slow = max(r_["median_ms"] for r_ in rs)
        c0 = rs[0]["collectives"]
        extra = (cfg.encoder.n_frames if cfg.encoder else
                 cfg.modality.n_tokens if cfg.modality.kind == "vision"
                 else 0)
        s = {"median_ms_by_rank": [r_["median_ms"] for r_ in rs],
             "wall_ms_by_rank": [r_["wall_ms"] for r_ in rs],
             "slowest_median_ms": slow,
             "tokens_per_s": TRAIN_B * TRAIN_T / (slow / 1e3),
             "peak_gb_by_rank": [r_["peak_gb"] for r_ in rs],
             "syncs_per_step_by_rank": [r_["syncs_per_step"] for r_ in rs],
             "launches_per_step": rs[0]["launches_per_step"],
             "fa_plan": _fa_per_step(cfg), "collectives_rank0": c0,
             "losses": rs[0]["losses"], "warmup_ms_rank0": rs[0][
                 "warmup_ms"],
             "warmup_attn_bwd_ms_rank0": rs[0]["warmup_attn_bwd_ms"]}
        summary["b"][arch] = s
        by = {k_: [v_["calls"], round(v_["bytes"] / 1e6, 1),
                   round(v_["ms"], 1)] for k_, v_ in c0["by_name"].items()}
        print(f"(b) {arch}, bf16, full width, {FAM_LAYERS[arch]}-layer "
              f"cut, remat, {FAM_MESH} of gloo ranks on the card, "
              f"{TRAIN_B} x {TRAIN_T} tokens a step"
              + (f" (and {extra} {'frames' if cfg.encoder else 'patches'} "
                 "a sequence)" if extra else "")
              + f", bsp: {slow:.1f} ms a step (the slowest rank's median of "
              f"{FAM_TIMED}), {s['tokens_per_s']:.0f} tokens/s, peak "
              f"{max(s['peak_gb_by_rank']):.2f} GB a rank, host syncs a "
              f"step {s['syncs_per_step_by_rank']}, launches a step a rank "
              f"{s['launches_per_step']} (flash_attention by the layer "
              f"plan {s['fa_plan']}); the first timed step's collectives "
              f"(rank 0): {c0['calls']} calls handed {c0['bytes'] / 1e9:.3f}"
              f" GB, {c0['ms']:.1f} ms of the host's wall inside them "
              f"({c0['ms'] / rs[0]['wall_ms'][0]:.3f} of the step), by "
              f"collective [calls, MB, ms] {json.dumps(by)}; the warm-up "
              f"step (rank 0) {s['warmup_ms_rank0']:.1f} ms, of it the "
              f"plain attention backward {s['warmup_attn_bwd_ms_rank0']:.1f}"
              f" ms; losses {[round(x_, 4) for x_ in s['losses']]}",
              flush=True)
        for r_ in rs:
            check(r_["finite"] and np.all(np.isfinite(r_["losses"])),
                  ("(b)", arch, "finite"))
            check(r_["syncs_per_step"] == 0, ("(b)", arch, "syncs"))
            check(r_["launches_per_step"].get("flash_attention", 0) ==
                  s["fa_plan"], ("(b)", arch, r_["launches_per_step"]))

    # (c)
    summary["c"] = {}
    for arch in FAM_SERVE:
        rs = [r_["c"][arch] for r_ in ranks]
        pre_ms = max(r_["prefill_ms"][1] for r_ in rs)
        dec_ms = max(float(np.median(r_["decode_ms"][1:-1])) for r_ in rs)
        s = {"prefill_ms_by_rank": [r_["prefill_ms"] for r_ in rs],
             "decode_ms_by_rank": [r_["decode_ms"] for r_ in rs],
             "prefill_ms": pre_ms, "decode_ms": dec_ms,
             "prefill_tokens_per_s": FAM_SERVE_B * PREFILL_T / (pre_ms /
                                                                1e3),
             "decode_tokens_per_s": FAM_SERVE_B / (dec_ms / 1e3),
             "decode_syncs_by_rank": [r_["decode_syncs"] for r_ in rs],
             "prefill_launches": rs[0]["prefill_launches"],
             "peak_gb_by_rank": [r_["peak_gb"] for r_ in rs]}
        summary["c"][arch] = s
        print(f"(c) {arch}, bf16, full width, {FAM_LAYERS[arch]}-layer cut, "
              f"served on {FAM_MESH}: a {FAM_SERVE_B} x {PREFILL_T} prefill "
              f"{pre_ms:.1f} ms a call (the slowest rank's, after a "
              "warm-up), "
              f"{s['prefill_tokens_per_s']:.0f} tokens/s, launches a call a "
              f"rank {s['prefill_launches']}; decode of {FAM_SERVE_B} "
              f"requests over {MESH_CACHE} slots {dec_ms:.1f} ms a step "
              f"(the slowest rank's median of {FAM_SERVE_STEPS - 2} after a "
              "warm-up), "
              f"{s['decode_tokens_per_s']:.1f} tokens/s, host syncs a "
              f"decode step by rank {s['decode_syncs_by_rank']}; peak "
              f"{max(s['peak_gb_by_rank']):.2f} GB a rank", flush=True)
        for r_ in rs:
            check(r_["decode_syncs"] == 0, ("(c)", arch, "syncs"))
            check(r_["prefill_finite"] and r_["decode_tokens_in_vocab"],
                  ("(c)", arch, "finite"))
    summary["rank_walls_s"] = ranks[0]["walls_s"]
    summary["wall_s"] = time.perf_counter() - t_phase
    walls = {k_: round(v_, 1) for k_, v_ in summary["rank_walls_s"].items()}
    print(f"phase 16: {summary['wall_s']:.2f} s (the kernel checks and "
          f"one-card serves {summary['one_card_s']:.1f} s; rank 0's parts: "
          f"{json.dumps(walls)})", flush=True)
    assert not failures, failures
    kern = {"flash_attention": {
        "intrapod_families_launches_per_step_a_rank": {
            arch: summary["b"][arch]["launches_per_step"].get(
                "flash_attention", 0) for arch in FAM_ARCHS},
        "intrapod_families_prefill_launches_a_rank": {
            arch: summary["c"][arch]["prefill_launches"].get(
                "flash_attention", 0) for arch in FAM_SERVE},
        "intrapod_families_shapes": summary["fa"]}}
    return summary, kern



# ---------------------------------------------------------------------------
# Phase 17: the dry-run stand-in against the card
# ---------------------------------------------------------------------------

#: phase 12's strategies whose first step rank 0 records for phase 17 (b)
STANDIN_RUNS = ("bsp", "dpsgd")
#: the stand-in's per-tensor slack against the caching allocator, which
#: rounds each block up to a multiple of 512 bytes
ALLOC_ROUND = 512
#: how long phase 17 waits for its sweep beyond phase 12 (seconds)
SWEEP_TIMEOUT = 300


class StandinSweep(threading.Thread):
    """Phase 17 (a): the stand-in's audit matrix (``dryrun.iter_combos()``:
    the reduced qwen3-0.6b on ``SWEEP_MESH``, 22 rows), traced on ``meta``
    tensors on the host in a thread beside phase 12's gloo ranks, while
    the parent waits for them, each trace also under the step audit
    (``dryrun_one``'s ``"step_audit"``).  Every row is kept, a failed one
    with its error; ``rows``, ``seconds`` and ``error`` (an exception that
    ended the thread) are read after ``join``."""

    def __init__(self):
        super().__init__(name="standin-sweep", daemon=True)
        self.rows, self.seconds, self.error = [], None, None

    def run(self):
        from repro_torch.launch import dryrun
        t0 = time.perf_counter()
        try:
            mesh = dryrun._parse_mesh(dryrun.SWEEP_MESH)
            for shape, strategy, topology in dryrun.iter_combos():
                try:
                    self.rows.append(dryrun.dryrun_one(
                        dryrun.SWEEP_ARCH, shape, strategy=strategy,
                        topology=topology, reduced=True, mesh=mesh,
                        verbose=False))
                except Exception as e:  # a failed row is kept, as the
                    #                     stand-in's sweep keeps it
                    self.rows.append({"shape": shape, "strategy": strategy,
                                      "topology": topology, "ok": False,
                                      "error": f"{type(e).__name__}: {e}"})
        except BaseException as e:  # reported by standin_phase
            self.error = f"{type(e).__name__}: {e}"
        self.seconds = time.perf_counter() - t0


def standin_phase(sweep: StandinSweep, dist12: dict, smi: str) -> dict:
    """Phase 17: (a) the sweep's rows, each ``ok``, each gossip row's
    exchange on the pod axis alone, above 0 bytes and free of findings;
    (b) phase 12's bsp and dpsgd steps (qwen3-0.6b at full width cut to
    ``DIST_TIMED_LAYERS``, bf16, 2 pods of TRAIN_B x TRAIN_T, remat) traced
    by the stand-in for rank 0 of a ``MetaMesh((2, 1, 1))``, against rank
    0's run: the collective records equal entry for entry, each kernel's
    launches over the step equal the stand-in's count, the stand-in's
    state and operand bytes within ``ALLOC_ROUND`` a tensor of the bytes
    rank 0's state and operands asked the allocator for
    (``requested_bytes``; what ``memory_allocated`` added, the allocator's
    blocks, is reported beside it), and its rows of the batch of the rank's
    shapes (phase 12 feeds int64 token ids where the specs, and so the
    stand-in, have int32: the dtypes are reported).  The
    stand-in's peak against ``max_memory_allocated`` and its largest
    roofline term against the measured median step are reported, not
    gated: its bytes are unfused traffic and its rates the data sheet's.
    Adds no spawn."""
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun, meta
    t_phase = time.perf_counter()
    sweep.join(timeout=SWEEP_TIMEOUT)
    waited = time.perf_counter() - t_phase
    assert not sweep.is_alive(), "the stand-in sweep did not finish"
    assert sweep.error is None, sweep.error
    rows = sweep.rows
    gossip = [r_ for r_ in rows if r_.get("strategy") in ("dpsgd", "adpsgd")]
    print(f"(a) the stand-in's audit sweep (reduced {dryrun.SWEEP_ARCH} on "
          f"{dryrun.SWEEP_MESH}): {sum(r_['ok'] for r_ in rows)} of "
          f"{len(rows)} rows ok in {sweep.seconds:.2f} s on the host beside "
          f"phase 12 (phase 17 waited {waited:.2f} s for it); {len(gossip)} "
          "gossip rows", flush=True)
    assert len(rows) == 22 and all(r_["ok"] for r_ in rows), [
        r_.get("error") for r_ in rows if not r_["ok"]]
    for r_ in gossip:
        pex = r_["pod_exchange"]
        assert pex["pod_axis_only"] and pex[
            "permute_cross_gbytes_per_dev"] > 0, (r_["strategy"], pex)
        assert r_["audit"]["findings"] == [], r_["audit"]["findings"]
    audited = [r_["step_audit"] for r_ in rows]
    print(f"(a) the step audit over the sweep's traces: "
          f"{sum(a_['ok'] for a_ in audited)} of {len(audited)} rows "
          f"without a finding ({sum(a_['n_eqns'] for a_ in audited)} ops, "
          f"{sum(a_['n_collectives'] for a_ in audited)} collectives)",
          flush=True)
    for a_ in audited:
        assert a_["findings"] == [], (a_["tag"], a_["findings"])
    out = {"sweep": {"rows": len(rows), "ok": sum(r_["ok"] for r_ in rows),
                     "seconds": sweep.seconds, "waited_s": waited},
           "runs": {}}
    cfg = dataclasses.replace(get_config("qwen3-0.6b"),
                              n_layers=DIST_TIMED_LAYERS)
    shape = InputShape("phase 12", TRAIN_T, TRAIN_PODS * TRAIN_B, "train")
    for strategy in STANDIN_RUNS:
        real = dist12["standin"][strategy]
        mesh = meta.MetaMesh((DIST_RANKS, 1, 1))
        step, args, notes = dryrun.build_step(
            cfg, shape, strategy=strategy, topology="ring", mesh=mesh)
        trace = meta.trace_step(step, args, mesh)
        rep = dryrun.dryrun_one(cfg, shape, strategy=strategy,
                                topology="ring",
                                mesh=meta.MetaMesh((DIST_RANKS, 1, 1)),
                                verbose=False)
        got = [c_.key() for c_ in trace.collectives]
        want = [tuple(tuple(x_) if isinstance(x_, list) else x_ for x_ in k_)
                for k_ in real["collectives"]]
        launches = {k_: int(v_["launches"])
                    for k_, v_ in trace.cost.kernels.items()}
        arg = rep["memory"]["argument_size_in_bytes"]
        held = meta.block_bytes((args[0], args[3:]))      # state, operands
        slack = real["arg_bytes"] - held
        rows = {k_: (s_, str(args[1][k_].dtype)) for k_, s_ in
                dryrun.batch_blocks(args[1], mesh, pod_stacked=True).items()}
        peak = arg + rep["memory"]["temp_size_in_bytes"]
        ro = rep["roofline"]
        term = max(("compute", "memory", "collective"),
                   key=lambda k_: ro[f"t_{k_}_ms"])
        median = dist12["strategies"][strategy]["median_ms_by_rank"][0]
        sa = rep["step_audit"]
        assert sa["findings"] == [], (strategy, sa["findings"])
        r = {"collectives": len(got), "records_equal": got == want,
             "step_audit": {"ops": sa["n_eqns"],
                            "findings": len(sa["findings"])},
             "launches": launches, "rank_launches": real["launches"],
             "argument_bytes": arg, "state_operand_bytes": held,
             "rank_state_operand_bytes": real["arg_bytes"],
             "rank_state_operand_allocated_bytes": real["arg_alloc_bytes"],
             "rows": rows, "rank_rows": real["rows"],
             "argument_tensors": real["arg_tensors"],
             "standin_peak_bytes": peak,
             "rank_max_allocated_bytes": real["max_allocated"],
             "rank_step_rise_bytes": real["step_rise"],
             "roofline_ms": {k_: ro[f"t_{k_}_ms"] for k_ in
                             ("compute", "memory", "collective")},
             "largest_term": term, "rank_median_step_ms": median}
        out["runs"][strategy] = r
        print(f"(b) {strategy}: {len(got)} collectives on rank 0, the "
              f"stand-in's records {'equal' if got == want else 'DIFFER'} "
              f"entry for entry; launches over the step: stand-in "
              f"{launches}, rank 0 {real['launches']}; the state's and "
              f"operands' bytes: stand-in {held}, rank 0 requested "
              f"{real['arg_bytes']} ({real['arg_tensors']} tensors, slack "
              f"{slack} B) and allocated {real['arg_alloc_bytes']} "
              f"(blocks); the rows of the batch: stand-in {rows}, rank 0 "
              f"{real['rows']}; argument bytes in all {arg}; peak: "
              f"stand-in {peak / 1e9:.3f} GB (arguments + its live temps, "
              f"unfused) against the rank's max_memory_allocated "
              f"{real['max_allocated'] / 1e9:.3f} GB (the step's rise "
              f"{real['step_rise'] / 1e9:.3f} GB); the stand-in's largest "
              f"roofline term {term} {ro[f't_{term}_ms']:.3f} ms (c "
              f"{ro['t_compute_ms']:.3f} / m {ro['t_memory_ms']:.3f} / x "
              f"{ro['t_collective_ms']:.3f}) against the measured median "
              f"step {median:.1f} ms on {smi} (gloo, two ranks sharing the "
              "card)", flush=True)
        assert got == want, (strategy, got, want)
        assert launches == real["launches"], (strategy, launches,
                                              real["launches"])
        assert 0 <= slack < ALLOC_ROUND * real["arg_tensors"], (
            strategy, held, real["arg_bytes"], real["arg_tensors"])
        assert {k_: tuple(v_[0]) for k_, v_ in rows.items()} == {
            k_: tuple(v_[0]) for k_, v_ in real["rows"].items()}, (
            rows, real["rows"])
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 17: {out['wall_s']:.2f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    import torch.nn.functional as F
    from repro_torch.configs.base import CommConfig, FabricConfig
    from repro_torch.configs.cnn_zoo import CNN_ZOO
    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.core import trainer
    from repro_torch.core.algorithms.base import tree_leaf_order
    from repro_torch.core.partition import partition_label_skew
    from repro_torch.data.synthetic import synth_images
    from repro_torch.analysis import step_audit
    from repro_torch.benchmarks import kernels_bench
    from repro_torch.benchmarks import report as bench_report
    from repro_torch.examples import serve_decode
    from repro_torch.kernels import build, dgc_topk, ops, ref
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import rglru as rglru_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.attention import chunked_attention
    from repro_torch.models.cnn import init_cnn, reference_perm
    from repro_torch.topology import build_schedule

    dev = torch.device("cuda")

    # ---------------------------------------------------------------- 1
    phase(1, "device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name}; cuda devices: {torch.cuda.device_count()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}; default TF32 flags: matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN "
          f"{torch.backends.cudnn.allow_tf32}")
    print(smi, flush=True)

    # ---------------------------------------------------------------- 2
    phase(2, "build")
    t0 = time.perf_counter()
    logs = build.build()
    print(f"built {sorted(logs) or 'nothing (libraries up to date)'} in "
          f"{time.perf_counter() - t0:.2f} s")
    for kname, log in sorted(logs.items()):
        print("\n".join(ptxas_lines(kname, log)))
    for kname in build.KERNELS:
        build.load(kname)
    sys.stdout.flush()

    # ---------------------------------------------------------------- 3
    phase(3, "kernels against their plain versions (TF32 off)")
    cfg = CNN_ZOO["gn-lenet"]
    params0, _ = init_cnn(torch.Generator().manual_seed(0), cfg)
    leaf_shapes = [(K,) + tuple(t.shape) for t in params0.values()]
    assert len(leaf_shapes) == 16, leaf_shapes
    n_params = sum(t.numel() for t in params0.values())
    assert n_params == 96_682, n_params
    gen = torch.Generator().manual_seed(1)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    gaia_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in leaf_shapes + [(1_000_003,)]:
            v = randn(*shape, scale=0.01).to(dtype)
            w = randn(*shape, scale=0.3).to(dtype)
            t = torch.tensor(0.1, device=dev)
            sel, cnt = ops.gaia_select(v, w, t)
            rsel, rcnt = ref.gaia_select_ref(v, w, t)
            torch.cuda.synchronize()
            assert torch.equal(sel != 0, rsel != 0), (shape, dtype)
            assert torch.equal(sel, rsel), (shape, dtype)
            assert int(cnt) == int(rcnt), (shape, dtype, int(cnt), int(rcnt))
            gaia_err = max(gaia_err, float((sel.float() - rsel.float())
                                           .abs().max()))
    print(f"gaia_select: bit-exact at {len(leaf_shapes) + 1} shapes x "
          "{float32, bfloat16}")
    # the training path's launch: GN-LeNet's 16 tensors (in the reference's
    # leaf order, with their counter layouts for rand-k) in one launch
    gn_names = tree_leaf_order(params0)
    gn_shapes = [(K,) + tuple(params0[n_].shape) for n_ in gn_names]
    gn_perms = [reference_perm(n_) for n_ in gn_names]
    ragged = [(1,), (37,), (1_000_003,)]
    for dtype in (torch.float32, torch.bfloat16):
        for shapes in (gn_shapes, ragged):
            vs = [randn(*s_, scale=0.01).to(dtype) for s_ in shapes]
            ws = [randn(*s_, scale=0.3).to(dtype) for s_ in shapes]
            t = torch.tensor(0.1, device=dev)
            before = ops.launches["gaia_select"]
            outs, cnts = ops.gaia_select_many(vs, ws, t)
            assert ops.launches["gaia_select"] == before + 1
            routs, rcnts = ref.gaia_select_many_ref(vs, ws, t)
            torch.cuda.synchronize()
            assert all(torch.equal(o_, r_) for o_, r_ in zip(outs, routs)), \
                (dtype, shapes)
            assert torch.equal(cnts, rcnts), (dtype, cnts, rcnts)
    print(f"gaia_select_many: bit-exact in one launch on GN-LeNet's "
          f"{len(gn_shapes)} tensors at K={K} and on {ragged}, float32 and "
          "bfloat16")

    def mix_operands(sched):
        idx, w, sw = sched.neighbor_arrays(0)
        return (torch.from_numpy(idx.astype(np.int32)).to(dev),
                torch.from_numpy(w.astype(np.float32)).to(dev),
                torch.from_numpy(sw.astype(np.float32)).to(dev))

    ring_ops = mix_operands(build_schedule("ring", K))
    rand_ops = mix_operands(build_schedule("random", 16, seed=0))
    assert rand_ops[0].shape == (16, 4), rand_ops[0].shape
    mix_err = 0.0
    for label, ops_t, shape, dtype, tol in (
            ("ring f32", ring_ops, (K, n_params), torch.float32, 2e-5),
            ("random K=16 D=4 f32", rand_ops, (16, n_params),
             torch.float32, 2e-5),
            ("ring bf16", ring_ops, (K, n_params), torch.bfloat16, 2e-2)):
        x = randn(*shape).to(dtype)
        out = ops.neighbor_mix(x, *ops_t)
        with tf32_off():
            expect = ref.neighbor_mix_padded_ref(x, *ops_t)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == shape
        err = float((out.float() - expect.float()).abs().max())
        torch.testing.assert_close(out.float(), expect.float(), atol=tol,
                                   rtol=tol)
        if label == "ring f32":
            mix_err = err
        print(f"neighbor_mix {label} {tuple(shape)}: max |err| {err:.3g} "
              f"(tol {tol})")

    def stale_operands(ops_t, stale, k):
        """AD-PSGD's gather index: real neighbours read slot ``stale``."""
        idx, w, sw = ops_t
        return (torch.where(w > 0, stale * k, 0) + idx).int(), w, sw

    ring_src_ops = stale_operands(ring_ops, 2, K)
    rand_src_ops = stale_operands(rand_ops, 2, 16)
    src_err = 0.0
    for label, ops_t, k, dtype, tol in (
            ("ring f32", ring_src_ops, K, torch.float32, 2e-5),
            ("random K=16 D=4 f32", rand_src_ops, 16, torch.float32, 2e-5),
            ("ring bf16", ring_src_ops, K, torch.bfloat16, 2e-2)):
        x = randn(k, n_params).to(dtype)
        src = torch.cat([x, randn(2 * k, n_params).to(dtype)])
        out = ops.neighbor_mix(x, *ops_t, src=src)
        with tf32_off():
            expect = ref.neighbor_mix_padded_ref(x, *ops_t, src)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == x.shape
        err = float((out.float() - expect.float()).abs().max())
        torch.testing.assert_close(out.float(), expect.float(), atol=tol,
                                   rtol=tol)
        if label == "ring f32":
            src_err = err
        print(f"neighbor_mix_src {label} x {tuple(x.shape)} src "
              f"{tuple(src.shape)}: max |err| {err:.3g} (tol {tol})")
    before = dict(ops.launches)
    bad = ring_src_ops[0].clone()
    bad[1, 0] = 3 * K                       # one past the buffer
    try:
        ops.neighbor_mix(x, bad, *ring_src_ops[1:], src=src)
        raise AssertionError("an index past the buffer was not refused")
    except ValueError as e:
        assert "outside" in str(e), e
    assert ops.launches == before, (ops.launches, before)
    print("neighbor_mix_src: an index past the buffer is refused, no launch")

    # the training path's gossip: every leaf of a zoo model in one launch,
    # D-PSGD's round (neighbor_mix_many) and AD-PSGD's push and stale
    # gather (neighbor_mix_push_many), against their plain versions
    gossip_err = {"neighbor_mix_many": 0.0, "neighbor_mix_push_many": 0.0,
                  "neighbor_mix_src_many": 0.0}
    gossip_checks = 0
    for cfg_name in GOSSIP_CFGS:
        zoo_p, _ = init_cnn(torch.Generator().manual_seed(0),
                            CNN_ZOO[cfg_name])
        shapes = [tuple(t_.shape) for t_ in zoo_p.values()]
        for topo, k in (("ring", K), ("random", 16)):
            idx_np, w_np, sw_np = build_schedule(topo, k,
                                                 seed=0).neighbor_arrays(0)
            mix = ops.mix_operands(idx_np, w_np, sw_np, k, dev)
            for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
                xs = [randn(k, *s_).to(dtype) for s_ in shapes]
                n_cols = sum(x_[0].numel() for x_ in xs)
                snaps = randn(3, k, n_cols).to(dtype)
                runs = [("neighbor_mix_many", "neighbor_mix", 0,
                         lambda: ops.neighbor_mix_many(xs, mix),
                         lambda: (ref.neighbor_mix_many_ref(
                             xs, mix.idx, mix.w, mix.self_w), None))]
                for stale in (0, 2):
                    smix = ops.mix_operands(
                        np.where(w_np > 0, stale, 0) * k + idx_np, w_np,
                        sw_np, 3 * k, dev)
                    runs.append((
                        "neighbor_mix_push_many", "neighbor_mix_src", stale,
                        lambda smix=smix: ops.neighbor_mix_push_many(
                            xs, snaps, smix),
                        lambda smix=smix: ref.neighbor_mix_push_many_ref(
                            xs, snaps, smix.idx, smix.w, smix.self_w)))
                # phase 12's gossip: every neighbour row from an (M, N)
                # source (the rows gathered or received from other ranks)
                src = randn(2 * k, n_cols).to(dtype)
                gmix = ops.mix_operands(idx_np + k, w_np, sw_np, 2 * k, dev)
                runs.append((
                    "neighbor_mix_src_many", "neighbor_mix_src", None,
                    lambda: ops.neighbor_mix_src_many(xs, src, gmix),
                    lambda: (ref.neighbor_mix_src_many_ref(
                        xs, src, gmix.idx, gmix.w, gmix.self_w), None)))
                for op_name, kname, stale, call, plain in runs:
                    before = dict(ops.launches)
                    got = call()
                    made = {k_: c_ - before[k_] for k_, c_ in
                            ops.launches.items() if c_ != before[k_]}
                    assert made == {kname: 1}, (op_name, made)
                    with tf32_off():
                        expect, expect_snaps = plain()
                    torch.cuda.synchronize()
                    if expect_snaps is not None:
                        got, new_snaps = got
                        assert torch.equal(new_snaps, expect_snaps), \
                            (op_name, cfg_name, topo, dtype)
                    for o_, e_, x_ in zip(got, expect, xs):
                        assert o_.dtype == dtype and o_.shape == x_.shape
                        torch.testing.assert_close(o_.float(), e_.float(),
                                                   atol=tol, rtol=tol)
                    err = max(float((o_.float() - e_.float()).abs().max())
                              for o_, e_ in zip(got, expect))
                    if cfg_name == "gn-lenet" and topo == "ring" and \
                            dtype == torch.float32:
                        gossip_err[op_name] = max(gossip_err[op_name], err)
                    gossip_checks += 1
                    print(f"{op_name} {cfg_name} ({len(xs)} leaves, "
                          f"{n_cols} columns) {topo} K={k} "
                          f"{str(dtype)[6:]}"
                          + (f" staleness {stale}" if stale is not None
                             and kname == "neighbor_mix_src" else "")
                          + f", one launch: max |err| {err:.3g} (tol {tol})"
                          + ("; pushed buffer exact"
                             if expect_snaps is not None else ""))
                del xs, snaps, src
    before = dict(ops.launches)
    bad = np.where(w_np > 0, 2, 0) * 16 + idx_np
    for b_ in (-1, 3 * 16):
        bad[1, 0] = b_
        try:
            ops.mix_operands(bad, w_np, sw_np, 3 * 16, dev)
            raise AssertionError(f"index {b_} was not refused")
        except ValueError as e:
            assert "outside" in str(e), e
    assert ops.launches == before, (ops.launches, before)
    print(f"neighbor_mix_many, neighbor_mix_push_many, neighbor_mix_src_many: "
          f"{gossip_checks} checks "
          f"in one launch each on {GOSSIP_CFGS}'s leaves; an index of -1 or "
          "past the buffer refused when the operands are built, no launch")

    randk_checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in leaf_shapes + [(1_000_003,)]:
            v = randn(*shape).to(dtype)
            for keep, seed in ((0.25, 1009), (KEEP_999, 3594),
                               (0.0625, 2**31 + 131)):
                sel, cnt = ops.rand_k_sparsify(v, keep, seed)
                rsel, rcnt = ref.rand_k_select_ref(v, keep, seed)
                torch.cuda.synchronize()
                assert torch.equal(sel != 0, rsel != 0), (shape, dtype, seed)
                assert torch.equal(sel, rsel), (shape, dtype, seed)
                assert int(cnt) == int(rcnt), (shape, dtype, int(cnt),
                                               int(rcnt))
                randk_checks += 1
    print(f"rand_k_select: bit-exact in {randk_checks} checks "
          f"({len(leaf_shapes) + 1} shapes x {{float32, bfloat16}} x 3 "
          f"(keep, seed), keep {KEEP_999!r} and seed {2**31 + 131} among "
          "them)")
    many_checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        for shapes, perms in ((gn_shapes, gn_perms),
                              (ragged, [None] * len(ragged))):
            accs = [randn(*s_, scale=0.01).to(dtype) for s_ in shapes]
            vels = [randn(*s_, scale=0.01).to(dtype) for s_ in shapes]
            for keep, base in ((0.25, 1009), (KEEP_999, 2**31 + 131)):
                seeds = [base + 1009 * li for li in range(len(shapes))]
                before = ops.launches["rand_k_select"]
                got = ops.rand_k_sparsify_many(accs, vels, keep, seeds, perms)
                assert ops.launches["rand_k_select"] == before + 1
                expect = ref.rand_k_sparsify_many_ref(accs, vels, keep,
                                                      seeds, perms)
                torch.cuda.synchronize()
                for g_, e_ in zip(got[0] + got[1], expect[0] + expect[1]):
                    assert torch.equal(g_, e_) and torch.equal(
                        torch.signbit(g_), torch.signbit(e_)), (dtype, keep)
                assert torch.equal(got[2], expect[2]), (dtype, keep)
                many_checks += 1
    print(f"rand_k_sparsify_many: acc, vel and counts bit-exact in one "
          f"launch in {many_checks} checks (GN-LeNet's {len(gn_shapes)} "
          f"tensors at K={K}, conv weights counted in the reference's HWIO "
          f"layout, and {ragged}; float32 and bfloat16; keep 0.25 and "
          f"{KEEP_999!r}, seeds past 2**31)")

    # DGC's histogram route: dgc_sparsify in one launch (max|v|, histogram,
    # threshold, select) and its parts, bit-exact against the plain
    # versions (the bisection for the threshold), at the bench's n = 2**20,
    # GN-LeNet's K=5 stack and ragged sizes
    dgc_checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        for n in DGC_SIZES:
            v = randn(n).to(dtype)
            before = ops.launches["abs_histogram_fused"]
            hist, v_max = ops.abs_histogram_fused(v)
            assert ops.launches["abs_histogram_fused"] == before + 1
            r_max = v.float().abs().max()
            assert float(v_max) == float(r_max), (n, dtype)
            assert torch.equal(hist, ref.abs_histogram_ref(v, 256, r_max)), \
                (n, dtype)
            assert int(hist.sum()) == n, (n, dtype)
            for s_ in DGC_SPARSITIES:
                before = dict(ops.launches)
                sel, cnt, t_ = ops.dgc_sparsify(v, s_)
                made = {k_: c_ - before[k_] for k_, c_ in ops.launches.items()
                        if c_ != before[k_]}
                assert made == {"dgc_sparsify": 1}, made
                rsel, rcnt, rt = ref.dgc_sparsify_ref(v, s_)
                torch.cuda.synchronize()
                assert float(t_) == float(rt), (n, dtype, s_, float(t_),
                                                float(rt))
                assert int(cnt) == int(rcnt) and torch.equal(sel, rsel), \
                    (n, dtype, s_)
                dgc_checks += 1
    v = randn(4096)
    for s_ in DGC_SPARSITIES:                 # a bin count off a power of 2
        sel, cnt, t_ = ops.dgc_sparsify(v, s_, n_bins=100)
        rsel, rcnt, rt = ref.dgc_sparsify_ref(v, s_, n_bins=100)
        assert float(t_) == float(rt) and int(cnt) == int(rcnt), s_
        assert torch.equal(sel, rsel), s_
    tied = randn(4096)
    top = float(tied.abs().max())
    tied[[5, 99, 4000]] = torch.tensor([top, -top, top], device=dev)
    hist, v_max = ops.abs_histogram_fused(tied)
    assert float(v_max) == top and int(hist[255]) >= 3, int(hist[255])
    assert torch.equal(hist, ref.abs_histogram_ref(tied, 256, v_max))
    zeros = torch.zeros(1000, device=dev)
    hist, v_max = ops.abs_histogram_fused(zeros)
    assert float(v_max) == 0.0 and int(hist[0]) == 1000
    sel, cnt, t_ = ops.dgc_sparsify(zeros, 0.999)
    assert float(t_) == 0.0 and int(cnt) == 0 and not sel.any()
    for vm in (0.5 * top, 1e-35):   # external v_max below max|v|; floored
        hist = ops.abs_histogram(tied, vm)
        assert torch.equal(hist, ref.abs_histogram_ref(tied, 256, vm)), vm
        assert int(hist.sum()) == tied.numel(), vm
    for t_ in (0.0, 0.5, 3.0):
        sel, cnt = ops.dgc_select(tied, t_)
        rsel, rcnt = ref.dgc_select_ref(tied, t_)
        assert torch.equal(sel, rsel) and int(cnt) == int(rcnt), t_
    print(f"dgc_sparsify (one launch a call: selection, count, threshold), "
          f"abs_histogram_fused, abs_histogram, dgc_select: bit-exact in "
          f"{dgc_checks} checks ({len(DGC_SIZES)} sizes x {{float32, "
          f"bfloat16}} x sparsities {list(DGC_SPARSITIES)}), at n_bins=100, "
          f"with ties at v_max, all zeros, an external v_max of half max|v| "
          f"and of 1e-35")

    gn_err = 0.0
    gn_routes = set()
    for shape, gs in GN_CASES:
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            x = randn(*shape).to(dtype)
            sc = randn(shape[-1], scale=0.1) + 1.0
            bi = randn(shape[-1], scale=0.1)
            route = ops.group_norm_route(shape, dtype, gs)
            gn_routes.add(route)
            before = ops.launches["group_norm"]
            out = ops.group_norm(x, sc, bi, group_size=gs)
            assert ops.launches["group_norm"] == before + 1
            expect = ref.group_norm_ref(x, sc, bi, group_size=gs)
            torch.cuda.synchronize()
            assert out.dtype == dtype and out.shape == x.shape
            torch.testing.assert_close(out.float(), expect.float(),
                                       atol=tol, rtol=tol)
            err = float((out.float() - expect.float()).abs().max())
            if dtype == torch.float32:
                gn_err = max(gn_err, err)
            print(f"group_norm {tuple(shape)} group_size {gs} "
                  f"{str(dtype)[6:]}, {route} route: max |err| {err:.3g} "
                  f"(tol {tol})")
    assert gn_routes == {"sample", "group"}, gn_routes
    before = dict(ops.launches)
    try:
        ops.group_norm(randn(2, 4, 4, 6), torch.ones(6, device=dev),
                       torch.zeros(6, device=dev), group_size=4)
        raise AssertionError("C % group_size != 0 was not refused")
    except ValueError as e:
        assert "multiple" in str(e), e
    assert ops.launches == before, (ops.launches, before)
    print("group_norm: C % group_size != 0 is refused, no launch")

    fa_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    fa_checks = 0
    fa_prefill_err, fa_prefill_max = [], 0.0
    with tf32_off():
        for shape in FA_SHAPES + (FA_PREFILL,):
            B_, H_, Tq_, Tk_, D_ = shape
            for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
                if shape == FA_PREFILL and dtype == torch.float32:
                    continue                  # the prefill runs in bfloat16
                if shape == FA_PREFILL:
                    tol = FA_PREFILL_TOL
                q_, k_, v_ = (randn(B_, H_, t_, D_).to(dtype)
                              for t_ in (Tq_, Tk_, Tk_))
                for kw in FA_KWS:
                    out = ops.flash_attention(q_, k_, v_, **kw)
                    expect = ref.flash_attention_ref(q_, k_, v_, **kw)
                    torch.cuda.synchronize()
                    assert out.dtype == dtype and out.shape == q_.shape
                    torch.testing.assert_close(out.float(), expect.float(),
                                               atol=tol, rtol=tol)
                    diff = (out.float() - expect.float()).abs()
                    err = float(diff.max())
                    fa_err[dtype] = max(fa_err[dtype], err)
                    fa_checks += 1
                    if shape == FA_PREFILL:
                        mean = float(diff.mean())
                        assert mean <= FA_PREFILL_MEAN_TOL, (kw, mean)
                        fa_prefill_max = max(fa_prefill_max, err)
                        fa_prefill_err.append(
                            f"{kw}: max {err:.3g}, mean {mean:.3g}")
                    del diff
                del q_, k_, v_, out, expect
    print(f"flash_attention: {fa_checks} checks ({len(FA_SHAPES)} shapes x "
          f"{{float32, bfloat16}} and the prefill's {FA_PREFILL} in "
          f"bfloat16, each causal, non-causal, window 64, softcap 30): max "
          f"|err| float32 {fa_err[torch.float32]:.3g} (tol 2e-5), bfloat16 "
          f"{fa_err[torch.bfloat16]:.3g} (tol 2e-2, at the prefill's shape "
          f"{FA_PREFILL_TOL:g} and mean {FA_PREFILL_MEAN_TOL:g}); at the "
          f"prefill's shape |err| {'; '.join(fa_prefill_err)}")
    before = dict(ops.launches)
    q80 = randn(1, 2, 16, 80)
    qt = randn(1, 2, 64, 16).transpose(2, 3)
    for bad, what in (((q80, q80, q80), "head dim"),
                      ((qt, qt, qt), "contiguous")):
        try:
            ops.flash_attention(*bad)
            raise AssertionError(f"flash_attention took a bad {what}")
        except ValueError as e:
            assert what in str(e), e
    assert ops.launches == before, (ops.launches, before)
    print("flash_attention: a head dim of 80 and an input with D off unit "
          "stride are refused, no launch")

    # k and v of their own head dims: (B, H, T, D) tensors, then a v that
    # is a slice of a fused kv projection (MLA's nope half, then v: head
    # stride 2 Dv, offset Dv) under 4 query heads over 2 KV heads
    pair_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    pair_checks = 0
    with tf32_off():
        for dk_, dv_ in FA_PAIRS:
            for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
                for B_, H_, Tq_, Tk_ in FA_PAIR_SHAPES:
                    q_ = randn(B_, H_, Tq_, dk_).to(dtype)
                    k_ = randn(B_, H_, Tk_, dk_).to(dtype)
                    v_ = randn(B_, H_, Tk_, dv_).to(dtype)
                    for kw in FA_KWS:
                        out = ops.flash_attention(q_, k_, v_, **kw)
                        expect = ref.flash_attention_ref(q_, k_, v_, **kw)
                        torch.cuda.synchronize()
                        assert out.dtype == dtype and \
                            out.shape == (B_, H_, Tq_, dv_)
                        torch.testing.assert_close(
                            out.float(), expect.float(), atol=tol, rtol=tol)
                        pair_err[dtype] = max(pair_err[dtype], float(
                            (out.float() - expect.float()).abs().max()))
                        pair_checks += 1
                q_ = randn(2, 96, 4, dk_).to(dtype)
                k_ = randn(2, 96, 2, dk_).to(dtype)
                v_ = randn(2, 96, 2, 2 * dv_).to(dtype)[..., dv_:]
                for kw in FA_KWS:
                    out = ops.flash_attention_bthd(q_, k_, v_, **kw)
                    expect = ref.flash_attention_bthd_ref(q_, k_, v_, **kw)
                    torch.cuda.synchronize()
                    assert out.shape == (2, 96, 4, dv_)
                    torch.testing.assert_close(out.float(), expect.float(),
                                               atol=tol, rtol=tol)
                    pair_err[dtype] = max(pair_err[dtype], float(
                        (out.float() - expect.float()).abs().max()))
                    pair_checks += 1
        # cross-attention: no mask reads positions, q_offset 0, Tq != Tk
        for tq_, tk_ in ((192, 64), (64, 192)):
            for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
                q_ = randn(2, tq_, 4, 64).to(dtype)
                k_, v_ = (randn(2, tk_, 2, 64).to(dtype) for _ in range(2))
                before = ops.launches["flash_attention"]
                out = chunked_attention(q_, k_, v_, causal=False, q_offset=0)
                assert ops.launches["flash_attention"] == before + 1
                expect = ref.flash_attention_bthd_ref(q_, k_, v_,
                                                      causal=False)
                torch.cuda.synchronize()
                torch.testing.assert_close(out.float(), expect.float(),
                                           atol=tol, rtol=tol)
                pair_checks += 1
    print(f"flash_attention (Dk, Dv) pairs {list(FA_PAIRS)}: {pair_checks} "
          f"checks ({len(FA_PAIR_SHAPES)} shapes x {{float32, bfloat16}} x "
          f"the four masks, v sliced from a fused kv under 4 over 2 heads, "
          f"and cross-attention at q_offset 0 with Tq 192 over Tk 64 and 64 "
          f"over 192, one launch each): max |err| float32 "
          f"{pair_err[torch.float32]:.3g} (tol 2e-5), bfloat16 "
          f"{pair_err[torch.bfloat16]:.3g} (tol 2e-2)")

    # the model's layout: flash_attention_bthd on (B, T, H, D) views of a
    # projection-shaped tensor, H / Hkv in FA_GROUPS, then the prefill's
    # 16 over 8 heads
    bthd_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    bthd_checks, bthd_prefill_err = 0, []
    with tf32_off():
        for shape in FA_SHAPES:
            for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
                for group in FA_GROUPS:
                    q_, k_, v_ = fused_qkv(gen, dev, shape, group, dtype)
                    for kw in FA_KWS:
                        out = ops.flash_attention_bthd(q_, k_, v_, **kw)
                        expect = ref.flash_attention_bthd_ref(q_, k_, v_,
                                                              **kw)
                        torch.cuda.synchronize()
                        assert out.dtype == dtype and out.shape == q_.shape
                        torch.testing.assert_close(
                            out.float(), expect.float(), atol=tol, rtol=tol)
                        bthd_err[dtype] = max(bthd_err[dtype], float(
                            (out.float() - expect.float()).abs().max()))
                        bthd_checks += 1
        q_, k_, v_ = fused_qkv(gen, dev, FA_PREFILL_GQA, FA_PREFILL_GROUP,
                               torch.bfloat16)
        for kw in FA_KWS:
            diff = (ops.flash_attention_bthd(q_, k_, v_, **kw).float()
                    - ref.flash_attention_bthd_ref(q_, k_, v_, **kw).float()
                    ).abs()
            err, mean = float(diff.max()), float(diff.mean())
            assert err <= FA_PREFILL_TOL and mean <= FA_PREFILL_MEAN_TOL, (
                kw, err, mean)
            fa_prefill_max = max(fa_prefill_max, err)
            bthd_checks += 1
            bthd_prefill_err.append(f"{kw}: max {err:.3g}, mean {mean:.3g}")
            del diff
        del q_, k_, v_
    print(f"flash_attention_bthd: {bthd_checks} checks on (B, T, H, D) views "
          f"of a fused projection ({len(FA_SHAPES)} shapes x {{float32, "
          f"bfloat16}} x H / Hkv in {FA_GROUPS} x the four masks, and the "
          f"prefill's 16 over 8 heads in bfloat16): max |err| float32 "
          f"{bthd_err[torch.float32]:.3g} (tol 2e-5), bfloat16 "
          f"{bthd_err[torch.bfloat16]:.3g} (tol 2e-2); at the prefill's "
          f"shape (tol {FA_PREFILL_TOL:g}, mean {FA_PREFILL_MEAN_TOL:g}) "
          f"|err| {'; '.join(bthd_prefill_err)}")

    # phase 9's models as they launch the kernel: (B, T, H, D) views of
    # one projection-shaped tensor, each model's own mask; bfloat16 at
    # the prefill's bounds, float32 at 2e-5
    new_err = []
    with tf32_off():
        for label, shape, group, kw in FA_NEW_SHAPES:
            errs_ = []
            for dtype in (torch.bfloat16, torch.float32):
                q_, k_, v_ = fused_qkv(gen, dev, shape, group, dtype)
                before = ops.launches["flash_attention"]
                out = ops.flash_attention_bthd(q_, k_, v_, **kw)
                assert ops.launches["flash_attention"] == before + 1
                expect = ref.flash_attention_bthd_ref(q_, k_, v_, **kw)
                assert out.shape == q_.shape and out.dtype == dtype
                diff = (out.float() - expect.float()).abs()
                err, mean = float(diff.max()), float(diff.mean())
                if dtype == torch.bfloat16:
                    assert err <= FA_PREFILL_TOL and \
                        mean <= FA_PREFILL_MEAN_TOL, (label, err, mean)
                    fa_prefill_max = max(fa_prefill_max, err)
                else:
                    torch.testing.assert_close(out, expect, atol=2e-5,
                                               rtol=2e-5)
                errs_.append(f"{str(dtype)[6:]} max {err:.3g}, mean "
                             f"{mean:.3g}")
                del q_, k_, v_, out, expect, diff
            B_, H_, Tq_, Tk_, D_ = shape
            new_err.append(f"{label} (B {B_}, Tq {Tq_}, Tk {Tk_}, "
                           f"{H_ * group} over {H_} heads of {D_}, {kw}): "
                           + ", ".join(errs_))
    print("flash_attention_bthd at phase 9's model shapes, one launch each "
          f"(bfloat16 tol {FA_PREFILL_TOL:g}, mean {FA_PREFILL_MEAN_TOL:g}; "
          "float32 tol 2e-5): " + "; ".join(new_err))

    # every kernel of the bench (phase 6) on the bench's own operands
    b_in = kernels_bench.inputs("cuda")
    bv, bw, bxs, bmix = b_in["v"], b_in["w"], b_in["xs"], b_in["mix_ops"]
    checks = (("gaia_select", ops.gaia_select(bv, bw, 0.5),
               ref.gaia_select_ref(bv, bw, 0.5)),
              ("rand_k_select", ops.rand_k_sparsify(bv, 0.001, 7),
               ref.rand_k_select_ref(bv, 0.001, 7)),
              ("dgc_sparsify", ops.dgc_sparsify(bv, 0.999),
               ref.dgc_sparsify_ref(bv, 0.999)))
    torch.cuda.synchronize()
    for kname, got, expect in checks:
        for g_, e_ in zip(got, expect):
            assert g_.dtype == e_.dtype and torch.equal(g_, e_), kname
    out = ops.neighbor_mix(bxs, *bmix)
    with tf32_off():
        expect = ref.neighbor_mix_padded_ref(bxs, *bmix)
    torch.testing.assert_close(out, expect, atol=2e-5, rtol=2e-5)
    bmix_err = float((out - expect).abs().max())
    out = ops.group_norm(b_in["x"], b_in["scale"], b_in["bias"], group_size=2)
    expect = ref.group_norm_ref(b_in["x"], b_in["scale"], b_in["bias"],
                                group_size=2)
    torch.testing.assert_close(out, expect, atol=1e-5, rtol=1e-5)
    bgn_err = float((out - expect).abs().max())
    bq, bk, bva = b_in["q"], b_in["k"], b_in["v_attn"]
    out = ops.flash_attention(bq, bk, bva)
    with tf32_off():
        expect = ref.flash_attention_ref(bq, bk, bva)
    torch.testing.assert_close(out, expect, atol=2e-5, rtol=2e-5)
    print(f"the bench's operands (n = {bv.numel()}, xs {tuple(bxs.shape)} "
          f"on ring(8), x {tuple(b_in['x'].shape)}, q/k/v "
          f"{tuple(bq.shape)}): gaia_select (T 0.5), rand_k_select (keep "
          f"0.001, seed 7) and dgc_sparsify (sparsity 0.999: selection, "
          f"count, threshold) bit-exact; neighbor_mix max |err| "
          f"{bmix_err:.3g} (tol 2e-5); group_norm max |err| {bgn_err:.3g} "
          f"(tol 1e-5); flash_attention max |err| "
          f"{float((out - expect).abs().max()):.3g} (tol 2e-5)")
    sys.stdout.flush()

    # ---------------------------------------------------------------- 4
    phase(4, "main path: train_decentralized on the card")
    ds = synth_images(3000, seed=0, noise=0.8, class_sep=0.35)
    val = synth_images(800, seed=99, noise=0.8, class_sep=0.35)
    idx = partition_label_skew(ds.y, K, 1.0, seed=1)
    parts = [(ds.x[i], ds.y[i]) for i in idx]

    def run(label, algo_name, fields, device=None, steps=STEPS,
            travel_every=2):
        comm = CommConfig(fabric=FabricConfig(topology="ring"),
                          travel_every=travel_every, **fields)
        return trainer.train_decentralized(
            cfg, algo_name, parts, (val.x, val.y), comm=comm, steps=steps,
            eval_every=steps, seed=0, device=device)

    # the same five steps on the card and on the CPU (plain versions), TF32
    # off; this also warms the card up (cuDNN, allocator) for the timed runs
    with tf32_off():
        for label, algo_name, fields in RUNS:
            r_card, r_cpu = (run(label, algo_name, fields, device=d,
                                 steps=CPU_CHECK_STEPS)
                             for d in ("cuda", "cpu"))
            curves = [[loss for _, loss in r.loss_curve]
                      for r in (r_card, r_cpu)]
            np.testing.assert_allclose(curves[0], curves[1], rtol=1e-3)
            assert thetas(r_card.skewscout_history) == \
                thetas(r_cpu.skewscout_history), label
            print(f"{label}: {CPU_CHECK_STEPS} steps on cuda and cpu "
                  f"agree (rtol 1e-3, TF32 off): "
                  f"{np.round(curves[0], 5).tolist()}"
                  + (f"; SkewScout θ {thetas(r_card.skewscout_history)}"
                     if r_card.skewscout_history else ""), flush=True)
    # AD-PSGD at staleness 0 (buffer depth 3) is D-PSGD bit for bit on the
    # card: its src-gather launch reads slot 0, D-PSGD's own x.  cuDNN runs
    # deterministically here, so the runs differ only in the mixing; D-PSGD
    # runs twice to show that the card repeats itself under these flags
    with tf32_off(), cudnn_deterministic():
        fns, _ = trainer.make_cnn_fns(cfg)
        ring_comm = CommConfig(fabric=FabricConfig(topology="ring"),
                               max_staleness=2)
        p0, s0 = init_cnn(torch.Generator().manual_seed(0), cfg)
        rs = np.random.default_rng(1)
        batches = [{"x": torch.from_numpy(rs.standard_normal(
                        (K, 20, 16, 16, 3)).astype(np.float32)).to(dev),
                    "y": torch.from_numpy(rs.integers(0, 10, (K, 20))).to(dev)}
                   for _ in range(CPU_CHECK_STEPS)]
        finals = []
        for algo_name in ("dpsgd", "dpsgd", "adpsgd"):
            algo = trainer.make_algorithm(algo_name, fns, K, ring_comm,
                                          staleness=0)
            state = algo.init({n: t.to(dev) for n, t in p0.items()},
                              {n: t.to(dev) for n, t in s0.items()})
            losses = []
            for t, b in enumerate(batches):
                state, met = algo.step(state, b,
                                       torch.tensor(0.05, device=dev), t)
                losses.append(float(met["loss"]))
            finals.append((losses, state["params"]))
        for i, label in ((1, "dpsgd run twice"), (2, "adpsgd")):
            assert finals[i][0] == finals[0][0], (label, finals[i][0],
                                                  finals[0][0])
            for n, t in finals[0][1].items():
                assert torch.equal(finals[i][1][n], t), (label, n)
        print(f"adpsgd at staleness 0 (buffer depth 3) equals dpsgd bit for "
              f"bit on the card over {CPU_CHECK_STEPS} steps: losses "
              f"{finals[0][0]}", flush=True)
    # warm each run up at the default flags too: cuDNN picks its TF32
    # convolutions for each strategy's shapes on first use, which must not
    # fall into the timed runs below
    for label, algo_name, fields in RUNS:
        run(label, algo_name, fields, steps=CPU_CHECK_STEPS)

    # record each run's last step: its state, to check where it lives, and
    # its call, to audit one more step of it
    last_call, audit_calls = {}, {}
    make_algorithm = trainer.make_algorithm

    def recording_make_algorithm(*args, **kwargs):
        algo = make_algorithm(*args, **kwargs)
        step = algo.step

        def recorded(state, *a, **kw):
            out = step(state, *a, **kw)
            last_call[algo.name] = (step, out[0], a, kw)
            return out
        algo.step = recorded
        return algo

    trainer.make_algorithm = recording_make_algorithm
    launches = {k_: 0 for k_ in ops.launches}
    results, rates = {}, {}
    try:
        for label, algo_name, fields in RUNS:
            for k_ in ops.launches:
                ops.launches[k_] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = run(label, algo_name, fields, travel_every=10)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(ops.launches)
            for k_, c in counts.items():
                launches[k_] += c
            results[label], rates[label] = r, STEPS / wall
            losses = [loss for _, loss in r.loss_curve]
            print(f"{label}: {STEPS / wall:.2f} steps/s (wall, one eval "
                  f"included, default TF32 flags), loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}, val_acc {r.val_acc:.4f}, "
                  f"comm_total_floats {r.comm_total_floats:.1f}, "
                  f"launches {counts}"
                  + (f", SkewScout θ {thetas(r.skewscout_history)}"
                     if r.skewscout_history else ""), flush=True)
            assert len(losses) == STEPS and np.all(np.isfinite(losses)), \
                (label, losses)
            for part, tree in last_call[algo_name][1].items():
                tensors = tree.values() if isinstance(tree, dict) else [tree]
                for t in tensors:
                    assert t.device.type == "cuda", (label, part, t.device)
            audit_calls[label] = last_call[algo_name]
    finally:
        trainer.make_algorithm = make_algorithm
    bsp_losses = [loss for _, loss in results["bsp"].loss_curve]
    assert np.mean(bsp_losses[-5:]) < np.mean(bsp_losses[:5]), bsp_losses
    assert len(results["dpsgd-skewscout"].skewscout_history) == 3
    # one launch a step: the Gaia run alone launches gaia_select, the
    # rand-k run alone rand_k_select
    # one gossip launch a step: the D-PSGD and SkewScout runs launch
    # neighbor_mix, the AD-PSGD run neighbor_mix_src
    assert launches["gaia_select"] == STEPS, launches
    assert launches["neighbor_mix"] == 2 * STEPS, launches
    assert launches["neighbor_mix_src"] == STEPS, launches
    assert launches["rand_k_select"] == STEPS, launches
    print(f"main-path launches: {launches}")
    print("steps/s: " + json.dumps({k_: round(v, 2)
                                   for k_, v in rates.items()}))
    # one more step of each design, from its run's last state, under the
    # step audit (analysis.step_audit: JA401 by the sync debug mode, JA404,
    # JA405): no finding, and the launches phase 4 holds each design to
    t0 = time.perf_counter()
    audit4 = {}
    for label, _, _ in RUNS:
        step_, state_, a_, kw_ = audit_calls[label]
        for k_ in ops.launches:
            ops.launches[k_] = 0
        rep_ = step_audit.audit_step(
            step_, (state_,) + tuple(a_[:-1]) + (a_[-1] + 1,), kw_,
            tag=f"phase 4/{label}")
        torch.cuda.synchronize()
        got_ = {k_: c_ for k_, c_ in ops.launches.items() if c_}
        audit4[label] = {"ops": rep_.n_eqns, "launches": got_,
                         "findings": [f_.format() for f_ in rep_.findings]}
    print(f"one more step of each design under the step audit on the card "
          f"in {time.perf_counter() - t0:.2f} s: " + json.dumps(audit4))
    sys.stdout.flush()
    for label, a_ in audit4.items():
        assert a_["findings"] == [], (label, a_["findings"])
        assert a_["launches"] == STEP_LAUNCHES.get(label, {}), (label, a_)
    # the audit's positive control: a planted `.item()` on the card is one
    # JA401, and the caller's sync debug mode comes back as it was
    mode_ = torch.cuda.get_sync_debug_mode()
    planted_ = step_audit.audit_step(
        lambda x_: (x_ * 2).sum().item(), (torch.ones(4, device=dev),),
        tag="phase 4/planted .item()")
    print("a planted .item() under the step audit: "
          + json.dumps([f_.format() for f_ in planted_.findings]))
    assert [f_.rule for f_ in planted_.findings] == ["JA401"], \
        planted_.findings
    assert torch.cuda.get_sync_debug_mode() == mode_

    # one training step on the earlier design against the one-launch step:
    # the earlier design is swapped in here, for this comparison only
    def gaia_per_tensor(vs, ws, threshold):
        """One ``gaia_select`` launch a tensor, each with its own output
        and count, as the single-tensor op made them."""
        t1 = torch.as_tensor(threshold, dtype=torch.float32,
                             device=vs[0].device).reshape(1)
        outs, counts = [], []
        for v_, w_ in zip(vs, ws):
            outs.append(torch.empty_like(v_))
            counts.append(torch.zeros(1, dtype=torch.int32, device=dev))
            ops.launch_gaia_select([v_], [w_], t1, [outs[-1]], counts[-1])
        return outs, torch.cat(counts)

    def randk_per_tensor(accs, vels, keep_prob, seeds, perms):
        """Per tensor, acc and vel permuted into the reference's layout, one
        ``rand_k_select`` launch each, the results permuted back."""
        shared, new_vels, counts = [], [], []
        for a_, u_, seed_, perm_ in zip(accs, vels, seeds, perms):
            to_ref, from_ref = ref.reference_layout(perm_, a_.dim())
            sv, cnt = ops.rand_k_sparsify(to_ref(a_), keep_prob, seed_)
            su, _ = ops.rand_k_sparsify(to_ref(u_), keep_prob, seed_)
            shared.append(from_ref(sv))
            new_vels.append(u_ - from_ref(su))
            counts.append(cnt)
        return shared, new_vels, torch.stack(counts)

    def mix_flat(xs, operands):
        """D-PSGD's earlier design: the leaves flattened into one (K, N)
        float32 matrix, the raw op (its index check and host sync
        included), the result split back."""
        k = operands.idx.shape[0]
        flat = torch.cat([x_.reshape(k, -1).float() for x_ in xs], dim=1)
        mixed = ops.neighbor_mix(flat, operands.idx, operands.w,
                                 operands.self_w)
        return [p_.reshape(x_.shape).to(x_.dtype) for p_, x_ in
                zip(mixed.split([x_[0].numel() for x_ in xs], dim=1), xs)]

    def push_flat(xs, snaps, operands):
        """AD-PSGD's earlier design: the leaves flattened, the buffer
        rebuilt by ``torch.cat``, the raw op with ``src=``, split back."""
        k = operands.idx.shape[0]
        flat = torch.cat([x_.reshape(k, -1).float() for x_ in xs], dim=1)
        new_snaps = torch.cat([flat[None], snaps[:-1]], dim=0)
        mixed = ops.neighbor_mix(flat, operands.idx, operands.w,
                                 operands.self_w,
                                 src=new_snaps.reshape(-1, flat.shape[1]))
        return ([p_.reshape(x_.shape).to(x_.dtype) for p_, x_ in
                 zip(mixed.split([x_[0].numel() for x_ in xs], dim=1), xs)],
                new_snaps)

    def state_items(state_):
        """(name, tensor) of every tensor of a training state."""
        for part, tree in state_.items():
            if isinstance(tree, dict):
                yield from ((f"{part}/{n_}", t_) for n_, t_ in tree.items())
            else:
                yield part, tree

    fns, _ = trainer.make_cnn_fns(cfg)
    p0, s0 = init_cnn(torch.Generator().manual_seed(0), cfg)
    rs = np.random.default_rng(2)
    step_batch = {"x": torch.from_numpy(rs.standard_normal(
                      (K, 20, 16, 16, 3)).astype(np.float32)).to(dev),
                  "y": torch.from_numpy(rs.integers(0, 10, (K, 20))).to(dev)}
    step_lr = torch.tensor(0.05, device=dev)

    def train_step(algo, state_, t_, kw):
        """A step as the trainer makes it, with its one host read."""
        new, met = algo.step(state_, step_batch, step_lr, t_, **kw)
        float(met["comm_floats"])
        return new

    def design(side, op_name, per_tensor):
        """The earlier design swapped in for ``side == "per_tensor"``."""
        return (swapped(ops, op_name, per_tensor) if side == "per_tensor"
                else contextlib.nullcontext())

    # (label, strategy, CommConfig fields, step keywords, the op the step
    # calls, the earlier design swapped in for it, the kernel's launch
    # count name and the piece of its name in a trace, the earlier design's
    # launches a step)
    design_runs = (
        ("gaia", "gaia", {}, {"t0": torch.tensor(0.1, device=dev)},
         "gaia_select_many", gaia_per_tensor, "gaia_select", "gaia_select",
         16),
        ("dgc-randk", "dgc", {"dgc_compressor": "randk"},
         {"sparsity": 0.999}, "rand_k_sparsify_many", randk_per_tensor,
         "rand_k_select", "rand_k_select", 32),
        ("dpsgd", "dpsgd", {}, {}, "neighbor_mix_many", mix_flat,
         "neighbor_mix", "neighbor_mix_kernel", 1),
        ("adpsgd", "adpsgd", {"max_staleness": 2}, {},
         "neighbor_mix_push_many", push_flat, "neighbor_mix_src",
         "neighbor_mix_kernel", 1))
    step_runs, profiles = [], {}
    for (label, algo_name, fields, kw, op_name, per_tensor, kname, ktrace,
         per_launches) in design_runs:
        algo = trainer.make_algorithm(
            algo_name, fns, K,
            CommConfig(fabric=FabricConfig(topology="ring"), **fields))
        state = algo.init({n_: t_.to(dev) for n_, t_ in p0.items()},
                          {n_: t_.to(dev) for n_, t_ in s0.items()})
        for t_ in range(3):                 # warm-up: cuDNN, the allocator
            state = train_step(algo, state, t_, kw)
        # both designs from one state give the same state bit for bit
        with tf32_off(), cudnn_deterministic():
            one = train_step(algo, state, 3, kw)
            with design("per_tensor", op_name, per_tensor):
                per = train_step(algo, state, 3, kw)
            one_items, per_items = list(state_items(one)), dict(
                state_items(per))
            assert [n_ for n_, _ in one_items] == list(per_items), label
            for n_, t_ in one_items:
                assert torch.equal(t_, per_items[n_]), (label, n_)
        # the host syncs of the step alone (the trainer's reads left out)
        syncs = {}
        for side in ("per_tensor", "one_launch"):
            with design(side, op_name, per_tensor):
                syncs[side] = count_syncs(
                    lambda: algo.step(state, step_batch, step_lr, 3, **kw))
        print(f"{label} step: the same state bit for bit on both designs "
              f"({len(one_items)} tensors); host syncs in the step, "
              f"earlier design {syncs['per_tensor']}, one-launch "
              f"{syncs['one_launch']}", flush=True)
        walls = {"per_tensor": [], "one_launch": []}
        for side in ("per_tensor", "one_launch", "one_launch", "per_tensor"):
            with design(side, op_name, per_tensor):
                for t_ in range(PROFILE_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state = train_step(algo, state, t_, kw)
                    torch.cuda.synchronize()
                    walls[side].append((time.perf_counter() - t0) * 1e3)
        for side, w_ in walls.items():
            rounds = [float(np.median(w_[:PROFILE_STEPS])),
                      float(np.median(w_[PROFILE_STEPS:]))]
            profiles[f"{label}/{side}"] = {"wall_ms": float(np.median(w_)),
                                           "wall_ms_rounds": rounds,
                                           "syncs": syncs[side]}
            print(f"{label} step, {side.replace('_', '-')} design: wall "
                  f"{np.median(w_):.4f} ms a step (median of "
                  f"{2 * PROFILE_STEPS}, rounds {rounds[0]:.4f} and "
                  f"{rounds[1]:.4f} ms)", flush=True)
        step_runs.append((label, algo, kw, state, op_name, per_tensor,
                          kname, ktrace, per_launches))
    print("one training step of each design: the same state bit for bit "
          "(cuDNN deterministic, TF32 off); traced under torch.profiler "
          "after phase 8's timings")
    sys.stdout.flush()
    # a step of each strategy the paper benches run beside those: its wall
    # here (median of 40), its trace after every timing of the script
    bench_runs = {}
    for label, algo_name, fields, kw, every in BENCH_STEPS:
        step, state, scout = bench_step(algo_name, fields, kw, cfg, parts,
                                        step_batch, step_lr, "cuda")
        ts = [every * i + every - 1 for i in range(4 + 2 * PROFILE_STEPS)]
        for t_ in ts[:3]:                   # warm-up: cuDNN, the allocator
            state = step(state, t_)
        w_ = []
        for t_ in ts[3:-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = step(state, t_)
            torch.cuda.synchronize()
            w_.append((time.perf_counter() - t0) * 1e3)
        bench_runs[label] = (step, state, ts[-1])
        rounds = [float(np.median(w_[:PROFILE_STEPS])),
                  float(np.median(w_[PROFILE_STEPS:]))]
        profiles[label] = {"wall_ms": float(np.median(w_)),
                           "wall_ms_rounds": rounds}
        print(f"{label} step{' (averaging)' if every > 1 else ''}"
              f"{' (travelling)' if scout else ''}: wall "
              f"{np.median(w_):.4f} ms a step (median of "
              f"{2 * PROFILE_STEPS}, rounds {rounds[0]:.4f} and "
              f"{rounds[1]:.4f} ms)"
              + (f"; SkewScout θ {thetas(scout.history)[-3:]}" if scout
                 else ""), flush=True)

    # ---------------------------------------------------------------- 5
    phase(5, "kernel times (median of 50 CUDA-event-timed launches)")
    t = torch.tensor(0.1, device=dev)
    t1 = t.reshape(1)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    counts16 = torch.zeros(len(gn_shapes), dtype=torch.int32, device=dev)
    g_vs = [randn(*s, scale=0.01) for s in gn_shapes]
    g_ws = [randn(*s, scale=0.3) for s in gn_shapes]
    g_outs = [torch.empty_like(v) for v in g_vs]
    g_ms = time_ms(lambda: ops.launch_gaia_select(g_vs, g_ws, t1, g_outs,
                                                  counts16))
    g_op = time_ms(lambda: ops.gaia_select_many(g_vs, g_ws, t))
    # the earlier design: one launch a tensor
    g_per = sum(time_ms(lambda v=v, w=w, o=o: ops.launch_gaia_select(
        [v], [w], t1, [o], count)) for v, w, o in zip(g_vs, g_ws, g_outs))
    g_plain = sum(time_ms(lambda v=v, w=w: ref.gaia_select_ref(v, w, t))
                  for v, w in zip(g_vs, g_ws))
    n_step = K * n_params
    # v and w read, out written; the threshold read, 16 counts written
    g_bound, g_by = bound_ms(3 * n_step * 4 + 4 + 16 * 4, 3 * n_step)
    print(f"gaia_select, one Gaia step ({n_step} floats in "
          f"{len(gn_shapes)} tensors): kernel {g_ms:.4f} ms (one launch), "
          f"op {g_op:.4f} ms, the earlier design's {len(gn_shapes)} "
          f"launches {g_per:.4f} ms, plain {g_plain:.4f} ms, bound "
          f"{g_bound:.5f} ms ({g_by}), kernel / bound {g_ms / g_bound:.1f}")
    big_v = randn(1_000_003, scale=0.01)
    big_w = randn(1_000_003, scale=0.3)
    big_o = torch.empty_like(big_v)
    big_ms = time_ms(lambda: ops.launch_gaia_select([big_v], [big_w], t1,
                                                    [big_o], count))
    print(f"gaia_select n=1,000,003 f32: kernel {big_ms:.4f} ms, bound "
          f"{bound_ms(3 * 1_000_003 * 4, 3 * 1_000_003)[0]:.5f} ms")

    # the gossip kernels at GN-LeNet's leaves (K = 5, ring, float32): the
    # leaf-table launch and op, beside the earlier design's pieces (the raw
    # op on the flat matrix: its index check with the host sync, and its
    # launch), the earlier design whole, dense W @ X, and what any launch
    # and a copy of the same bytes cost under this timing
    idx_np, w_np, sw_np = build_schedule("ring", K).neighbor_arrays(0)
    mix = ops.mix_operands(idx_np, w_np, sw_np, K, dev)
    D = mix.idx.shape[1]
    mx_xs = [randn(*s_) for s_ in leaf_shapes]
    mx_outs = [torch.empty_like(x_) for x_ in mx_xs]
    x = torch.cat([x_.reshape(K, -1) for x_ in mx_xs], dim=1)
    mixed = torch.empty_like(x)
    W = torch.zeros(K, K, device=dev)
    W.scatter_add_(1, mix.idx.long(), mix.w)
    W += torch.diag(mix.self_w)
    mix_floor = time_ms(lambda: torch.cuda._sleep(1))
    m_ms = time_ms(lambda: ops.launch_neighbor_mix_many(mx_xs, mix, mx_outs))
    m_op = time_ms(lambda: ops.neighbor_mix_many(mx_xs, mix))
    m_flat = time_ms(lambda: ops.launch_neighbor_mix(x, mix.idx, mix.w,
                                                     mix.self_w, mixed))
    m_raw = time_ms(lambda: ops.neighbor_mix(x, mix.idx, mix.w, mix.self_w))
    m_check = time_ms(lambda: [int(b_) for b_ in torch.aminmax(mix.idx)])
    m_earlier = time_ms(lambda: mix_flat(mx_xs, mix))
    m_plain = time_ms(lambda: ref.neighbor_mix_many_ref(mx_xs, mix.idx, mix.w,
                                                        mix.self_w))
    m_lib = time_ms(lambda: torch.matmul(W, x))
    m_copy = time_ms(lambda: x.clone())
    m_bound, m_by = bound_ms(2 * K * n_params * 4 + K * D * 8 + K * 4,
                             2 * (D + 1) * K * n_params)
    print(f"neighbor_mix_many, GN-LeNet's {len(mx_xs)} leaves at K={K} f32 "
          f"ring, one launch: kernel {m_ms:.4f} ms, op {m_op:.4f} ms, plain "
          f"{m_plain:.4f} ms, dense W @ X {m_lib:.4f} ms, bound "
          f"{m_bound:.5f} ms ({m_by}), kernel / bound {m_ms / m_bound:.1f}; "
          f"the earlier design: one launch on the flat (5, 96682) matrix "
          f"{m_flat:.4f} ms, the raw op {m_raw:.4f} ms of which its index "
          f"check with the host sync {m_check:.4f} ms, flatten + raw op + "
          f"split {m_earlier:.4f} ms; calibration: an empty launch "
          f"{mix_floor:.4f} ms, a copy of the same bytes (x, 3.87 MB moved) "
          f"{m_copy:.4f} ms")
    x16 = randn(16, n_params)
    mixed16 = torch.empty_like(x16)
    print(f"neighbor_mix (16, 96682) f32 random D=4, one launch on the "
          f"matrix: kernel "
          f"{time_ms(lambda: ops.launch_neighbor_mix(x16, *rand_ops, mixed16)):.4f}"
          " ms")

    # AD-PSGD at staleness 2 (buffer of S + 1 = 3 slots): the push and the
    # stale gather in one launch, beside the earlier design's push by
    # torch.cat and its raw src-gather launch
    S = 2
    snaps = randn(S + 1, K, n_params)
    new_snaps = torch.empty_like(snaps)
    smix = ops.mix_operands(np.where(w_np > 0, S, 0) * K + idx_np, w_np,
                            sw_np, (S + 1) * K, dev)
    src = torch.cat([x[None], snaps[:-1]]).reshape(-1, n_params)
    Wp = torch.zeros(K, (S + 1) * K, device=dev)
    Wp.scatter_add_(1, smix.idx.long(), smix.w)
    Wp[:, :K] += torch.diag(smix.self_w)   # slot 0 of the buffer is x
    s_ms = time_ms(lambda: ops.launch_neighbor_mix_push_many(
        mx_xs, snaps, smix, mx_outs, new_snaps))
    s_op = time_ms(lambda: ops.neighbor_mix_push_many(mx_xs, snaps, smix))
    s_flat = time_ms(lambda: ops.launch_neighbor_mix_src(
        x, src, smix.idx, smix.w, smix.self_w, mixed))
    s_cat = time_ms(lambda: torch.cat([x[None], snaps[:-1]]))
    s_earlier = time_ms(lambda: push_flat(mx_xs, snaps, smix))
    s_plain = time_ms(lambda: ref.neighbor_mix_push_many_ref(
        mx_xs, snaps, smix.idx, smix.w, smix.self_w))
    s_lib = time_ms(lambda: torch.matmul(Wp, src))
    push_bytes = (2 * S + 3) * K * n_params * 4
    s_copy_src = randn(push_bytes // 8)
    s_copy = time_ms(lambda: s_copy_src.clone())
    s_bound, s_by = bound_ms(push_bytes + K * D * 8 + K * 4,
                             2 * (D + 1) * K * n_params)
    # the mix alone, as the earlier design's bound counted it: x, the src
    # rows the index reads, y
    rows_read = int(torch.unique(smix.idx[smix.w > 0]).numel())
    s_mix_bound, _ = bound_ms((2 + rows_read / K) * K * n_params * 4
                              + K * D * 8 + K * 4,
                              2 * (D + 1) * K * n_params)
    print(f"neighbor_mix_push_many, GN-LeNet's leaves at K={K} f32 ring, "
          f"staleness {S}, one launch (push and gather): kernel {s_ms:.4f} "
          f"ms, op {s_op:.4f} ms, plain {s_plain:.4f} ms, dense W' @ src "
          f"{s_lib:.4f} ms (the gather alone), bound {s_bound:.5f} ms "
          f"({s_by}: {push_bytes} bytes, x and {S} old slots read, "
          f"{S + 1} slots and y written), kernel / bound "
          f"{s_ms / s_bound:.1f}; the gather alone's bound "
          f"{s_mix_bound:.5f} ms; the earlier design: the raw src-gather "
          f"launch {s_flat:.4f} ms, the push by torch.cat {s_cat:.4f} ms, "
          f"flatten + push + raw op + split {s_earlier:.4f} ms; a copy of "
          f"the same bytes {s_copy:.4f} ms")
    del s_copy_src, snaps, new_snaps
    x48 = randn(16, n_params)
    src48 = torch.cat([x48, randn(32, n_params)])
    mixed48 = torch.empty_like(x48)
    print(f"neighbor_mix_src (16, 96682) from (48, 96682) random D=4, one "
          f"launch on the matrix: kernel "
          f"{time_ms(lambda: ops.launch_neighbor_mix_src(x48, src48, rand_src_ops[0], *rand_src_ops[1:], mixed48)):.4f}"
          " ms")
    print("\n".join(ptxas_lines("neighbor_mix", logs["neighbor_mix"]))
          if "neighbor_mix" in logs
          else "  neighbor_mix: no ptxas report (the library was up to date)")

    # one DGC rand-k step: acc and vel of every tensor, one seed a tensor,
    # the conv weights counted in the reference's layout
    r_accs = [randn(*s_, scale=0.01) for s_ in gn_shapes]
    r_vels = [randn(*s_, scale=0.01) for s_ in gn_shapes]
    r_shared = [torch.empty_like(a_) for a_ in r_accs]
    r_newv = [torch.empty_like(a_) for a_ in r_accs]
    r_seeds = [1009 * 7 + li for li in range(len(gn_shapes))]
    r_ms = time_ms(lambda: ops.launch_rand_k_select(
        r_accs, r_vels, r_shared, r_newv, counts16, r_seeds, KEEP_999,
        gn_perms))
    r_op = time_ms(lambda: ops.rand_k_sparsify_many(r_accs, r_vels, KEEP_999,
                                                    r_seeds, gn_perms))
    # the earlier design: two launches a tensor (its permuted copies not
    # counted here; phase 4's step profile has them)
    r_per = sum(time_ms(lambda a_=a_, o_=o_, sd=sd: ops.launch_rand_k_select(
        [a_], None, [o_], None, count, [sd], KEEP_999, [None]))
        for a_, o_, sd in zip(r_accs + r_vels, r_shared + r_newv,
                              r_seeds + r_seeds))
    r_plain = sum(time_ms(lambda a_=a_, u_=u_, sd=sd, pm=pm:
                          ref.rand_k_sparsify_many_ref([a_], [u_], KEEP_999,
                                                       [sd], [pm]))
                  for a_, u_, sd, pm in zip(r_accs, r_vels, r_seeds,
                                            gn_perms))
    # per element: acc and vel read, shared and new vel written (16 bytes);
    # ~18 integer and float operations (lowbias32, the 24-bit conversion,
    # the compare, two selects, the subtraction), 16 counts written
    r_bound, r_by = bound_ms(4 * n_step * 4 + 16 * 4, n_step * 18)
    print(f"rand_k_select, one DGC rand-k step (acc and vel, {n_step} floats "
          f"each in {len(gn_shapes)} tensors): kernel {r_ms:.4f} ms (one "
          f"launch), op {r_op:.4f} ms, the earlier design's "
          f"{2 * len(gn_shapes)} launches {r_per:.4f} ms, plain "
          f"{r_plain:.4f} ms, bound {r_bound:.5f} ms ({r_by}), kernel / "
          f"bound {r_ms / r_bound:.1f}")
    big_o2 = torch.empty_like(big_v)
    big_ms = time_ms(lambda: ops.launch_rand_k_select(
        [big_v], None, [big_o2], None, count, [3594], KEEP_999, [None]))
    print(f"rand_k_select n=1,000,003 f32, acc only: kernel {big_ms:.4f} ms, "
          f"bound {bound_ms(1_000_003 * 8, 1_000_003 * 14)[0]:.5f} ms")

    # the bench path's shapes: DGC top-s% at n = 2**20 float32, sparsity
    # 0.999, 256 bins, in one launch and as each of its parts (each one
    # launch of the same kernel); GroupNorm at (128, 8, 8, 64) and
    # GN-LeNet's (100, 16, 16, 32), group_size 2, on both routes
    nb = 1 << 20
    dv = randn(nb)
    # what any launch costs under this timing (a spin kernel of one cycle)
    # and what a launch that reads and writes v costs (a copy): the floors
    # the one-launch kernels below stand on
    floor_ms = time_ms(lambda: torch.cuda._sleep(1))
    clone_ms = time_ms(lambda: dv.clone())
    print(f"calibration: an empty launch {floor_ms:.4f} ms; a copy of v "
          f"(n=2**20 f32: 4 MB read, 4 MB written) {clone_ms:.4f} ms")
    d_work = ops.dgc_work(256, dev)
    d_out = torch.empty_like(dv)
    d_vmax = dv.abs().max()
    vmax_host = float(d_vmax)
    _, _, d_t = ops.dgc_sparsify(dv, 0.999)
    sp_ms = time_ms(lambda: ops.launch_dgc_topk(
        "dgc_sparsify", dv, d_work, 256, out=d_out, sparsity=0.999))
    sp_op = time_ms(lambda: ops.dgc_sparsify(dv, 0.999))
    sp_plain = time_ms(lambda: ref.dgc_sparsify_ref(dv, 0.999))
    sp_exact = time_ms(lambda: ref.dgc_threshold_ref(dv, 0.999))
    # the function reads v and writes out (8 n bytes); abs, divide,
    # multiply, convert, two clamps, the count's add, compare and select
    sp_bound, sp_by = bound_ms(nb * 8, 12 * nb)
    print(f"dgc_sparsify n=2**20 f32, sparsity 0.999, one launch (max|v|, "
          f"histogram, threshold, select): kernel {sp_ms:.4f} ms, op "
          f"{sp_op:.4f} ms, plain (bisection) {sp_plain:.4f} ms, exact "
          f"quantile threshold alone {sp_exact:.4f} ms, bound {sp_bound:.5f} "
          f"ms ({sp_by}: 8 n, v read and out written), kernel / bound "
          f"{sp_ms / sp_bound:.1f}")
    # torch.histc bins |v| over [0, v_max] in one call, its bin edges
    # computed otherwise than the reference's: a yardstick only
    histc = lambda: torch.histc(dv.abs(), bins=256, min=0, max=vmax_host)
    hf_ms = time_ms(lambda: ops.launch_dgc_topk("abs_histogram_fused", dv,
                                                d_work, 256))
    hf_op = time_ms(lambda: ops.abs_histogram_fused(dv))
    hf_plain = time_ms(lambda: ref.abs_histogram_ref(
        dv, 256, dv.float().abs().max()))
    hf_lib = time_ms(histc)
    # v read, max|v| and 256 counts written; abs and max, then the bin's
    # abs, divide, multiply, convert, two clamps and add an element
    hf_bound, hf_by = bound_ms(nb * 4 + 4 + 256 * 4, 9 * nb)
    print(f"abs_histogram_fused n=2**20 f32, 256 bins, one launch (max|v|, "
          f"histogram): kernel {hf_ms:.4f} ms, op {hf_op:.4f} ms, plain "
          f"{hf_plain:.4f} ms, torch.histc(|v|) {hf_lib:.4f} ms (other bin "
          f"edges, yardstick only), bound {hf_bound:.5f} ms ({hf_by})")
    ah_ms = time_ms(lambda: ops.launch_dgc_topk(
        "abs_histogram", dv, d_work, 256, v_max=d_vmax.reshape(1)))
    ah_op = time_ms(lambda: ops.abs_histogram(dv, d_vmax))
    ah_plain = time_ms(lambda: ref.abs_histogram_ref(dv, 256, d_vmax))
    ah_lib = time_ms(histc)
    # v read, v_max read, 256 counts written; abs, divide, multiply,
    # convert, two clamps and the count's add an element
    ah_bound, ah_by = bound_ms(nb * 4 + 4 + 256 * 4, 7 * nb)
    print(f"abs_histogram n=2**20 f32, 256 bins, v_max given: kernel "
          f"{ah_ms:.4f} ms, op {ah_op:.4f} ms, plain {ah_plain:.4f} ms, "
          f"torch.histc(|v|) {ah_lib:.4f} ms (yardstick only), bound "
          f"{ah_bound:.5f} ms ({ah_by})")
    ds_ms = time_ms(lambda: ops.launch_dgc_topk(
        "dgc_select", dv, d_work, 256, out=d_out, threshold=d_t.reshape(1)))
    ds_op = time_ms(lambda: ops.dgc_select(dv, d_t))
    ds_plain = time_ms(lambda: ref.dgc_select_ref(dv, d_t))
    # v read, out written, t read, the count written; abs, compare, select
    ds_bound, ds_by = bound_ms(nb * 8 + 8, 3 * nb)
    print(f"dgc_select n=2**20 f32: kernel {ds_ms:.4f} ms, op {ds_op:.4f} "
          f"ms, plain {ds_plain:.4f} ms, bound {ds_bound:.5f} ms ({ds_by})")
    gn_t = {}
    for shape in ((128, 8, 8, 64), (100, 16, 16, 32), (2, 128, 128, 16)):
        C_ = shape[-1]
        gx = randn(*shape)
        gsc, gbi = torch.ones(C_, device=dev), torch.zeros(C_, device=dev)
        g_out = torch.empty_like(gx)
        route = ops.group_norm_route(shape, gx.dtype, 2)
        r = {"route": route,
             "ms": time_ms(lambda: ops.launch_group_norm(gx, gsc, gbi, g_out,
                                                         2, 1e-5)),
             "op_ms": time_ms(lambda: ops.group_norm(gx, gsc, gbi,
                                                     group_size=2)),
             "plain_ms": time_ms(lambda: ref.group_norm_ref(
                 gx, gsc, gbi, group_size=2)),
             "library_ms": time_ms(lambda: F.group_norm(
                 gx.permute(0, 3, 1, 2), C_ // 2, gsc, gbi))}
        if route == "sample":           # the earlier design, in this run
            r["group_route_ms"] = time_ms(lambda: ops.launch_group_norm(
                gx, gsc, gbi, g_out, 2, 1e-5, route="group"))
        # x read, y written, scale and bias read; ~8 flops an element
        r["bound_ms"], r["bound_by"] = bound_ms(
            2 * gx.numel() * 4 + 2 * C_ * 4, 8 * gx.numel())
        gn_t[shape] = r
        print(f"group_norm {shape} f32, group_size 2, {route} route: kernel "
              f"{r['ms']:.4f} ms, op {r['op_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, F.group_norm {r['library_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}), kernel / "
              f"bound {r['ms'] / r['bound_ms']:.1f}"
              + (f"; the (sample, group) route {r['group_route_ms']:.4f} ms"
                 if "group_route_ms" in r else ""))
        del gx, g_out
    for kname in ("dgc_topk", "group_norm"):
        print("\n".join(ptxas_lines(kname, logs[kname])) if kname in logs
              else f"  {kname}: no ptxas report (the library was up to date)")

    # flash_attention at the LM prefill's shape (bfloat16, causal) and at
    # the bench's (float32, causal)
    fa = {}
    for label, shape, dtype, rate in (
            ("prefill", FA_PREFILL, torch.bfloat16, BF16_FLOPS_PER_S),
            ("bench", (1, 4, 256, 256, 64), torch.float32,
             FP32_FLOPS_PER_S)):
        B_, H_, T_, _, D_ = shape
        q_, k_, v_ = (randn(B_, H_, T_, D_).to(dtype) for _ in range(3))
        o_ = torch.empty_like(q_)
        r = {"ms": time_ms(lambda: ops.launch_flash_attention(
                 q_, k_, v_, o_, causal=True, window=None,
                 logit_softcap=None, scale=D_ ** -0.5)),
             "op_ms": time_ms(lambda: ops.flash_attention(q_, k_, v_)),
             "plain_ms": time_ms(lambda: ref.flash_attention_ref(q_, k_,
                                                                 v_)),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                 q_, k_, v_, is_causal=True))}
        n_bytes, flops = attention_work(shape, q_.element_size())
        r["bound_ms"], r["bound_by"] = bound_ms(n_bytes, flops, rate)
        print(f"flash_attention {label} {shape} {str(dtype)[6:]} causal, "
              f"(B, H, T, D) launch: kernel {r['ms']:.4f} ms "
              f"({flops / r['ms'] / 1e9:.1f} TFLOP/s useful), op "
              f"{r['op_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}: {flops:.4g} flops, {n_bytes:.4g} bytes), "
              f"kernel / bound {r['ms'] / r['bound_ms']:.2f}")
        fa[label] = r
        del q_, k_, v_, o_
    # the model path's call: (B, T, H, D) views of the projections, 16
    # query heads over 8 KV heads, launched as the prefill launches it
    _, H_, _, _, D_ = FA_PREFILL_GQA
    qm, km, vm = fused_qkv(gen, dev, FA_PREFILL_GQA, FA_PREFILL_GROUP,
                           torch.bfloat16)
    om = torch.empty(qm.shape, dtype=qm.dtype, device=dev)
    qs, ks, vs = (t_.transpose(1, 2) for t_ in (qm, km, vm))
    r = {"ms": time_ms(lambda: ops.launch_flash_attention(
             qm, km, vm, om, causal=True, window=None, logit_softcap=None,
             scale=D_ ** -0.5, layout="bthd")),
         "op_ms": time_ms(lambda: ops.flash_attention_bthd(qm, km, vm)),
         "chunked_ms": time_ms(lambda: chunked_attention(qm, km, vm)),
         "plain_ms": time_ms(lambda: ref.flash_attention_bthd_ref(qm, km,
                                                                  vm)),
         "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
             qs, ks, vs, is_causal=True, enable_gqa=True))}
    n_bytes, flops = attention_work(FA_PREFILL, 2)
    n_bytes = (n_bytes // 2) * 3 // 2           # KV heads: half of k and v
    r["bound_ms"], r["bound_by"] = bound_ms(n_bytes, flops,
                                            BF16_FLOPS_PER_S)
    fa["prefill_gqa"] = r
    print(f"flash_attention prefill as the model calls it ((B, T, H, D) "
          f"views of a fused projection, {FA_PREFILL_GROUP * H_} over {H_} "
          f"KV heads, bfloat16, causal): kernel {r['ms']:.4f} ms "
          f"({flops / r['ms'] / 1e9:.1f} TFLOP/s useful, "
          f"{r['ms'] / r['bound_ms']:.2f}x the {r['bound_ms']:.5f} ms bound, "
          f"{r['bound_by']}), op {r['op_ms']:.4f} ms, chunked_attention "
          f"{r['chunked_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA "
          f"(enable_gqa, same views) {r['library_ms']:.4f} ms; the "
          f"(B, H, T, D) launch above {fa['prefill']['ms']:.4f} ms")
    del qm, km, vm, om, qs, ks, vs
    # the (Dk, Dv) pairs at a 2048-token prefill, bfloat16, causal
    B_, H_, T_ = FA_PAIR_TIMED
    fa["pairs"] = {}
    for dk_, dv_ in FA_PAIRS:
        q_, k_ = (randn(B_, H_, T_, dk_).to(torch.bfloat16) for _ in range(2))
        v_ = randn(B_, H_, T_, dv_).to(torch.bfloat16)
        o_ = torch.empty(B_, H_, T_, dv_, dtype=torch.bfloat16, device=dev)
        ms_ = time_ms(lambda: ops.launch_flash_attention(
            q_, k_, v_, o_, causal=True, window=None, logit_softcap=None,
            scale=dk_ ** -0.5))
        n_bytes, flops = attention_work((B_, H_, T_, T_, dk_), 2, dv=dv_)
        b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S)
        fa["pairs"][f"{dk_}x{dv_}"] = {"ms": ms_, "bound_ms": b_ms,
                                       "bound_by": b_by}
        print(f"flash_attention (Dk, Dv) = ({dk_}, {dv_}) at "
              f"{FA_PAIR_TIMED} bfloat16 causal: kernel {ms_:.4f} ms "
              f"({flops / ms_ / 1e9:.1f} TFLOP/s useful), bound {b_ms:.5f} "
              f"ms ({b_by}), kernel / bound {ms_ / b_ms:.2f}")
        del q_, k_, v_, o_
    # the pairs as phase 8's models launch them at their 4 x 2048 prefill,
    # bfloat16, causal: MLA's q and k contiguous and v the view kv[...,
    # nope:] of the expansion; phi-3-vision's q, k and v views of one
    # projection; beside the bound and SDPA on the same operands where one
    # of its fused backends takes the pair
    fa["models"] = {}
    for arch_ in FA_MODEL_ARCHS:
        a_ = get_config(arch_).attention
        H_ = a_.n_heads
        if a_.kind == "mla":
            dk_, dv_ = a_.nope_head_dim + a_.rope_head_dim, a_.v_head_dim
            q_, k_ = (randn(PREFILL_B, PREFILL_T, H_, dk_).to(torch.bfloat16)
                      for _ in range(2))
            v_ = randn(PREFILL_B, PREFILL_T, H_,
                       a_.nope_head_dim + dv_).to(torch.bfloat16)[
                ..., a_.nope_head_dim:]
        else:
            dk_ = dv_ = a_.head_dim
            q_, k_, v_ = fused_qkv(gen, dev, (PREFILL_B, H_, PREFILL_T,
                                              PREFILL_T, dk_), 1,
                                   torch.bfloat16)
        o_ = torch.empty(q_.shape[:3] + (dv_,), dtype=torch.bfloat16,
                         device=dev)
        ms_ = time_ms(lambda: ops.launch_flash_attention(
            q_, k_, v_, o_, causal=True, window=None, logit_softcap=None,
            scale=dk_ ** -0.5, layout="bthd"))
        # the op on the same operands against its plain version, every
        # mask, at the prefill's tolerances
        errs_ = []
        with tf32_off():
            for kw in FA_KWS:
                diff = (ops.flash_attention_bthd(q_, k_, v_, scale=dk_ ** -0.5,
                                                 **kw).float()
                        - ref.flash_attention_bthd_ref(
                            q_, k_, v_, scale=dk_ ** -0.5, **kw).float()
                        ).abs()
                err, mean = float(diff.max()), float(diff.mean())
                assert err <= FA_PREFILL_TOL and \
                    mean <= FA_PREFILL_MEAN_TOL, (arch_, kw, err, mean)
                fa_prefill_max = max(fa_prefill_max, err)
                errs_.append(f"{kw}: max {err:.3g}, mean {mean:.3g}")
                del diff
        n_bytes, flops = attention_work(
            (PREFILL_B, H_, PREFILL_T, PREFILL_T, dk_), 2, dv=dv_)
        b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S)
        qs_, ks_, vs_ = (t_.transpose(1, 2) for t_ in (q_, k_, v_))
        backends_ = sdpa_backends(qs_, ks_, vs_)
        lib_ = (time_ms(lambda: F.scaled_dot_product_attention(
            qs_, ks_, vs_, is_causal=True)) if backends_ else None)
        fa["models"][arch_] = {
            "shape": [PREFILL_B, PREFILL_T, H_, dk_, dv_], "ms": ms_,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_,
            "sdpa_backends": backends_, "errors": errs_}
        print(f"flash_attention at {arch_}'s prefill ((B, T, H) = "
              f"({PREFILL_B}, {PREFILL_T}, {H_}), (Dk, Dv) = ({dk_}, {dv_}), "
              f"bfloat16, causal, as the model launches it): kernel "
              f"{ms_:.4f} ms ({flops / ms_ / 1e9:.1f} TFLOP/s useful), bound "
              f"{b_ms:.5f} ms ({b_by}: {flops:.4g} flops, {n_bytes:.4g} "
              f"bytes), kernel / bound {ms_ / b_ms:.2f}; "
              + (f"SDPA {lib_:.4f} ms (fused backends that take it: "
                 f"{backends_})" if backends_ else
                 "SDPA refuses: none of its fused backends takes the pair")
              + f"; op against plain (tol {FA_PREFILL_TOL:g}, mean "
              f"{FA_PREFILL_MEAN_TOL:g}) |err| {'; '.join(errs_)}")
        del q_, k_, v_, o_, qs_, ks_, vs_
    # phase 9's models' shapes, bfloat16, as the models launch them (views
    # of one projection), beside the bound and SDPA on the same operands
    # (a yardstick only: it rounds p to bfloat16; recurrentgemma's window
    # of 2048 cuts no key at 2048 tokens, so causal SDPA computes the same
    # function there; the 4096-token shape is checked in phase 3 only)
    fa["new_models"] = {}
    for label, shape, group, kw in FA_NEW_SHAPES:
        B_, Hkv_, Tq_, Tk_, D_ = shape
        if Tq_ > PREFILL_T:
            continue
        q_, k_, v_ = fused_qkv(gen, dev, shape, group, torch.bfloat16)
        o_ = torch.empty(q_.shape, dtype=torch.bfloat16, device=dev)
        ms_ = time_ms(lambda: ops.launch_flash_attention(
            q_, k_, v_, o_, causal=kw["causal"], window=kw.get("window"),
            logit_softcap=None, scale=D_ ** -0.5, layout="bthd"))
        n_bytes, flops = attention_work((B_, Hkv_ * group, Tq_, Tk_, D_), 2,
                                        causal=kw["causal"], hkv=Hkv_)
        b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S)
        qs_, ks_, vs_ = (t_.transpose(1, 2) for t_ in (q_, k_, v_))
        sdpa_kw = {"is_causal": kw["causal"], "enable_gqa": group > 1}
        backends_ = sdpa_backends(qs_, ks_, vs_, **sdpa_kw)
        lib_ = (time_ms(lambda: F.scaled_dot_product_attention(
            qs_, ks_, vs_, **sdpa_kw)) if backends_ else None)
        fa["new_models"][label] = {
            "shape": [B_, Tq_, Tk_, Hkv_ * group, Hkv_, D_], "mask": kw,
            "ms": ms_, "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
            "library_ms": lib_, "sdpa_backends": backends_}
        print(f"flash_attention at {label} ((B, Tq, Tk) = ({B_}, {Tq_}, "
              f"{Tk_}), {Hkv_ * group} query heads over {Hkv_} of {D_}, "
              f"bfloat16, {kw}, as the model launches it): kernel "
              f"{ms_:.4f} ms ({flops / ms_ / 1e9:.1f} TFLOP/s useful), bound "
              f"{b_ms:.5f} ms ({b_by}: {flops:.4g} flops, {n_bytes:.4g} "
              f"bytes), kernel / bound {ms_ / b_ms:.2f}; "
              + (f"SDPA {lib_:.4f} ms (fused backends that take it: "
                 f"{backends_})" if backends_ else
                 "SDPA refuses: none of its fused backends takes it"))
        del q_, k_, v_, o_, qs_, ks_, vs_
    # the instances phase 9's models run: D 256 (recurrentgemma, gemma2)
    # and D 64 (seamless) on the tensor cores
    tc_lines = [l_ for l_ in ptxas_lines("flash_attention",
                                        logs.get("flash_attention", ""))
                if re.search(r"flash_attention_tc<(256|64),", l_)]
    print("\n".join(tc_lines) if tc_lines else
          "  flash_attention_tc<256>, <64>: no ptxas report (the library "
          "was up to date)")
    sys.stdout.flush()

    # ---------------------------------------------------------------- 6
    phase(6, "the kernel bench on the card "
             "(python -m repro_torch.benchmarks.kernels_bench)")
    bench_json = ROOT / "build" / "kernels_bench.json"
    bench_json.parent.mkdir(exist_ok=True)
    for k_ in ops.launches:
        ops.launches[k_] = 0
    torch.cuda.synchronize()
    assert kernels_bench.main(["--json", str(bench_json)]) == 0
    torch.cuda.synchronize()
    bench_launches = dict(ops.launches)
    rows = json.loads(bench_json.read_text())["rows"]
    assert [r["name"] for r in rows] == list(BENCH_ROWS), rows
    assert all(np.isfinite(r["us_per_call"]) and r["us_per_call"] > 0
               for r in rows), rows
    for k_ in ("gaia_select", "rand_k_select", "neighbor_mix",
               "dgc_sparsify", "group_norm", "flash_attention"):
        assert bench_launches[k_] > 0, (k_, bench_launches)
    # the bench's DGC row makes one launch a call and no other, and so do
    # its parts' rows, one row each; the list ops one launch a call
    for k_ in ("dgc_sparsify", "abs_histogram_fused", "abs_histogram",
               "dgc_select"):
        assert bench_launches[k_] == BENCH_CALLS, (k_, bench_launches)
    assert bench_launches["neighbor_mix_src"] == 2 * BENCH_CALLS, \
        bench_launches
    print(f"bench-path launches: {bench_launches}")
    print("bench rows (us a call): " + json.dumps(
        {r["name"]: round(r["us_per_call"], 3) for r in rows}))
    # the report twin's gate over the rows just written: a verdict a
    # kernel row with an oracle twin, reported, not asserted (each row a
    # call's device time behind a spin kernel: flash_attention at the
    # bench's shape is slower than its plain version, a known finding)
    twins = sorted(r["name"].split("/", 1)[1] for r in rows
                   if r["name"].startswith("kernel/")
                   and f"oracle/{r['name'].split('/', 1)[1]}" in BENCH_ROWS)
    gate_rc = bench_report.gate(str(bench_json))
    verdicts = bench_report.gate_rows(
        {r["name"]: r["us_per_call"] for r in rows})
    assert [v_["op"] for v_ in verdicts] == twins, (verdicts, twins)
    print(f"the bench gate (repro_torch.benchmarks.report --gate, noise "
          f"band 0.5) over {len(verdicts)} kernel rows: exit {gate_rc}; "
          f"slower than the plain version: "
          f"{[v_['op'] for v_ in verdicts if v_['ratio'] > 1]}; beyond the "
          f"band: {[v_['op'] for v_ in verdicts if not v_['ok']]}")
    sys.stdout.flush()

    # ---------------------------------------------------------------- 7
    phase(7, "LM serving on the card: qwen3-0.6b at full width, bfloat16")
    lm_cfg = get_config("qwen3-0.6b")
    V = lm_cfg.vocab
    t0 = time.perf_counter()
    lm_params = lm.init_model(torch.Generator(device=dev).manual_seed(0),
                              lm_cfg, dev)
    torch.cuda.synchronize()
    print(f"qwen3-0.6b: {tree_numel(lm_params)} parameters "
          f"({lm_cfg.n_layers} layers, d_model {lm_cfg.d_model}, "
          f"{lm_cfg.attention.n_heads} heads over "
          f"{lm_cfg.attention.n_kv_heads} KV heads of "
          f"{lm_cfg.attention.head_dim}, vocab {V}), {lm_cfg.dtype}, drawn "
          f"on the card in {time.perf_counter() - t0:.2f} s")
    rs = np.random.default_rng(0)

    # (a) prefill: the main path of this slice
    tokens = torch.from_numpy(rs.integers(0, V, (PREFILL_B, PREFILL_T))).to(
        dev)
    prefill = make_prefill_step(lm_cfg)
    with torch.inference_mode():
        prefill(lm_params, {"tokens": tokens})      # warm-up: cuBLAS, allocator
        torch.cuda.synchronize()
        for k_ in ops.launches:
            ops.launches[k_] = 0
        times = []
        for _ in range(PREFILL_CALLS):
            t0 = time.perf_counter()
            nxt = prefill(lm_params, {"tokens": tokens})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        lm_launches = dict(ops.launches)
    assert lm_launches["flash_attention"] == lm_cfg.n_layers * PREFILL_CALLS, \
        lm_launches
    assert sum(lm_launches.values()) == lm_launches["flash_attention"], \
        lm_launches
    assert nxt.shape == (PREFILL_B, V) and nxt.dtype == torch.float32
    assert bool(torch.isfinite(nxt).all())
    prefill_ms = float(np.median(times)) * 1e3
    prefill_tok_s = PREFILL_B * PREFILL_T / (prefill_ms / 1e3)
    print(f"prefill {PREFILL_B} x {PREFILL_T} tokens: {prefill_ms:.2f} ms a "
          f"call (median of {PREFILL_CALLS}, wall, synchronised), "
          f"{prefill_tok_s:.1f} tokens/s; launches {lm_launches} "
          f"({lm_launches['flash_attention'] // PREFILL_CALLS} flash_attention "
          f"a call); the {lm_cfg.n_layers} kernel launches at phase 5's "
          f"{fa['prefill_gqa']['ms']:.4f} ms are "
          f"{100 * lm_cfg.n_layers * fa['prefill_gqa']['ms'] / prefill_ms:.1f}"
          f"% of the call")

    # (b) decode: the serve_decode example's loop
    prompt = torch.from_numpy(rs.integers(0, V, (SERVE_B, SERVE_PROMPT))).to(
        dev)
    # a short warm-up, as phases 8-9's (a whole loop until the smoke
    # needed the time)
    serve_decode.serve(lm_params, lm_cfg, prompt[:, :4], 2, SERVE_CACHE)
    for k_ in ops.launches:
        ops.launches[k_] = 0
    gen_tok, secs = serve_decode.serve(lm_params, lm_cfg, prompt, SERVE_GEN,
                                       SERVE_CACHE)
    assert gen_tok.shape == (SERVE_B, SERVE_GEN)
    assert int(gen_tok.min()) >= 0 and int(gen_tok.max()) < V
    assert sum(ops.launches.values()) == 0, ops.launches   # no kernel decodes
    decode_tok_s = SERVE_B * (SERVE_PROMPT + SERVE_GEN - 1) / secs
    print(f"decode: {SERVE_B} requests x ({SERVE_PROMPT} prompt + "
          f"{SERVE_GEN - 1} generated) steps over {SERVE_CACHE} cache slots "
          f"in {secs:.3f} s (wall), {decode_tok_s:.1f} tokens/s, "
          f"{secs / (SERVE_PROMPT + SERVE_GEN - 1) * 1e3:.2f} ms a step; "
          f"request 0: {gen_tok[0, :8].tolist()} ...")

    # where a prefill call and a decode step spend the card's time
    with torch.inference_mode():
        busy, n_kern, per_kernel = device_profile(
            lambda: prefill(lm_params, {"tokens": tokens}))
    fa_busy = sum(v for k, v in per_kernel.items() if "flash_attention" in k)
    gemm_busy = sum(v for k, v in per_kernel.items()
                    if any(w in k.lower() for w in ("gemm", "nvjet", "sm90")))
    print(f"prefill call under torch.profiler: {n_kern} kernel launches, "
          f"device busy {busy:.2f} ms of the unprofiled {prefill_ms:.2f} ms "
          f"wall (idle {100 * (1 - busy / prefill_ms):.1f}%): "
          f"flash_attention {fa_busy:.2f} ms, GEMMs {gemm_busy:.2f} ms, "
          f"other {busy - fa_busy - gemm_busy:.2f} ms; top kernels "
          + json.dumps({k[:60]: round(v, 3) for k, v in sorted(
              per_kernel.items(), key=lambda kv: -kv[1])[:6]}))
    step_ms = secs / (SERVE_PROMPT + SERVE_GEN - 1) * 1e3
    d_cache = lm.init_cache(lm_cfg, SERVE_B, SERVE_CACHE, device=dev)
    d_batch = {"token": prompt[:, 0],
               "t": torch.zeros(SERVE_B, dtype=torch.int32, device=dev)}
    with torch.inference_mode():
        busy, n_kern, _ = device_profile(
            lambda: lm.decode_step(lm_params, lm_cfg, d_batch, d_cache))
    print(f"decode step under torch.profiler: {n_kern} kernel launches, "
          f"device busy {busy:.2f} ms of the unprofiled {step_ms:.2f} ms "
          f"wall a step (idle {100 * (1 - busy / step_ms):.1f}%)")

    # (c) prefill/decode agreement at full width: the kernel's causal
    # prefill against the kernel-free decode path, position by position, in
    # bfloat16 and, on the same weights cast, in float32 (TF32 off)
    agree_tok = torch.from_numpy(rs.integers(0, V, (AGREE_B, AGREE_T))).to(dev)

    cfg32 = dataclasses.replace(lm_cfg, dtype="float32")
    with torch.inference_mode(), tf32_off():
        full16, dec16 = prefill_and_decode(lm, lm_params, lm_cfg, agree_tok)
        full32, dec32 = prefill_and_decode(
            lm, tree_to(lm_params, torch.float32), cfg32, agree_tok)
        gaps = {"bf16 prefill vs bf16 decode": logit_gap(full16, dec16),
                "f32 prefill vs f32 decode": logit_gap(full32, dec32),
                "bf16 prefill vs f32 prefill": logit_gap(full16, full32),
                "bf16 decode vs f32 decode": logit_gap(dec16, dec32)}
        logit_std = float(full32.std())
    n_pos = AGREE_B * AGREE_T
    for label, (mx, mean, same) in gaps.items():
        print(f"{label}, {AGREE_B} x {AGREE_T} tokens: max |logit "
              f"difference| {mx:.4g}, mean {mean:.4g}, greedy tokens equal at "
              f"{same} of {n_pos} positions (logits' std {logit_std:.4g})")
    mx, mean, same = gaps["f32 prefill vs f32 decode"]
    assert mx <= AGREE_TOL_F32 and same >= AGREE_SAME_F32 * n_pos, (mx, same)
    mx, mean, _ = gaps["bf16 prefill vs bf16 decode"]
    assert mx <= AGREE_TOL_BF16 and mean <= AGREE_MEAN_BF16, (mx, mean)
    print(f"prefill/decode agreement holds: float32 max <= {AGREE_TOL_F32}, "
          f"greedy equal at >= {AGREE_SAME_F32:.0%}; bfloat16 (28 layers of "
          f"bfloat16 rounding) max <= {AGREE_TOL_BF16}, mean <= "
          f"{AGREE_MEAN_BF16}")
    del full16, dec16, full32, dec32, lm_params

    # (d) every arch of the registry, reduced, float32: card against CPU
    # (the VLM with its reduced patches; the MoE archs' aux too)
    with tf32_off():
        for arch in ARCH_IDS:
            rcfg = get_config(arch).reduced()
            p_cpu = lm.init_model(torch.Generator().manual_seed(1), rcfg,
                                  "cpu")
            r_batch = {"tokens": torch.from_numpy(
                rs.integers(0, rcfg.vocab, (2, 96)))}
            if rcfg.modality.kind == "vision":
                r_batch["patches"] = torch.from_numpy(rs.standard_normal(
                    (2, rcfg.modality.n_tokens,
                     rcfg.modality.feat_dim)).astype(np.float32))
            if rcfg.encoder is not None:
                r_batch["frames"] = torch.from_numpy(rs.standard_normal(
                    (2, rcfg.encoder.n_frames,
                     rcfg.modality.feat_dim)).astype(np.float32))
            cpu_logits, cpu_aux = lm.forward(p_cpu, rcfg, r_batch)
            card_logits, card_aux = lm.forward(
                tree_to(p_cpu, dev), rcfg,
                {k_: v_.to(dev) for k_, v_ in r_batch.items()})
            np.testing.assert_allclose(card_logits.cpu().numpy(),
                                       cpu_logits.numpy(), rtol=1e-3,
                                       atol=1e-3)
            np.testing.assert_allclose(float(card_aux), float(cpu_aux),
                                       rtol=1e-3, atol=1e-3)
            a_ = rcfg.attention
            print(f"{arch} reduced ({rcfg.n_layers} layers, d_model "
                  f"{rcfg.d_model}, {a_.kind}, windows "
                  f"{[rcfg.attn_window(i) for i in range(rcfg.n_layers)]}, "
                  f"softcap {a_.attn_softcap}, experts "
                  f"{rcfg.moe.n_experts}, mixers "
                  f"{[rcfg.block_kind(i) for i in range(rcfg.n_layers)]}, "
                  f"patches "
                  f"{tuple(r_batch.get('patches', torch.empty(0)).shape)}, "
                  f"frames "
                  f"{tuple(r_batch.get('frames', torch.empty(0)).shape)}"
                  f"), 2 x 96 tokens: card and CPU logits agree (rtol 1e-3, "
                  f"atol 1e-3, TF32 off), max |diff| "
                  f"{float((card_logits.cpu() - cpu_logits).abs().max()):.3g}"
                  f"; aux card {float(card_aux):.6g}, CPU "
                  f"{float(cpu_aux):.6g}")
    print("serving: " + json.dumps({
        "prefill_tokens_per_s": prefill_tok_s, "prefill_ms": prefill_ms,
        "decode_tokens_per_s": decode_tok_s}))
    sys.stdout.flush()

    # ---------------------------------------------------------------- 8
    phase(8, "LM serving of the MLA, MoE and VLM families at full width, "
             "bfloat16")
    torch.cuda.empty_cache()
    serving8 = {}

    def init_full(arch, cfg_=None, seed=0):
        """The arch's random weights from a seeded generator on the card,
        its parameter counts, draw time and peak memory printed."""
        cfg_ = cfg_ or get_config(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before_ = torch.cuda.memory_allocated()
        t0_ = time.perf_counter()
        params_ = lm.init_model(torch.Generator(device=dev).manual_seed(seed),
                                cfg_, dev)
        torch.cuda.synchronize()
        secs_ = time.perf_counter() - t0_
        a_ = cfg_.attention
        dims_ = ((a_.nope_head_dim + a_.rope_head_dim, a_.v_head_dim)
                 if a_.kind == "mla" else (a_.head_dim, a_.head_dim))
        kinds_ = [cfg_.block_kind(i) for i in range(cfg_.n_layers)]
        enc_ = (f", an encoder of {cfg_.encoder.n_layers} layers at d_model "
                f"{cfg_.encoder.d_model}" if cfg_.encoder else "")
        print(f"{arch}: {cfg_.n_params()} parameters by the config's count, "
              f"{tree_numel(params_)} in the tree (norms included); "
              f"{cfg_.n_layers} layers ("
              + ", ".join(f"{kinds_.count(k_)} {k_}"
                          for k_ in dict.fromkeys(kinds_))
              + f"{enc_}), d_model {cfg_.d_model}, {a_.kind} "
              f"attention of {a_.n_heads} heads at (Dk, Dv) = {dims_}, "
              f"{cfg_.moe.n_experts} routed experts (top {cfg_.moe.top_k}) "
              f"and {cfg_.moe.n_shared} shared, vocab {cfg_.vocab}, "
              f"{cfg_.dtype}; drawn on the card in {secs_:.2f} s, peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"({before_ / 2**30:.2f} GiB allocated before the draw, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} after)",
              flush=True)
        return cfg_, params_

    def time_prefill(arch, cfg_, params_, batch_, per_call=None):
        """``make_prefill_step`` on ``batch_``, the launch counts set to 0
        just before the timed calls and read just after: ``per_call``
        ``flash_attention`` launches a call (one a layer by default), no
        other kernel of the port."""
        per_call = cfg_.n_layers if per_call is None else per_call
        prefill_ = make_prefill_step(cfg_)
        with torch.inference_mode():
            prefill_(params_, batch_)           # warm-up: cuBLAS, allocator
            torch.cuda.synchronize()
            for k_ in ops.launches:
                ops.launches[k_] = 0
            times_ = []
            for _ in range(PREFILL_CALLS):
                t0_ = time.perf_counter()
                nxt_ = prefill_(params_, batch_)
                torch.cuda.synchronize()
                times_.append(time.perf_counter() - t0_)
            made_ = dict(ops.launches)
        assert made_["flash_attention"] == per_call * PREFILL_CALLS, \
            (arch, made_)
        assert sum(made_.values()) == made_["flash_attention"], (arch, made_)
        assert nxt_.shape == (PREFILL_B, cfg_.vocab), nxt_.shape
        assert nxt_.dtype == torch.float32 and bool(torch.isfinite(nxt_).all())
        ms_ = float(np.median(times_)) * 1e3
        tok_s_ = PREFILL_B * PREFILL_T / (ms_ / 1e3)
        print(f"{arch} prefill {PREFILL_B} x {PREFILL_T} positions: "
              f"{ms_:.2f} ms a call (median of {PREFILL_CALLS}: "
              f"{[round(t_ * 1e3, 2) for t_ in times_]}, wall, "
              f"synchronised), {tok_s_:.1f} tokens/s; launches {made_} "
              f"({made_['flash_attention'] // PREFILL_CALLS} flash_attention "
              f"a call)", flush=True)
        return prefill_, {"prefill_ms": ms_, "prefill_tokens_per_s": tok_s_,
                          "flash_attention_launches":
                              made_["flash_attention"]}

    def time_decode(arch, cfg_, params_, frames_=None):
        """The ``serve_decode`` example's loop: SERVE_B requests, no kernel
        launch, but for an enc-dec the encoder's on ``frames_`` once and a
        cross-attention launch a layer a step; then one decode step's host
        syncs (PyTorch's sync debug mode)."""
        prompt_ = torch.from_numpy(rs.integers(
            0, cfg_.vocab, (SERVE_B, SERVE_PROMPT))).to(dev)
        serve_decode.serve(params_, cfg_, prompt_[:, :4], 2, SERVE_CACHE,
                           frames_)
        for k_ in ops.launches:
            ops.launches[k_] = 0
        gen_, secs_ = serve_decode.serve(params_, cfg_, prompt_, SERVE_GEN,
                                         SERVE_CACHE, frames_)
        made_ = dict(ops.launches)
        assert gen_.shape == (SERVE_B, SERVE_GEN)
        assert int(gen_.min()) >= 0 and int(gen_.max()) < cfg_.vocab
        n_steps_ = SERVE_PROMPT + SERVE_GEN - 1
        want_ = (0 if cfg_.encoder is None else
                 cfg_.encoder.n_layers + cfg_.n_layers * n_steps_)
        assert made_["flash_attention"] == want_, (arch, made_)
        assert sum(made_.values()) == want_, (arch, made_)
        cache_ = lm.init_cache(cfg_, SERVE_B, SERVE_CACHE, device=dev)
        batch_ = {"token": prompt_[:, 0],
                  "t": torch.zeros(SERVE_B, dtype=torch.int32, device=dev)}
        if frames_ is not None:
            batch_["frames"] = frames_
        with torch.inference_mode():
            syncs_ = count_syncs(
                lambda: lm.decode_step(params_, cfg_, batch_, cache_))
        r_ = {"decode_tokens_per_s": SERVE_B * n_steps_ / secs_,
              "decode_step_ms": secs_ / n_steps_ * 1e3,
              "decode_syncs_per_step": syncs_,
              "decode_flash_attention_launches": want_}
        print(f"{arch} decode: {SERVE_B} requests x ({SERVE_PROMPT} prompt + "
              f"{SERVE_GEN - 1} generated) steps over {SERVE_CACHE} cache "
              f"slots in {secs_:.3f} s (wall), "
              f"{r_['decode_tokens_per_s']:.1f} tokens/s, "
              f"{r_['decode_step_ms']:.2f} ms a step, {syncs_} host syncs a "
              f"step, {want_} flash_attention launches in the loop; request "
              f"0: {gen_[0, :8].tolist()} ...", flush=True)
        return r_

    def agreement(label, params_, cfg_, tokens_, extra_=None):
        """Prefill against decode on ``tokens_`` (and ``extra_``, an
        enc-dec's frames): the gaps printed and returned."""
        with torch.inference_mode(), tf32_off():
            full_, dec_ = prefill_and_decode(lm, params_, cfg_, tokens_,
                                             extra_)
        mx_, mean_, same_ = logit_gap(full_, dec_)
        n_ = tokens_.numel()
        print(f"{label}, {tuple(tokens_.shape)} tokens: prefill vs decode "
              f"max |logit difference| {mx_:.4g}, mean {mean_:.4g}, greedy "
              f"tokens equal at {same_} of {n_} positions (logits' std "
              f"{float(full_.std()):.4g})", flush=True)
        return mx_, mean_, same_, n_

    def routed(fn):
        """``fn()`` and the routes it took: each prefill call's experts (L,
        T, k) and router probabilities (L, T, E), and the decode steps'
        experts (L, T, k), for one sequence of T tokens over L MoE
        layers."""
        calls_ = []
        route0_ = moe_mod.moe_route

        def route_(p_, m_, xf_):
            out_ = route0_(p_, m_, xf_)
            calls_.append((out_[0], out_[2]))
            return out_
        with swapped(moe_mod, "moe_route", route_):
            r_ = fn()
        pre_ = [c_ for c_ in calls_ if c_[1].shape[0] > 1]
        dec_ = [c_[1] for c_ in calls_ if c_[1].shape[0] == 1]
        L_ = len(pre_)
        pre_e_ = (torch.stack([c_[1] for c_ in pre_]) if pre_ else None)
        pre_p_ = (torch.stack([c_[0] for c_ in pre_]) if pre_ else None)
        dec_e_ = (torch.stack(dec_).view(-1, L_, dec_[0].shape[1])
                  .transpose(0, 1) if dec_ else None)
        return r_, (pre_e_, pre_p_, dec_e_)

    def route_diff(a_, b_):
        """(token, expert) pairs of routes ``a_`` (L, T, k) absent from
        ``b_``, a layer."""
        hit_ = (a_[..., :, None] == b_[..., None, :]).any(-1)
        return (~hit_).sum(dim=(1, 2)).tolist()

    # (a) deepseek-v2-lite-16b, MLA over MoE: the main path of this slice
    ds_cfg, ds_params = init_full("deepseek-v2-lite-16b")
    serving8["deepseek-v2-lite-16b"] = {
        "init_peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    ds_tokens = torch.from_numpy(rs.integers(
        0, ds_cfg.vocab, (PREFILL_B, PREFILL_T))).to(dev)
    ds_prefill, r = time_prefill("deepseek-v2-lite-16b", ds_cfg, ds_params,
                                 {"tokens": ds_tokens})
    serving8["deepseek-v2-lite-16b"].update(r)
    serving8["deepseek-v2-lite-16b"].update(
        time_decode("deepseek-v2-lite-16b", ds_cfg, ds_params))
    # prefill against decode at 1 x MOE_AGREE_T tokens, where the capacity
    # (8 slots) drops no (token, expert) pair on either path: bfloat16 at
    # full depth, then float32 (TF32 off) on a cut of the first layers,
    # every width as published
    ds_agree = torch.from_numpy(rs.integers(
        0, ds_cfg.vocab, (1, MOE_AGREE_T))).to(dev)
    (mx, mean, same, n_), (pre_e, pre_p, dec_e) = routed(lambda: agreement(
        f"deepseek-v2-lite-16b bf16, {ds_cfg.n_layers} layers", ds_params,
        ds_cfg, ds_agree))
    serving8["deepseek-v2-lite-16b"]["agree_bf16"] = [mx, mean, same, n_]
    # the bfloat16 gap's witnesses: the experts each path routes every
    # token to at each MoE layer, and the prefill with the plain attention
    # in the kernel's place, against the same decode
    with torch.inference_mode(), tf32_off():
        full_k, _ = lm.forward(ds_params, ds_cfg, {"tokens": ds_agree})
        with swapped(ops, "flash_attention_bthd",
                     ref.flash_attention_bthd_ref):
            full_p, (plain_e, _, _) = routed(lambda: lm.forward(
                ds_params, ds_cfg, {"tokens": ds_agree})[0])
        cache_ = lm.init_cache(ds_cfg, 1, MOE_AGREE_T, device=dev)
        dec_ = []
        for t_ in range(MOE_AGREE_T):
            logits_, cache_ = lm.decode_step(
                ds_params, ds_cfg, {"token": ds_agree[:, t_], "t": torch.full(
                    (1,), t_, dtype=torch.int32, device=dev)}, cache_)
            dec_.append(logits_)
        dec_ = torch.stack(dec_, dim=1)
    k_top = ds_cfg.moe.top_k
    margin = (lambda v_: v_[..., k_top - 1] - v_[..., k_top])(
        torch.topk(pre_p, k_top + 1, dim=-1).values)          # (L, T)
    wit = {"kernel_vs_decode": logit_gap(full_k, dec_),
           "plain_vs_decode": logit_gap(full_p, dec_),
           "kernel_vs_plain": logit_gap(full_k, full_p),
           "routes_differ_kernel_vs_decode": route_diff(pre_e, dec_e),
           "routes_differ_plain_vs_decode": route_diff(plain_e, dec_e),
           "routes_differ_kernel_vs_plain": route_diff(pre_e, plain_e),
           "least_topk_margin_by_layer": margin.min(dim=1).values.tolist()}
    serving8["deepseek-v2-lite-16b"]["agree_bf16_witness"] = wit
    first_ = {k_: next((i_ for i_, n_d in enumerate(v_) if n_d), None)
              for k_, v_ in wit.items() if k_.startswith("routes")}
    print(f"deepseek-v2-lite-16b bf16, {tuple(ds_agree.shape)} tokens, "
          f"(max, mean |logit difference|, greedy equal): kernel prefill vs "
          f"decode {wit['kernel_vs_decode']}, plain-attention prefill vs "
          f"decode {wit['plain_vs_decode']}, kernel vs plain prefill "
          f"{wit['kernel_vs_plain']}; (token, expert) pairs routed "
          f"differently at each of the {len(pre_e)} MoE layers, kernel "
          f"prefill vs decode {wit['routes_differ_kernel_vs_decode']}, plain "
          f"vs decode {wit['routes_differ_plain_vs_decode']}, kernel vs "
          f"plain {wit['routes_differ_kernel_vs_plain']} (first MoE layer "
          f"that differs: {first_}); the prefill's least gap between the "
          f"k-th and (k+1)-th router probability a layer "
          f"{[float(f'{m_:.3g}') for m_ in margin.min(dim=1).values]}",
          flush=True)
    del full_k, full_p, dec_, cache_
    cut_cfg = dataclasses.replace(ds_cfg, n_layers=MOE_CUT_LAYERS)
    _, cut16 = init_full("deepseek-v2-lite-16b, first "
                         f"{MOE_CUT_LAYERS} layers", cut_cfg, seed=1)
    agreement(f"deepseek-v2-lite-16b bf16, {MOE_CUT_LAYERS}-layer cut",
              cut16, cut_cfg, ds_agree)
    cut32 = tree_to(cut16, torch.float32)
    del cut16
    mx, mean, same, n_ = agreement(
        f"deepseek-v2-lite-16b f32, {MOE_CUT_LAYERS}-layer cut (1 dense, "
        f"{MOE_CUT_LAYERS - 1} MoE)", cut32,
        dataclasses.replace(cut_cfg, dtype="float32"), ds_agree)
    serving8["deepseek-v2-lite-16b"]["agree_f32_cut"] = [mx, mean, same, n_]
    assert mx <= AGREE_TOL_F32 and same == n_, (mx, same)
    del cut32
    print(f"deepseek-v2-lite-16b prefill/decode agreement holds: float32 "
          f"max <= {AGREE_TOL_F32}, every greedy token equal", flush=True)

    # (b) minicpm3-4b, dense MLA (q_lora)
    mc_cfg, mc_params = init_full("minicpm3-4b")
    mc_tokens = torch.from_numpy(rs.integers(
        0, mc_cfg.vocab, (PREFILL_B, PREFILL_T))).to(dev)
    _, r = time_prefill("minicpm3-4b", mc_cfg, mc_params,
                        {"tokens": mc_tokens})
    serving8["minicpm3-4b"] = r
    serving8["minicpm3-4b"].update(
        time_decode("minicpm3-4b", mc_cfg, mc_params))
    mc_agree = torch.from_numpy(rs.integers(
        0, mc_cfg.vocab, (AGREE_B, AGREE_T))).to(dev)
    r16 = agreement("minicpm3-4b bf16", mc_params, mc_cfg, mc_agree)
    r32 = agreement("minicpm3-4b f32 (the same weights cast)",
                    tree_to(mc_params, torch.float32),
                    dataclasses.replace(mc_cfg, dtype="float32"), mc_agree)
    serving8["minicpm3-4b"].update({"agree_bf16": list(r16),
                                    "agree_f32": list(r32)})
    assert r32[0] <= AGREE_TOL_F32 and r32[2] >= AGREE_SAME_F32 * r32[3], r32
    print(f"minicpm3-4b prefill/decode agreement holds: float32 max <= "
          f"{AGREE_TOL_F32}, greedy equal at >= {AGREE_SAME_F32:.0%}; "
          f"bfloat16 within qwen3's {AGREE_TOL_BF16} / {AGREE_MEAN_BF16}: "
          f"{r16[0] <= AGREE_TOL_BF16 and r16[1] <= AGREE_MEAN_BF16} "
          f"(reported, not gated)", flush=True)
    del mc_params

    # (c) phi-3-vision-4.2b: the patches prepended to the text
    pv_cfg, pv_params = init_full("phi-3-vision-4.2b")
    n_vis = pv_cfg.modality.n_tokens
    pv_batch = {
        "tokens": torch.from_numpy(rs.integers(
            0, pv_cfg.vocab, (PREFILL_B, PREFILL_T - n_vis))).to(dev),
        "patches": torch.randn(
            PREFILL_B, n_vis, pv_cfg.modality.feat_dim, device=dev,
            generator=torch.Generator(device=dev).manual_seed(2))}
    _, r = time_prefill("phi-3-vision-4.2b", pv_cfg, pv_params, pv_batch)
    serving8["phi-3-vision-4.2b"] = r
    with torch.inference_mode():
        pv_logits, pv_aux = lm.forward(pv_params, pv_cfg, pv_batch)
    assert pv_logits.shape == (PREFILL_B, PREFILL_T - n_vis, pv_cfg.vocab), \
        pv_logits.shape
    assert bool(torch.isfinite(pv_logits).all()) and float(pv_aux) == 0.0
    print(f"phi-3-vision-4.2b forward of {PREFILL_B} x ({n_vis} patches + "
          f"{PREFILL_T - n_vis} text tokens): logits "
          f"{tuple(pv_logits.shape)} over the text positions only, finite",
          flush=True)
    del pv_logits
    serving8["phi-3-vision-4.2b"].update(
        time_decode("phi-3-vision-4.2b", pv_cfg, pv_params))
    del pv_params

    # ---------------------------------------------------------------- 9
    phase(9, "LM serving of the SSM, RG-LRU and enc-dec families at full "
             "width, bfloat16")
    serving9 = {}

    def frames_for(cfg_, B_, seed_):
        """{"frames": an enc-dec's random (B_, n_frames, feat_dim) frames in
        bfloat16, from a seeded generator on the card, as the reference's
        serving specs have them}, or {} for another arch."""
        if cfg_.encoder is None:
            return {}
        return {"frames": torch.randn(
            B_, cfg_.encoder.n_frames, cfg_.modality.feat_dim, device=dev,
            generator=torch.Generator(device=dev).manual_seed(seed_)).to(
                torch.bfloat16)}

    def cut(cfg_, n_):
        """``cfg_`` on its first ``n_`` layers, and an encoder's."""
        enc_ = (dataclasses.replace(cfg_.encoder, n_layers=n_)
                if cfg_.encoder else None)
        return dataclasses.replace(cfg_, n_layers=n_, encoder=enc_)

    for arch9, per_call9 in NEW_ARCHS.items():
        cfg9, p9 = init_full(arch9)
        r9 = serving9[arch9] = {
            "init_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "params_by_config": cfg9.n_params(),
            "params_in_tree": tree_numel(p9)}
        batch9 = {"tokens": torch.from_numpy(rs.integers(
            0, cfg9.vocab, (PREFILL_B, PREFILL_T))).to(dev),
            **frames_for(cfg9, PREFILL_B, 3)}
        _, r = time_prefill(arch9, cfg9, p9, batch9, per_call=per_call9)
        r9.update(r)
        r9.update(time_decode(arch9, cfg9, p9,
                              frames_for(cfg9, SERVE_B, 5).get("frames")))
        # prefill against decode at 1 x MOE_AGREE_T tokens: bfloat16 at
        # full depth (reported), float32 on a depth cut (gated)
        agree9 = torch.from_numpy(rs.integers(
            0, cfg9.vocab, (1, MOE_AGREE_T))).to(dev)
        extra9 = frames_for(cfg9, 1, 4)
        r9["agree_bf16"] = list(agreement(
            f"{arch9} bf16, {cfg9.n_layers} layers", p9, cfg9, agree9,
            extra9))
        del p9, batch9
        n_cut = NEW_CUT_LAYERS[arch9]
        cut_cfg9 = cut(cfg9, n_cut)
        _, cut16 = init_full(f"{arch9}, first {n_cut} layers", cut_cfg9,
                             seed=1)
        r9["agree_bf16_cut"] = list(agreement(
            f"{arch9} bf16, {n_cut}-layer cut", cut16, cut_cfg9, agree9,
            extra9))
        cut32 = tree_to(cut16, torch.float32)
        del cut16
        mx, mean, same, n_ = agreement(
            f"{arch9} f32, {n_cut}-layer cut ("
            f"{[cut_cfg9.block_kind(i) for i in range(n_cut)]})", cut32,
            dataclasses.replace(cut_cfg9, dtype="float32"), agree9,
            {k_: v_.float() for k_, v_ in extra9.items()})
        r9["agree_f32_cut"] = [mx, mean, same, n_]
        assert mx <= AGREE_TOL_F32 and same == n_, (arch9, mx, same)
        del cut32
        torch.cuda.empty_cache()
        within = (r9["agree_bf16"][0] <= AGREE_TOL_BF16
                  and r9["agree_bf16"][1] <= AGREE_MEAN_BF16)
        print(f"{arch9} prefill/decode agreement holds: float32 max <= "
              f"{AGREE_TOL_F32}, every greedy token equal; bfloat16 within "
              f"qwen3's {AGREE_TOL_BF16} / {AGREE_MEAN_BF16}: {within} "
              f"(reported, not gated)", flush=True)
    # the scans alone at the models' shapes (CUDA events around one call):
    # the SSD's chunked dual form at mamba2's (4, 2048) tokens, 48 heads
    # of 64, d_state 128, chunk 256; the RG-LRU's log-depth scan at
    # recurrentgemma's (4, 2048, 2560) float32.  ssd_chunked's ~120
    # launches outlast time_ms' spin, so its figure holds host launch
    # gaps too; the traces below read the device time inside the prefill
    m_cfg = get_config("mamba2-780m")
    sc = m_cfg.ssm
    g9 = torch.Generator(device=dev).manual_seed(6)
    x9 = torch.randn(PREFILL_B, PREFILL_T, sc.n_heads, sc.head_dim,
                     device=dev, generator=g9).to(torch.bfloat16)
    dt9 = torch.rand(PREFILL_B, PREFILL_T, sc.n_heads, device=dev,
                     generator=g9) * 0.1
    bc9 = torch.randn(PREFILL_B, PREFILL_T, 2 * sc.d_state, device=dev,
                      generator=g9).to(torch.bfloat16)
    h9 = torch.zeros(sc.n_heads, device=dev)
    ssd_ms = time_ms(lambda: ssm_mod.ssd_chunked(
        x9, dt9, h9, bc9[..., :sc.d_state], bc9[..., sc.d_state:],
        h9 + 1, chunk=sc.chunk), reps=20)
    r_cfg = get_config("recurrentgemma-2b")
    w9 = r_cfg.rglru.lru_width
    a9 = 0.9 + 0.1 * torch.rand(PREFILL_B, PREFILL_T, w9, device=dev,
                                generator=g9)
    b9 = torch.randn(PREFILL_B, PREFILL_T, w9, device=dev, generator=g9)
    scan_ms = time_ms(lambda: rglru_mod.scan(a9, b9), reps=20)
    n_rglru = sum(r_cfg.block_kind(i) == "rglru"
                  for i in range(r_cfg.n_layers))
    serving9["mamba2-780m"]["ssd_chunked_ms"] = ssd_ms
    serving9["recurrentgemma-2b"]["rglru_scan_ms"] = scan_ms
    m_wall, r_wall = (serving9[a_]["prefill_ms"] for a_ in
                      ("mamba2-780m", "recurrentgemma-2b"))
    print(f"ssd_chunked alone (CUDA events around one call, launch gaps "
          f"included) at mamba2's shape ((4, 2048) tokens, "
          f"{sc.n_heads} heads of {sc.head_dim}, d_state {sc.d_state}, chunk "
          f"{sc.chunk}): {ssd_ms:.4f} ms a layer, x {m_cfg.n_layers} layers "
          f"= {ssd_ms * m_cfg.n_layers:.2f} ms, "
          f"{100 * ssd_ms * m_cfg.n_layers / m_wall:.1f}% of the "
          f"{m_wall:.2f} ms prefill call; the RG-LRU scan alone at "
          f"recurrentgemma's (4, 2048, {w9}) float32: {scan_ms:.4f} ms a "
          f"layer, x {n_rglru} layers = {scan_ms * n_rglru:.2f} ms, "
          f"{100 * scan_ms * n_rglru / r_wall:.1f}% of the {r_wall:.2f} ms "
          f"call", flush=True)
    del x9, dt9, bc9, a9, b9
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 10
    phase(10, "the paper benches' path: benchmarks.run --only fig4, the "
              "fig_topology smokes, examples.quickstart")
    out10 = ROOT / "build" / "bench_torch"
    t0 = time.perf_counter()
    b10 = drive_bench_path("cuda", out10)
    wall10 = time.perf_counter() - t0
    bench10 = check_bench_path(b10, name, smi.rsplit(",", 1)[1].strip())
    bench10["wall_s"] = wall10
    f4 = bench10["fig4"]
    print(f"fig4 through benchmarks.run (quick, BENCH_fig4.json on "
          f"{name}, {smi.rsplit(',', 1)[1].strip()}): mean μ_B divergence "
          f"IID {f4['iid_mean_mu_divergence']:.4f}, non-IID "
          f"{f4['noniid_mean_mu_divergence']:.4f} ({f4['ratio']:.2f}x), "
          f"{f4['wall_s']:.2f} s, launches {f4['launches']}")
    for smoke, runs10 in bench10["smokes"].items():
        for r in runs10:
            print(f"{smoke} {r['algo']}: {r['steps']} steps in "
                  f"{r['wall_s']:.3f} s (one evaluation included), "
                  f"launches {r['launches']}, val_acc {r['val_acc']:.4f}, "
                  f"sim_time_s {r['sim_time_s']:.4f}")
    for r, tag in zip(bench10["quickstart"], ("IID", "non-IID")):
        print(f"quickstart {tag}: {r['steps']} Gaia steps in "
              f"{r['wall_s']:.3f} s ({r['steps'] / r['wall_s']:.2f} steps/s, "
              f"3 evaluations included), launches {r['launches']}, val_acc "
              f"{r['val_acc']:.4f}, comm_savings {r['comm_savings']:.4f}x")
    print(f"smoke_scale at 10k nodes: {bench10['smoke_scale_10k']}")
    print(f"phase 10: {wall10:.2f} s")
    print("bench path: " + json.dumps(bench10))
    sys.stdout.flush()

    # deepseek-v2-lite-16b under torch.profiler, after every timing of
    # phases 7 to 9: a prefill call split by kernel kind, and a decode
    # step's launches
    phase(8, "continued: deepseek-v2-lite-16b under torch.profiler")
    with torch.inference_mode():
        busy, n_kern, per_kernel = device_profile(
            lambda: ds_prefill(ds_params, {"tokens": ds_tokens}))
    split = {"flash_attention": 0.0, "gemm": 0.0, "moe_dispatch": 0.0,
             "other": 0.0}
    for k_, v_ in per_kernel.items():
        low = k_.lower()
        if "flash_attention" in low:
            split["flash_attention"] += v_
        elif any(w_ in low for w_ in GEMM_KEYS):
            split["gemm"] += v_
        elif any(w_ in low for w_ in DISPATCH_KEYS):
            split["moe_dispatch"] += v_
        else:
            split["other"] += v_
    ds_wall_ms = serving8["deepseek-v2-lite-16b"]["prefill_ms"]
    serving8["deepseek-v2-lite-16b"].update({
        "prefill_kernels": n_kern, "prefill_busy_ms": busy,
        "prefill_idle": 1 - busy / ds_wall_ms, "prefill_split_ms": split})
    print(f"deepseek-v2-lite-16b prefill call under torch.profiler: {n_kern} "
          f"kernel launches, device busy {busy:.2f} ms of the unprofiled "
          f"{ds_wall_ms:.2f} ms wall "
          f"(idle {100 * (1 - busy / ds_wall_ms):.1f}%): "
          + ", ".join(f"{k_} {v_:.2f} ms ({100 * v_ / busy:.1f}%)"
                      for k_, v_ in split.items())
          + "; top kernels " + json.dumps({k_[:60]: round(v_, 3) for k_, v_
                                           in sorted(per_kernel.items(),
                                                     key=lambda kv: -kv[1])
                                           [:8]}), flush=True)
    d_cache = lm.init_cache(ds_cfg, SERVE_B, SERVE_CACHE, device=dev)
    d_batch = {"token": ds_tokens[:SERVE_B, 0],
               "t": torch.zeros(SERVE_B, dtype=torch.int32, device=dev)}
    with torch.inference_mode():
        busy, n_kern, _ = device_profile(
            lambda: lm.decode_step(ds_params, ds_cfg, d_batch, d_cache))
    step_ms = serving8["deepseek-v2-lite-16b"]["decode_step_ms"]
    serving8["deepseek-v2-lite-16b"].update({
        "decode_launches_per_step": n_kern, "decode_busy_ms": busy,
        "decode_idle": 1 - busy / step_ms})
    print(f"deepseek-v2-lite-16b decode step under torch.profiler: {n_kern} "
          f"kernel launches, device busy {busy:.2f} ms of the unprofiled "
          f"{step_ms:.2f} ms wall a step (idle "
          f"{100 * (1 - busy / step_ms):.1f}%)")
    del ds_params, d_cache
    torch.cuda.empty_cache()
    print("serving (phase 8): " + json.dumps(serving8))
    sys.stdout.flush()

    # phase 9's models, one at a time, each drawn again: one prefill call
    # under torch.profiler, split into GEMMs, flash_attention, the SSD or
    # RG-LRU scan (the kernels launched inside ssd_chunked or scan, marked
    # by a record_function range this script wraps around them) and the
    # elementwise glue
    phase(9, "continued: one prefill call of each model under "
             "torch.profiler")
    scans = ((ssm_mod, "ssd_chunked"), (rglru_mod, "scan"))
    for arch9, per_call9 in NEW_ARCHS.items():
        cfg9 = get_config(arch9)
        p9 = lm.init_model(torch.Generator(device=dev).manual_seed(0), cfg9,
                           dev)
        batch9 = {"tokens": torch.from_numpy(rs.integers(
            0, cfg9.vocab, (PREFILL_B, PREFILL_T))).to(dev),
            **frames_for(cfg9, PREFILL_B, 3)}
        prefill9 = make_prefill_step(cfg9)
        with contextlib.ExitStack() as stack:
            for mod_, fname_ in scans:
                stack.enter_context(swapped(mod_, fname_, marked(
                    getattr(mod_, fname_), fname_)))
            with torch.inference_mode():
                prefill9(p9, batch9)            # warm-up under the marks
                busy, n_kern, per_kernel, in_scan = device_profile(
                    lambda: prefill9(p9, batch9),
                    marks=tuple(f_ for _, f_ in scans))
        split = {"gemm": 0.0, "flash_attention": 0.0, "scan": 0.0,
                 "elementwise": 0.0}
        for k_, v_ in per_kernel.items():
            low = k_.lower()
            if "flash_attention" in low:
                split["flash_attention"] += v_
            elif any(w_ in low for w_ in GEMM_KEYS):
                split["gemm"] += v_
            else:
                split["elementwise"] += v_
        # the scan's kernels, GEMMs (the SSD's batched matmuls) included,
        # move from their kind to the scan
        for k_, v_ in in_scan.items():
            low = k_.lower()
            split["gemm" if any(w_ in low for w_ in GEMM_KEYS)
                  else "elementwise"] -= v_
            split["scan"] += v_
        wall9 = serving9[arch9]["prefill_ms"]
        serving9[arch9].update({
            "prefill_kernels": n_kern, "prefill_busy_ms": busy,
            "prefill_idle": 1 - busy / wall9, "prefill_split_ms": split})
        print(f"{arch9} prefill call under torch.profiler: {n_kern} kernel "
              f"launches, device busy {busy:.2f} ms of the unprofiled "
              f"{wall9:.2f} ms wall (idle {100 * (1 - busy / wall9):.1f}%): "
              + ", ".join(f"{k_} {v_:.2f} ms ({100 * v_ / busy:.1f}%)"
                          for k_, v_ in split.items())
              + "; top kernels " + json.dumps(
                  {k_[:60]: round(v_, 3) for k_, v_ in sorted(
                      per_kernel.items(), key=lambda kv: -kv[1])[:8]}),
              flush=True)
        del p9, batch9, prefill9
        torch.cuda.empty_cache()
    print("serving (phase 9): " + json.dumps(serving9))
    sys.stdout.flush()

    # phase 4's step profiles, traced after every host-bound timing of the
    # script, so that profiling cannot touch one
    phase(4, "continued: one training step of each design under "
             "torch.profiler")
    for (label, algo, kw, state, op_name, per_tensor, kname, ktrace,
         per_launches) in step_runs:
        for side in ("per_tensor", "one_launch"):
            with design(side, op_name, per_tensor):
                before = ops.launches[kname]
                box = [state]
                busy, n_kern, per_kernel = device_profile(
                    lambda: box.__setitem__(0, train_step(algo, box[0], 4,
                                                          kw)))
                state = box[0]
                made = ops.launches[kname] - before
            assert made == (1 if side == "one_launch" else per_launches), \
                (label, side, made)
            prof = profiles[f"{label}/{side}"]
            ours = sum(v_ for k_, v_ in per_kernel.items() if ktrace in k_)
            prof.update({"kernels": n_kern, "busy_ms": busy,
                         "idle": 1 - busy / prof["wall_ms"],
                         f"{kname}_launches": made, f"{kname}_ms": ours})
            print(f"{label} step, {side.replace('_', '-')} design, under "
                  f"torch.profiler: {n_kern} kernels, device busy "
                  f"{busy:.4f} ms of phase 4's {prof['wall_ms']:.4f} ms "
                  f"wall (idle {100 * prof['idle']:.1f}%), {made} {kname} "
                  f"launches taking {ours:.4f} ms; top kernels "
                  + json.dumps({k_[:60]: round(v_, 4) for k_, v_ in sorted(
                      per_kernel.items(), key=lambda kv: -kv[1])[:6]}),
                  flush=True)
    # the bench strategies' steps; DGC top-k's threshold (``quantile_rows``:
    # two kthvalue calls a tensor) marked, to give its share of the step
    for label, (step, state, t_) in bench_runs.items():
        box = [state]
        with swapped(dgc_topk, "quantile_rows",
                     marked(dgc_topk.quantile_rows, "dgc_quantile")):
            busy, n_kern, per_kernel, inside = device_profile(
                lambda: box.__setitem__(0, step(box[0], t_)),
                marks=("dgc_quantile",))
        prof = profiles[label]
        top = {k_[:60]: round(v_, 4) for k_, v_ in sorted(
            per_kernel.items(), key=lambda kv: -kv[1])[:6]}
        prof.update({"kernels": n_kern, "busy_ms": busy,
                     "idle": 1 - busy / prof["wall_ms"], "top": top})
        if label == "dgc-topk":
            q_ms = sum(inside.values())
            kth_ms = sum(v_ for k_, v_ in per_kernel.items()
                         if "kth" in k_.lower())
            prof.update({"threshold_ms": q_ms, "threshold_share": q_ms / busy,
                         "kthvalue_ms": kth_ms, "threshold_kernels": {
                             k_[:60]: round(v_, 4) for k_, v_ in
                             inside.items()}})
            assert q_ms > 0, inside
        print(f"{label} step under torch.profiler: {n_kern} kernels, device "
              f"busy {busy:.4f} ms of phase 4's {prof['wall_ms']:.4f} ms "
              f"wall (idle {100 * prof['idle']:.1f}%)"
              + (f", the threshold (kthvalue) {prof['threshold_ms']:.4f} ms "
                 f"= {100 * prof['threshold_share']:.1f}% of busy, kernels "
                 f"named kthvalue {prof['kthvalue_ms']:.4f} ms"
                 if label == "dgc-topk" else "")
              + "; top kernels " + json.dumps(top), flush=True)
    print("step profiles: " + json.dumps(profiles))
    sys.stdout.flush()

    # --------------------------------------------------------------- 11
    # after every other phase: the full-width training states need the
    # memory that phase 8's model held until its profile
    phase(11, "LM training on the card: qwen3-0.6b at full width under the "
              "six strategies, the attention's autograd route, the "
              "training example, checkpoints")
    train11, kern11 = lm_train_phase(dev, ROOT / "build")
    print("lm training: " + json.dumps(train11))
    sys.stdout.flush()

    # --------------------------------------------------------------- 12
    phase(12, "the pod axis across processes: qwen3-0.6b, one pod a rank, "
              "two gloo ranks on the card and NCCL at world size 1")
    sweep = StandinSweep()
    dist12, kern12 = dist_phase(dev, background=sweep)
    print("pod axis across processes: " + json.dumps(
        {k_: v_ for k_, v_ in dist12.items() if k_ != "standin"}))
    sys.stdout.flush()

    # --------------------------------------------------------------- 13
    phase(13, "the intra-pod axes: qwen3-0.6b over a (pod, data, model) = "
              "(2, 2, 2) mesh of eight gloo ranks on the card")
    intra13, kern13 = intra_phase(dev)
    print("intra-pod axes: " + json.dumps(intra13))
    sys.stdout.flush()

    # --------------------------------------------------------------- 14
    phase(14, "serving under a mesh: qwen3-0.6b over (1, 2, 2) and "
              "deepseek-v2-lite-16b over (1, 1, 4), four gloo ranks on the "
              "card, and NCCL at world size 1")
    serve14, kern14 = serve_mesh_phase(dev)
    print("serving under a mesh: " + json.dumps(serve14))
    sys.stdout.flush()

    # --------------------------------------------------------------- 15
    phase(15, "training MLA + MoE inside a pod, and a model axis wider than "
              "n_kv_heads: deepseek-v2-lite-16b and starcoder2-3b over four "
              "gloo ranks on the card")
    moe15, kern15 = moe_phase(dev)
    print("training MLA + MoE inside a pod: " + json.dumps(moe15))
    sys.stdout.flush()

    # --------------------------------------------------------------- 16
    phase(16, "training and serving the SSM, RG-LRU hybrid, enc-dec and "
              "VLM families inside a pod: four gloo ranks on the card over "
              "(1, 2, 2)")
    fam16, kern16 = families_phase(dev)
    print("the four families inside a pod: " + json.dumps(fam16))
    sys.stdout.flush()

    # --------------------------------------------------------------- 17
    phase(17, "the dry-run stand-in against the card: the reduced audit "
              "sweep (run beside phase 12's ranks), and phase 12's bsp and "
              "dpsgd steps traced on meta against rank 0's run")
    standin17 = standin_phase(sweep, dist12, smi)
    print("the dry-run stand-in: " + json.dumps(standin17))
    sys.stdout.flush()

    kernels = [
        {"name": "gaia_select", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gaia_select.cu",
         "replaces": "src/repro/kernels/gaia_select.py:22",
         "launches": launches["gaia_select"],
         "bench_path_launches": sum(r_["launches"]["gaia_select"]
                                    for r_ in bench10["quickstart"]),
         "max_abs_err": gaia_err,
         "ms": g_ms, "op_ms": g_op, "per_tensor_ms": g_per,
         "plain_ms": g_plain, "bound_ms": g_bound, "bound_by": g_by,
         "library_ms": None},
        # rows 1 and 2 of PERF.md: D-PSGD's leaf-table launch, AD-PSGD's
        # push-and-gather launch; the earlier design's pieces beside them
        {"name": "neighbor_mix", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/neighbor_mix.cu",
         "replaces": "src/repro/kernels/neighbor_mix.py:48",
         "launches": launches["neighbor_mix"],
         "bench_path_launches": sum(
             r_["launches"].get("neighbor_mix", 0)
             for runs_ in bench10["smokes"].values() for r_ in runs_),
         "max_abs_err": gossip_err["neighbor_mix_many"],
         "ms": m_ms, "op_ms": m_op, "plain_ms": m_plain, "bound_ms": m_bound,
         "bound_by": m_by, "library_ms": m_lib,
         "library": "dense W @ X on the flattened leaves",
         "flat_launch_ms": m_flat, "raw_op_ms": m_raw,
         "index_check_ms": m_check, "earlier_design_ms": m_earlier,
         "raw_max_abs_err": mix_err, "empty_launch_ms": mix_floor,
         "copy_ms": m_copy},
        {"name": "neighbor_mix_src", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/neighbor_mix.cu",
         "replaces": "src/repro/kernels/neighbor_mix.py:60",
         "launches": launches["neighbor_mix_src"],
         "bench_path_launches": sum(
             r_["launches"].get("neighbor_mix_src", 0)
             for runs_ in bench10["smokes"].values() for r_ in runs_),
         "max_abs_err": gossip_err["neighbor_mix_push_many"],
         "src_many_max_abs_err": gossip_err["neighbor_mix_src_many"],
         "ms": s_ms, "op_ms": s_op, "plain_ms": s_plain, "bound_ms": s_bound,
         "bound_by": s_by, "library_ms": s_lib,
         "library": "dense W' @ src: the gather alone, not the push",
         "gather_bound_ms": s_mix_bound, "flat_launch_ms": s_flat,
         "push_cat_ms": s_cat, "earlier_design_ms": s_earlier,
         "raw_max_abs_err": src_err, "copy_ms": s_copy},
        {"name": "rand_k_select", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rand_k_select.cu",
         "replaces": "src/repro/kernels/dgc_topk.py:152",
         "launches": launches["rand_k_select"], "max_abs_err": 0.0,
         "ms": r_ms, "op_ms": r_op, "per_tensor_ms": r_per,
         "plain_ms": r_plain, "bound_ms": r_bound, "bound_by": r_by,
         "library_ms": None},
        # rows 4, 5 and 7 of PERF.md: each TPU kernel's work runs on the
        # bench path inside the one dgc_sparsify launch a call
        *({"name": name_, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/dgc_topk.cu",
           "replaces": f"src/repro/kernels/dgc_topk.py:{line_}",
           "launches": bench_launches["dgc_sparsify"],
           "main_path_kernel": "dgc_sparsify", "max_abs_err": 0.0,
           "ms": ms_, "op_ms": op_, "plain_ms": plain_, "bound_ms": bound_,
           "bound_by": by_, "library_ms": lib_,
           "library": None if lib_ is None else
           "torch.histc(|v|, 256, 0, v_max): bin edges computed "
           "differently; yardstick only",
           "sparsify_ms": sp_ms, "sparsify_op_ms": sp_op,
           "sparsify_bound_ms": sp_bound}
          for name_, line_, ms_, op_, plain_, bound_, by_, lib_ in (
              ("abs_histogram", 54, ah_ms, ah_op, ah_plain, ah_bound, ah_by,
               ah_lib),
              ("abs_histogram_fused", 94, hf_ms, hf_op, hf_plain, hf_bound,
               hf_by, hf_lib),
              ("dgc_select", 200, ds_ms, ds_op, ds_plain, ds_bound, ds_by,
               None))),
        {"name": "group_norm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/group_norm.cu",
         "replaces": "src/repro/kernels/group_norm.py:17",
         "launches": bench_launches["group_norm"], "max_abs_err": gn_err,
         **{k_: gn_t[(128, 8, 8, 64)][k_] for k_ in (
             "ms", "op_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "group_route_ms")},
         "shapes": {"x".join(map(str, k_)): v_ for k_, v_ in gn_t.items()}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:25",
         # qwen3's prefill (phase 7), as before; every prefill path summed
         # and by path beside it
         "launches": lm_launches["flash_attention"],
         "launches_all_paths": lm_launches["flash_attention"] + sum(
             r_["flash_attention_launches"] for r_ in
             list(serving8.values()) + list(serving9.values())),
         "launches_by_path": {
             "qwen3-0.6b": lm_launches["flash_attention"],
             **{a_: r_["flash_attention_launches"]
                for a_, r_ in {**serving8, **serving9}.items()}},
         "max_abs_err": fa_prefill_max,
         **{k_: fa["prefill_gqa"][k_] for k_ in (
             "ms", "op_ms", "chunked_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")},
         "mha_ms": fa["prefill"]["ms"],
         "mha_library_ms": fa["prefill"]["library_ms"],
         "pairs": fa["pairs"], "model_shapes": fa["models"],
         "phase9_model_shapes": fa["new_models"]},
    ]
    # phase 11's figures: launches a full-width train step, the attention
    # route's times, Gaia's mixed-dtype instance
    for entry in kernels:
        key = entry.get("main_path_kernel", entry["name"])
        if key in kern11:
            entry["lm_train"] = kern11[key]
        if key in kern12:
            entry["dist_train"] = kern12[key]
        if entry["name"] in kern13:
            entry["intra_train"] = kern13[entry["name"]]
        if entry["name"] in kern14:
            entry["mesh_serve"] = kern14[entry["name"]]
        if entry["name"] in kern15:
            entry["intrapod_moe_train"] = kern15[entry["name"]]
        if entry["name"] in kern16:
            entry["intrapod_families"] = kern16[entry["name"]]
    end_phase()
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the build "
          "included")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
