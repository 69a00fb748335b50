#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; each prints its seconds, and any failure raises and the
script exits non-zero:

1. The card's name and power limit (``nvidia-smi``); TF32 off for float32
   matmuls and convolutions, so the plain versions compute in full f32.
2. Build every CUDA source of the port with nvcc (all at once), timed;
   print ptxas's registers and spills for every kernel instantiation; fail
   if ptxas dropped a `setmaxnreg` (warning C7508) in any of them.
3. Kernel B1 (flash forward) against its plain PyTorch version on the card,
   at the shapes the serving path gives it (Llama-3-8B prefill: B=8,
   S=2048 and S=1024, H=32, KV=8, D=128, causal; a tp=2 shard's: H=16,
   KV=4), and at each mesh phase's shard shape (``MESH_SHARD_CASES``:
   the ring's hops at sp=2, the off-diagonal one with no mask, and a
   pipeline microbatch among them), plus D=64 non-causal,
   D=256, a ragged S (1000, and 1088: 64 rows past a 128-row tile) and q,
   k, v as head slices of one fused tensor (strided views).  Times of the
   kernel, the plain version and one library call
   (``scaled_dot_product_attention``, a yardstick the port never calls)
   with CUDA events, beside the least time the card could take (bound).
4. Kernels B2 (dq) and B3 (dk/dv) against their plain versions on the same
   residuals, at the training path's shape (llama_1b: B=8, S=2048, H=16,
   KV=8, D=128, causal), the serving shape (B=8, S=1024, H=32, KV=8) and
   Mixtral's training shape (B=8, S=2048, H=32, KV=8) and each mesh
   phase's shard shape (timed), plus D=64 non-causal with KV=H, D=256 (GQA reps 4 at S=1088 too), a
   ragged S (1000, and 1088: 64 rows past a 128-row tile; 64, where a q
   tile's upper warpgroup has no row) and strided views (q, k, v as head
   slices of one fused tensor, dO a transposed view); each run twice and
   required to give the same bits.  Times beside the bounds, the plain
   versions' and the backward of ``scaled_dot_product_attention`` (one
   library call for B2 + B3 together).
5. The serving path at full width: ``LLMEngine`` on Llama-3-8B (32 layers,
   hidden 4096, random bf16 weights from seed 0, drawn once and passed to
   every serving engine), 8 concurrent requests, 5 with prompts of
   1100-1900 tokens (bucket 2048, through the flash kernel) and 3 short
   ones (plain attention), 16 tokens each.  Launch counts are zeroed just
   before and read just after.  Then the prefill logits of one batch
   through the kernel against the same prefill through the kernel's plain
   version (not traced, to pay for ``rllib_learner_actors``: the tp=2
   and Mixtral phases trace theirs).  Then ``serve_llama3_8b_deployment``:
   the port's runtime (``ray_tpu_torch.init``, started before phase 2 so
   that its workers import torch while nvcc builds, and waited for
   before phase 3, so that no import overlaps a timed kernel) counts
   the card as a ``GPU`` resource, ``serve.run`` deploys
   ``llm_deployment("llama3-8b")`` on a ``num_gpus=1`` replica (class
   ``serving_replica()``: ``LLMServer`` with readers for this script),
   which draws the same weights on its card, and the same requests are
   sent through the ``DeploymentHandle`` together (they reach the replica
   one stream at a time, ROADMAP C12, so concurrent admission through the
   handle is not covered): its streams equal the
   in-process ones token for token, B1 launches in its prefill,
   ``stats()`` counts the 128 tokens, the replica's generator method
   (the proxies' path) streams the first request's tokens again, ``slo_signal()`` holds a TTFT
   sample, a 256 MB CPU bf16 tensor goes through ``put`` and its
   ``ObjectRef`` through the handle into the replica and onto the card
   with equal checksums, and after ``serve.shutdown()`` and
   ``shutdown()`` the card's free memory is back within 1 GB (the
   ``serve_deployment`` line).  The same requests then go through:
   a. the paged engine (``paged=True, page_size=64``), whose prefill
      attends with f32 einsums over the gathered pages as the JAX
      package's does: no kernel may launch; its prefill logits against the
      dense prefill's (through B1); a paged prefill batch and a paged
      decode dispatch traced;
   b. the paged engine with a shared 1024-token prefix and 32-token tails
      (bench_llm.py's prefix arm), 4 requests and then 4 more: 4 prefix
      hits reusing 1024 tokens each; the suffix prefill's logits against a
      cold prefill's;
   c. the paged engine with speculative decoding (k 4, a 1-layer draft;
      bench_llm.py's paged_spec arm) on weights damped past the first
      block: B1 launches from the draft's prefill counted, no draft error,
      acceptance read, the vanilla paged engine on the same weights beside
      it (streams' agreement read, no limit), the dense and paged verify
      windows' logits against 4 sequential decode steps;
   d. ``serve_llama3_8b_tp2``: ``LLMEngine(tp=2)`` splits the same
      weights, cut to 16 of the 32 layers (``TP_SERVE_LAYERS``), over two
      shards (on cuda:0 and cuda:1 with two cards, else
      both on cuda:0; the placement line says which: the same run is the
      multi-card check on a machine with two cards), the dense phase's
      requests: B1 2 x 16 launches per bucket-2048 batch, one 8 x 2048
      prefill's logits against tp=1's on the same cut (rms limit); then
      the paged engine and the prefix waves on the same shards, as a. and
      b. check them (the paged run not traced);
   e. a 2-layer f32 cut at full width: the spec streams must equal the
      vanilla ones, and the spec engine's pages a fresh prefill's of each
      verified sequence (the rollback invariant); then
      ``serve_f32_tp_exactness``: the same cut's tp=2 streams must equal
      tp=1's, dense and paged, and each shard's K/V tp=1's at its KV heads
      within 1e-4 of the largest magnitude.
   f. ``moe_layer``: ``moe_mlp`` against its one-hot version (the
      reference's einsums, with its own top-k by argmax) at Mixtral-8x7B's
      width in bf16 (H 4096, M 14336, 8 experts, top 2) for one 8 x 2048
      prefill batch, the same with a skewed router (experts overflow) and
      one decode batch of 9 tokens: the same kept (token, choice) pairs in
      the same buffer positions, the output within 2e-2 of the largest
      magnitude, pairs dropped under the skewed router; both timed beside
      the larger of the FLOP and the byte bound; the dropped share.
   g. ``serve_mixtral_8x7b``: the Llama weights freed, Mixtral-8x7B at full
      width cut to 16 of its 32 layers (random bf16 weights, seed 0; 47
      GB) through the dense engine and the same 8 requests: B1 launches
      (16 per bucket-2048 prefill batch), TTFT, decode tok/s, peak memory,
      the dropped shares in prefill and decode, a prefill batch and a
      decode dispatch traced; then the paged engine on the same weights
      (no kernel launch). Then one prefill batch through B1 against B1's
      plain version, and the paged prefill against the dense one, each
      with B1's routing replayed (rms limit): bf16 rounding flips
      near-tied router choices, so runs that route freely (against plain
      attention too) are readings, with the share of tokens routed
      otherwise. No spec or prefix run: with MoE their streams differ
      from vanilla by the reference's own semantics (capacity comes from
      the call's batch).  Then ``serve_mixtral_8x7b_tp2``: 8 layers (the
      weights twice: tp=1's tree and the shards), the dense engine at tp=2
      (B1 2 x 8 launches per long batch), and one 8 x 2048 prefill batch at
      tp=2 against tp=1 with tp=1's routing replayed (rms limit); routed
      freely, a reading, with both runs' dropped shares.
   h. ``train_mixtral_8x7b``: Mixtral-8x7B at full width and 1 layer,
      trained as phase 6 trains llama_1b (B1/B2/B3 2/1/1 a step); the
      loss finite and falling, the MoE aux loss finite and above 0 on
      every step; one step's loss and gradients against the same step
      through the kernels' plain versions, with the kernels' run's routing
      replayed (its weights and aux loss computed from the run's own
      logits), the freely routed plain step a reading; one step
      profiled.
6. The training path at full width: ``make_optimizer`` /
   ``init_sharded_state`` / ``make_train_step`` on llama_1b (16 layers,
   hidden 2048, 16 q / 8 kv heads, vocab 32768; fp32 params and Adam state,
   bf16 compute, remat), 8 steps on one batch of 8 x 2049 tokens from numpy
   seed 0.  Launch counts are zeroed just before and read just after: B1
   twice per layer and step (forward and remat replay), B2 and B3 once.
   Loss finite and falling; one step's loss and gradients through the
   kernels against the same step through the kernels' plain versions; the
   chunked LM-head loss timed alone; one step profiled (torch.profiler).
   The same training runs through the tune and train libraries in
   ``train_llama_1b_tuner`` (after 9 b.): the port's runtime runs
   ``tune.Tuner`` over a ``TorchTrainer`` with one ``num_gpus=1`` worker
   on NCCL, fed by a ``ray_tpu_torch.data`` dataset holding the same batch
   (``iter_torch_batches(device="cuda")``): one trial on a CPU lease runs
   the trainer's ``fit()``, and its worker trains llama_1b uncut for 4
   steps: one TERMINATED trial with the worker's 4 reports (in its
   ``metrics_history``, ``result.json`` and ``progress.csv``), the group
   NCCL of world size 1, each loss within 1e-3 of the in-process step's,
   B1/B2/B3 128/64/64 in the worker (the ``tuner`` line: the trial's and
   the worker's ready times, the worker's median step beside the
   in-process one, the phase's wall time).  Then ``darray_collective``
   on the same runtime: ``experimental.darray.dot`` of two seeded 4096^2
   f32 arrays at its default 512 blocks, 64 ``num_gpus=1`` block tasks,
   within 1e-5 relative L2 of a float64 product, and an int64 ``dot``
   bit for bit to its CPU tasks' and to numpy's int32 wrap;
   ``to_torch()`` and ``to_torch(mesh, PartitionSpec("dp", None))`` on
   the card equal to ``assemble()``; ``util.collective.mesh_collectives``
   on a dp=2, tp=2 mesh of the card, every op and keyword along dp and
   tp, bit for bit to the same calls on CPU parts; a two-rank
   ``CollectiveGroup`` (rank 0 a ``num_gpus=1`` actor passing CUDA
   tensors, rank 1 a CPU actor passing numpy) through barrier,
   allreduce, broadcast, allgather, reducescatter and send / recv,
   against numpy, and its state actor gone after
   ``destroy_collective_group`` (the ``darray_collective`` line: the
   seconds of ``from_numpy``, ``dot`` and ``assemble``, GFLOP/s, one
   block's product in-process, each group op's seconds).  Then
   ``job_submit`` on the
   same runtime: ``ray_tpu_torch.scripts.cli.main(["submit", "--", ...])``
   submits an entrypoint that joins the cluster
   (``init(address="auto")``) and runs B1 once in a ``num_gpus=1`` task
   at Llama-3-8B's attention layout (1, 2048, 32, 8, 128), causal, bf16,
   inputs from a ``torch.Generator`` seeded 0, against its plain version
   (out within 2e-2, lse within 1e-3); the CLI prints ``SUCCEEDED``,
   ``job status`` shows exit code 0, ``job logs`` hold the task's line
   (one launch, this card), ``status`` lists the ``GPU``; then
   ``shutdown()`` and the card's memory back within 1 GB 5 s after it
   (the ``job_submit`` line: submit to ``SUCCEEDED``, the entrypoint's
   ``init``, the task's seconds and its torch import).
7. Kernel B4 (splash: B1-B3's code with the logit softcap, on a q scaled
   by D^-0.5 beforehand) forward, dq and dk/dv against their plain
   versions at the training shape with softcap 0 and 50 (Gemma-2's cap;
   there q is scaled further, so that the scores reach the cap), at D=256
   and non-causal; the backward run twice and required to give
   the same bits.  Times beside bounds that count the special-function
   units too (an exp per kept score, and a tanh with the cap, at 16 per
   clock per SM at the card's maximum SM clock), beside the plain versions'
   and, at softcap 0 only, SDPA's (no library call computes the cap).
8. The training path as ``bench.py``'s splash arm runs it:
   llama_1b with ``attention_impl="splash"`` and ``remat="save_acts"``,
   otherwise as phase 6.  B4's launch counts asserted (the forward twice
   per layer and step: splash's residuals carry no names, so the backward
   replays it; dq and dk/dv once) and B1-B3's at 0; the same checks,
   numbers and profile as phase 6, the step compared against the same
   step through B4's plain versions (the loss within a limit of its own,
   set from the measured noise of this comparison).
9. The mesh train step (``models/sharding.py``, ``init_sharded_state`` /
   ``make_train_step`` over a ``MeshSpec``), one process driving every
   shard; the ``mesh placement`` line says where the shards sit (every
   shard on cuda:0 with one card, one card each with enough cards):
   a. ``train_llama_1b_mesh``: llama_1b as phase 6 trains it, on
      ``fsdp=2, tp=2`` and on ``dp=2, fsdp=2, tp=2``: state from seed 0,
      5 steps, loss finite and falling, B1-B3 launched 2/1/1 times per
      layer, step and shard; the first three losses within STEP_LOSS_ATOL
      of ``mesh=None``'s from the same seed and batch (step 0's learning
      rate is 0, so the third is the first after an update) and the adam
      mu after step 0, put back together, within STEP_GRAD_REL_L2 per
      leaf;
      step ms, tokens/s, state and peak GB per card; one step of
      ``fsdp=2, tp=2`` profiled (``MESH_TRACED``).
   b. ``train_f32_mesh_exactness``: llama_1b's width cut to 2 layers in
      f32 (plain attention) on ``dp=2, fsdp=2, tp=2``, 3 steps against
      ``mesh=None``: loss and grad norm, and every leaf of params, mu and
      nu, within 1e-4 relative; the same for f. below's three runs on a
      4-layer cut and 4 rows (the ring's recurrence under sp; leaves
      merged from the pipeline's stages).  The port's runtime for the
      next phase starts before it and its workers import torch beside
      it (it times no kernel); ``tuner_runtime_warm`` waits for them.
      Then ``train_llama_1b_tuner`` (phase 6's second half), its trial's
      actor and its worker on warm workers.
   c. ``train_mixtral_mesh``: Mixtral's 1-layer cut on ``fsdp=2, ep=2``
      (global routing, experts split over ep): step 0 replays the routing
      of ``mesh=None``'s step and is held to it as in a.; aux loss > 0
      every step; the freely routed steps' dropped share.
   d. ``checkpoint_roundtrip``: the 2-layer cut in f32 on ``fsdp=2,
      tp=2``, 2 steps, ``save_pytree``, ``load_pytree`` onto ``mesh=None``
      and 2 more: the losses equal 4 uninterrupted steps (the resumed
      ones within 1e-6 relative); write and read seconds and bytes.
   e. ``train_llama_1b_dp``: the dp-manual step (``parallel/zero.py``,
      ``parallel/quant_collectives.py``) as bench.py's training arms
      without splash drive it, in its order: ``off`` (the default step),
      ``quant``, ``zero`` and ``quant+zero``, through ``make_train_step``'s
      keywords, on llama_1b at full width and depth over ``dp=2`` (fp32
      state, bf16 compute, full remat; ``OptimizerSpec(total_steps=10)``
      as bench.py builds it).  zero's first three losses within
      STEP_LOSS_ATOL of off's and its params' change over them (from
      init) within STEP_GRAD_REL_L2 per leaf, beside the reading of off's
      change one update short; quant's losses within 5e-3 of off's and
      a 2-step rerun equal bit for bit; quant+zero's within 1e-2; each
      arm's loss finite and falling, B1-B3 2/1/1 per layer, step and
      replica; ZeRO's resident state 2 n 4 (dp - 1) bytes under off's;
      replica 0's flat gradient quantized on the card and on the host
      (equal scales, int8 flips only at half-integers); step ms,
      tokens/s, the bytes each step's collectives name, resident and peak
      GB, one step profiled per arm (the quantize and dequantize spans
      apart); then a 2-layer f32 cut at full width: zero against off over
      4 steps, the loss, every param leaf and the flat moments within
      1e-4.  With both replicas on one card no byte crosses a wire: the
      quantized arms can only cost time here.
   f. ``train_llama_1b_sp_pp``: ring attention alone at llama_1b's
      attention shape (8, 2048, 16, 8, 128) on ``sp=2`` through B1-B3
      against the same call through their plain versions (out within
      2e-2, dq/dk/dv within 2e-2 of the largest magnitude, bitwise
      repeatable) and ``ulysses_attention`` against plain attention; then
      llama_1b uncut (bf16 compute, fp32 state, full remat) through
      ``make_train_step(sp_axis="sp")`` on ``sp=2`` and through
      ``init_pp_state`` / ``make_pp_train_step`` on ``pp=2`` with 4
      microbatches, GPipe and interleaved (V=2), 4 steps each on the
      batch pre-shifted: the first three losses and mu after step 0 held
      to ``mesh=None``'s as in a.; B1/B2/B3 96/48/48 a step on sp=2 (3
      ring hops a layer, forward and replay) and 128/64/64 on pp=2 (each
      layer once per microbatch); one step of each profiled.
10. ``rllib_learners``: RLlib's learners (``ray_tpu_torch/rllib``), each
    built with ``device=None`` and fed rollouts or replay samples made
    from seed 0 at the reference's shapes (the card has no gymnasium, so
    no env steps; f32, TF32 off): PPO on the CartPole gate's MLP (rollout
    [128, 4], 8 epochs x 4 minibatches) and on the Nature CNN ((84, 84, 4)
    uint8 frames, [128, 8], 4 x 4), DQN and Rainbow (51 atoms, dueling,
    PER weights) at batch 128, SAC, TD3 (both ``do_actor``) and DDPG at
    256.  One update on the card against the same update on the CPU from
    the same state, batch and draws: every leaf's rel. L2 and the losses
    within 1e-4; for PPO also GAE and the first minibatch's gradients
    (the Nature CNN's within 1e-3, and its whole update a reading beside
    the CPU's disagreement with itself at half its threads: Adam's sign
    steps on gradients within rounding of zero).  ms per update (median),
    samples/s, the device-busy share of one profiled update and the
    device ms beside the untraced time; the conv policy's runner step on
    8 frames; ``LearnerGroup(num_learners=2)`` with both shards on the
    card within 2e-4 of one.  No kernel of the port runs here.
11. ``rllib_algorithms``: the rest of RLlib (``ray_tpu_torch/rllib``),
    built with ``device=None``, f32 with TF32 off, inputs from seed 0 at
    the reference's shapes: ``ImpalaLearner`` on the CartPole gate's MLP
    ([64, 2] fragments), APPO on the same and the Nature CNN ((84, 84, 4)
    uint8, [64, 8]): one update on the card against the CPU from the same
    state and fragment (V-trace's ``vs`` and ``pg_adv`` within 1e-5 of
    their largest magnitude; the MLP leaves and losses 1e-4; the conv's
    gradients before Adam 1e-3, its update a reading, as in 10.), and
    ``num_devices_per_learner=2`` (both shards on the card) against one
    within 2e-4; BC, MARWIL (beta 1) and CQL from ``learner_only`` on a
    seeded CartPole-shaped corpus of ~6,000 transitions through
    ``write_episodes`` / ``from_jsonl``, one ``train()`` of 10 updates
    (1e-4); Ape-X's ``_td_abs`` (1e-5) and one update on a shard's
    sample of 64 (1e-4); one ES and one ARS driver update (theta 1e-5
    rel. L2) and ``ESPolicy`` on a batch; ``MultiAgentPPO`` on
    RockPaperScissors end to end (three iterations, the third's updates
    against the CPU within 1e-4; its runners CPU actors of the port's
    runtime, started for it); PPO in external mode end to end (a
    numpy simulator with CartPole's shapes in a thread, ``PolicyClient``
    over localhost, three iterations of 256 steps).  ms per update or
    iteration, samples/s, the busy share of one profiled IMPALA update,
    the server's ms per ``get_action``.  No kernel of the port runs here.
12. ``rllib_learner_actors``: RLlib on the port's runtime
    (``init(num_cpus=4)``, the card counted as a ``GPU``):
    ``DistributedLearnerGroup(num_learners=1, device=None)``, whose
    ``LearnerWorker`` actor holds the ``GPU`` lease and forms an NCCL group
    of one, runs PPO's update on the CartPole gate's MLP ([128, 4]) and
    IMPALA's on its [64, 2] fragment, each against the same update of the
    in-process learner on the card from the same seed (every leaf's rel.
    L2 and the losses within 1e-4); the Nature CNN's update ([128, 8] f32
    frames, ~116 MB a rollout) through the actor timed beside the
    in-process one, and the worker's ready time; PPO's external mode with
    ``learners(num_learners=1)`` for three iterations (the policy server's
    weights equal the group's); two ``ReplayShard`` actors against two
    in-process shards (equal samples before and after a priority update).
    After ``shutdown()`` the card's free memory is back within 1 GB in
    5 s.  No kernel of the port runs here.
13. A ``phases`` line: each phase's seconds and the script's total.  A
    JSON line of kernels (each path's launches, the replica's under
    ``serve_deployment``, the tuner's trial's worker's under ``train_tuner``,
    the submitted job's task's under ``job_submit``;
    the mesh paths' under ``train_mesh[...]``, the dp arms' under ``train_dp[...]``, the
    sp and pipeline runs' under ``train_sp_pp[...]``;
    B1-B3 at each mesh's shard shape, checked
    and timed in phases 3 and 4, under ``mesh_shard_shapes``), then the contract line
    ``{"ok": true, "device": {...}}`` as the last line of output.

Exits non-zero without a result when there is no CUDA card, or when the
``ray_tpu_torch`` package is not beside this script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense bf16 tensor-core rate, HBM3 bandwidth)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
# special-function units (exp, tanh): 16 results per clock per SM, 132 SMs
SFU_PER_CLOCK = 16 * 132
SPLASH_SOFTCAP = 50.0   # Gemma-2's attention logit softcap
# with a softcap c, q is scaled further so that the scores' std is c / 4:
# the largest of a row's scores reach about c, where tanh bends and the
# backward's factor (1 - t^2) falls to about a half.  On scores of std 1 a
# kernel that dropped that factor, or the cap, from dq would still land
# inside GRAD_RTOL (at c = 50 both differ from 1 by under 0.4%).
CAP_SCORE_STD = 0.25

OUT_ATOL = 2e-2      # bf16 out: P rounds to bf16 at other tile boundaries
LSE_ATOL = 1e-3      # f32 lse: same terms summed in another order
# bf16 dq/dk/dv of B2/B3 against their plain versions, as a share of the
# plain version's largest magnitude: P and dS round to bf16 at other tile
# boundaries and f32 sums run in another order
GRAD_RTOL = 2e-2
# one llama_1b training step (16 bf16 layers, fp32 params), attention
# through the kernels against attention through their plain versions: the
# loss within this absolute difference, every gradient leaf within this
# relative L2 difference (bf16 rounding of P / dS at other tile boundaries
# reaches every layer's gradient through the residual stream).  The loss, a
# mean over 16k tokens after 8 steps through the kernels, is a forward
# quantity on a shared state: on an H100 it differed by 1.888e-4 with the
# wgmma forward, by 1.29e-4 to 2.34e-4 on four batches, and the plain
# version against itself, rounding P at other tile widths, by up to
# 2.22e-4, so the loss limit is the splash path's, above that noise; a
# wrong kernel moves the loss by orders of magnitude more.  The gradients'
# limit and the kernels' own GRAD_RTOL hold the backward.
STEP_LOSS_ATOL = 1e-3
STEP_GRAD_REL_L2 = 5e-2
# the same comparison on the splash path: B4 and its plain versions on a q
# rounded to bf16 after scaling read |dloss| 2.30e-4 at the first step and
# 2.38e-4 after 8 steps on an H100 (largest leaf rel. L2 2.7e-2, 1.36e-2):
# the bf16 rounding of P at other tile boundaries moves this mean over 16k
# tokens by ~1e-4 (pre-scaling q in bf16 alone moves the first loss by
# 1.05e-4), so 2e-4 sits inside that noise; a wrong kernel moves it by
# orders of magnitude more
SPLASH_STEP_LOSS_ATOL = 1e-3
# prefill logits through 32 bf16 layers, kernel vs plain version, as a
# share of the logits' std: the rms and the largest of 2 x 128256 differences
LOGITS_RMS = 0.05
LOGITS_MAX = 0.25

# the design of every kernel body (flash_attention_fwd.cu,
# flash_attention_bwd.cu, flash_attention_bwd_dkv.cu: wgmma products on
# TMA-loaded tiles, a producer warpgroup and mbarriers)
HOPPER_DESIGN = "wgmma+tma"

TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_STEPS, TRAIN_UNTIMED = 8, 2

LONG_PROMPTS = (1100, 1300, 1500, 1700, 1900)
SHORT_PROMPTS = (40, 50, 60)
MAX_TOKENS = 16
SERVE_MAX_LEN, PAGE_SIZE = 2048, 64
# serve_llama3_8b_tp2 runs Llama-3-8B at full width cut to 16 of its 32
# layers, which keeps this script under half its time limit with the
# deployment phase
TP_SERVE_LAYERS = 16
# the deployment phase: the preset LLMServer builds (Llama-3-8B, as
# ``models.config.PRESETS`` names it) and the engine's keywords; every
# wait's limit (s), so a replica that never schedules fails the run
# instead of hanging it; the card's free memory after shutdown() within
# this many bytes of where it stood before; the CPU bf16 tensor put into
# the replica (256 MB)
SERVE_PRESET = "llama3-8b"
DEPLOY_ENGINE_KW = dict(warmup_buckets=True)
RUNTIME_WAIT_S = 300
RUNTIME_FREE_SLACK = 1 << 30
RUNTIME_PUT_ELEMS = 128 * 1024 * 1024
# train_llama_1b_tuner: the steps the TorchTrainer's worker takes; its
# runtime's shared-memory arena (the dataset's batch is 66 kB;
# darray_collective's operands and product 192 MiB); how long after
# shutdown() the card's memory may take to come back (s)
TRAINER_STEPS = 4
TUNER_RUNTIME_STORE = 512 << 20
# the tuner runtime's CPUs, and so its warm pool: the trial's actor and
# the trainer's worker, then darray_collective's block tasks and rank 0
TUNER_RUNTIME_CPUS = 6
TRAINER_FREE_WAIT_S = 5
# darray_collective: the block product's square f32 operands (seed 0, at
# darray.DEFAULT_BLOCK: 8 x 8 grids of 1 MiB blocks) and its limit against
# a float64 product (a TF32 product fails it); the int64 case (M, K, N):
# one output block over two inner blocks, the second ragged;
# mesh_collectives' f32 part on a dp=2, tp=2 mesh of the card, and the
# ops and keywords it runs along each axis
DARRAY_N = 4096
DARRAY_REL_L2 = 1e-5
DARRAY_INT_SHAPE = (500, 1000, 300)
COLLECTIVE_PART = (1024, 1024)
COLLECTIVE_OPS = (
    ("allreduce", {"op": "sum"}), ("allreduce", {"op": "mean"}),
    ("allreduce", {"op": "max"}), ("allreduce", {"op": "min"}),
    ("allgather", {"tiled": False}), ("allgather", {"tiled": True}),
    ("reducescatter", {"scatter_dimension": 0}),
    ("reducescatter", {"scatter_dimension": 1}),
    ("alltoall", {"split_axis": 0, "concat_axis": 1}),
    ("alltoall", {"split_axis": 1, "concat_axis": 0}),
    ("permute", {"perm": [(0, 1), (1, 0)]}), ("permute", {"perm": [(1, 0)]}),
    ("broadcast", {"root": 0}), ("broadcast", {"root": 1}))
# job_submit: the job's one B1 launch at Llama-3-8B's attention layout
# (B, S, H, KV, D), causal, on this device; how long the CLI waits for the
# job to end (s)
JOB_SHAPE = (1, 2048, 32, 8, 128)
JOB_DEVICE = "cuda"
JOB_TIMEOUT_S = 300
# bench_llm.py's prefix arm: one shared prefix and a short tail of its own
PREFIX_LEN, TAIL_LEN = 1024, 32
# the f32 exactness run: 4 prompts (buckets 512 and 1024), 24 tokens each;
# the spec engine's pages against a fresh prefill, as a share of the
# largest magnitude (a k-token window and a prefill sum the same f32 terms
# in another order)
EXACT_PROMPTS = (300, 500, 700, 900)
EXACT_MAX_TOKENS = 24
SPEC_KV_RTOL = 1e-4
# Mixtral-8x7B at full width (hidden 4096, 32 q / 8 kv heads, MLP 14336, 8
# experts top 2, vocab 32000), cut in depth to fit one 80 GB card.  Serving
# keeps 16 of its 32 layers: 23.5 B params, 47 GB in bf16 (all 32 take 93
# GB).  Training keeps 1: fp32 params, grads and Adam moments take 16
# bytes a parameter, 27.4 GB for 1.71 B params (2 layers: 50.6 GB before
# activations and the update's temporaries).
MIXTRAL_SERVE_LAYERS = 16
MIXTRAL_TRAIN_LAYERS = 1
# the tp=2 serving phase holds the weights twice (the tp=1 reference run's
# tree and the two shards): 8 layers, 23.7 GB a copy (16 would take 94 GB)
MIXTRAL_TP_LAYERS = 8
# moe_mlp against its one-hot version in bf16, as a share of the one-hot
# version's largest magnitude: the same rows through the same products,
# the weighted sum in another order
MOE_OUT_RTOL = 2e-2
# (batch, seq, skewed router) of the MoE layer check: one 8 x 2048 prefill
# batch (16384 tokens, capacity 5120), the same with a skewed router, and a
# decode batch of 8 slots and the scratch slot (9 tokens, capacity 2).  A
# random router spreads 16384 tokens evenly enough that no expert
# overflows; the skewed one scales expert e's router column by
# MOE_ROUTER_SKEW ** ((e - 3.5) / 3.5), so that the later experts overflow
# in both choices (about 11% of the pairs dropped in a simulation on
# normal logits) and the check holds the capacity drops at prefill size.
MOE_CASES = ((8, 2048, False), (8, 2048, True), (9, 1, False))
MOE_ROUTER_SKEW = 4.0
# the mesh train step: llama_1b on these meshes (every shard on cuda:0 with
# one card), the first steps held to mesh=None's; Mixtral's 1-layer cut on
# fsdp x ep (dp would hold its 27.4 GB of state twice); the f32 check and
# the checkpoint round trip on llama_1b's width cut to 2 layers
LLAMA_MESHES = (dict(fsdp=2, tp=2), dict(dp=2, fsdp=2, tp=2))
# the meshes whose step is traced: not the 8-shard mesh, whose trace
# (~30 s) pays for the phase rllib_learner_actors
MESH_TRACED = LLAMA_MESHES[:1]
MIXTRAL_MESH = dict(fsdp=2, ep=2)
# the first three losses against mesh=None's: make_optimizer's warmup
# gives step 0 a learning rate of 0, so the third is the first loss after
# an update that moved the params
MESH_COMPARE_STEPS = 3
# llama_1b's steps on each mesh of LLAMA_MESHES (the median is of steps
# 2-4)
MESH_TRAIN_STEPS = 5
# one shard's attention on those meshes (B, S, H, KV, D, causal, timed,
# strided), checked and timed in the kernel phases: llama_1b on fsdp=2,tp=2
# and on dp=2,fsdp=2,tp=2, Mixtral on fsdp=2,ep=2, one replica's rows of
# llama_1b on the dp=2 mesh of train_llama_1b_dp, a ring hop of llama_1b on
# sp=2 (the diagonal one causal, the off-diagonal one with no mask) and a
# pipeline microbatch of llama_1b at M=4 (train_llama_1b_sp_pp)
MESH_SHARD_CASES = ((4, 2048, 8, 4, 128, True, True, False),
                    (2, 2048, 8, 4, 128, True, True, False),
                    (4, 2048, 32, 8, 128, True, True, False),
                    (4, 2048, 16, 8, 128, True, True, False),
                    (8, 1024, 16, 8, 128, True, True, False),
                    (8, 1024, 16, 8, 128, False, True, False),
                    (2, 2048, 16, 8, 128, True, True, False))
MESH_SHARD_LABELS = ("llama_1b fsdp=2,tp=2", "llama_1b dp=2,fsdp=2,tp=2",
                     "mixtral fsdp=2,ep=2", "llama_1b dp=2",
                     "llama_1b sp=2 diagonal hop",
                     "llama_1b sp=2 off-diagonal hop (no mask)",
                     "llama_1b pp=2 microbatch (M=4)")
MESH_F32_LAYERS, MESH_F32_STEPS, MESH_F32_RTOL = 2, 3, 1e-4
CKPT_LAYERS = 2
# sequence parallelism and the pipeline (ops/ring_attention.py,
# parallel/pipeline.py): llama_1b through make_train_step on sp=2 and
# through make_pp_train_step on pp=2, GPipe and interleaved (V=2), each
# (label, mesh, virtual stages; None for the sp step), M microbatches
SP_PP_RUNS = (("sp=2", dict(sp=2), None), ("pp=2", dict(pp=2), 1),
              ("pp=2,V=2", dict(pp=2), 2))
PP_MICROBATCHES = 4
SP_PP_STEPS = 4
# B1/B2/B3 launches per layer and step, worked out from the code: at sp=2
# the ring runs 3 hops a layer (shard 0 its own block, shard 1 its own and
# shard 0's), forward and full remat's replay; a pipeline stage runs each
# of its layers once per microbatch, forward and replay (every stage
# rematerialises in full)
SP_PP_PER_LAYER = {
    "sp=2": {"flash_attention_fwd": 6, "flash_attention_bwd_dq": 3,
             "flash_attention_bwd_dkv": 3},
    "pp=2": {"flash_attention_fwd": 2 * PP_MICROBATCHES,
             "flash_attention_bwd_dq": PP_MICROBATCHES,
             "flash_attention_bwd_dkv": PP_MICROBATCHES}}
SP_PP_PER_LAYER["pp=2,V=2"] = SP_PP_PER_LAYER["pp=2"]
# the ring alone at llama_1b's attention shape over sp=2
RING_SHAPE = (8, 2048, 16, 8, 128)
# their f32 check (train_f32_mesh_exactness) on llama_1b's width cut to 4
# layers (pp=2 x V=2 needs a multiple of 4) and the batch's first 4 rows
# (one per microbatch)
SP_PP_F32_LAYERS, SP_PP_F32_ROWS = 4, 4
# the dp-manual step (parallel/zero.py): bench.py's training arms without
# splash, in its order, each (name, grad_quant, zero), on dp=2, with the
# steps each arm runs (quant+zero's cut to keep the phase near a minute;
# its step time is then the median of steps 2-3)
DP = 2
DP_ARMS = (("off", False, False), ("quant", True, False),
           ("zero", False, True), ("quant+zero", True, True))
DP_ARM_STEPS = {"off": TRAIN_STEPS, "quant": TRAIN_STEPS,
                "zero": TRAIN_STEPS, "quant+zero": 4}
# against the default step's losses: the reference's own tolerances for
# the quantized arms (tests/test_chipspeed.py)
QUANT_STEP_LOSS_ATOL, QUANT_ZERO_STEP_LOSS_ATOL = 5e-3, 1e-2
QUANT_RERUN_STEPS = 2
# quantization on the card against the host: a flip of one int8 step only
# where x/scale lies this close to a half-integer
HALF_INT_TOL = 1e-6
# ZeRO's resident state after init against the arithmetic (the moments
# the allocator's blocks round)
ZERO_STATE_RTOL = 0.02
DP_F32_LAYERS, DP_F32_STEPS, DP_F32_RTOL = 2, 4, 1e-4
QUANT_RANGES = ("quantize_int8_block", "dequantize_int8_block")
# RLlib's learners (phase rllib_learners): every learner from seed 0, one
# update on the card against the same update on the CPU from the same
# state, batch and draws (f32; TF32 off, as set in main)
RL_SEED = 0
RL_LEAF_RTOL = 1e-4        # every leaf's rel. L2, and each loss relative
RL_CONV_RTOL = 1e-3        # the Nature-CNN learner (cuDNN convolutions)
RL_DP_RTOL = 2e-4          # LearnerGroup(num_learners=2) against 1
RL_TIMED = {"ppo": 5, "off_policy": 20}   # update calls timed (median)
RL_POLICY_BATCH = 8        # frames a runner's policy step takes
# (name, model spec, train config, rollout [T, B]): the reference's
# CartPole gate (2 runners x 2 envs) and an Atari-class Nature CNN
RL_PPO = (
    ("ppo_mlp", dict(obs_dim=4, action_dim=2, hidden=(64, 64)),
     dict(lr=1e-3, num_epochs=8, num_minibatches=4, entropy_coeff=0.01),
     (128, 4)),
    ("ppo_nature_cnn", dict(obs_shape=(84, 84, 4), action_dim=6),
     dict(lr=2.5e-4, num_epochs=4, num_minibatches=4, entropy_coeff=0.01),
     (128, 8)),
)
# The rest of RLlib's algorithms (phase rllib_algorithms), the same way:
# card against CPU from the same state, inputs and draws
RL_VTRACE_TOL = 1e-5       # vs and pg_adv, of the largest magnitude
RL_TD_TOL = 1e-5           # Ape-X's |TD| priorities, likewise
RL_ES_RTOL = 1e-5          # ES / ARS theta, rel. L2
RL_ALGO_TIMED = 5          # calls timed per row (median)
# IMPALA's defaults on the CartPole gate's MLP (tests/test_rllib_impala.py:
# 2 runners x 2 envs x 64 steps, one [64, 2] fragment an update), APPO on
# the same, and the Nature CNN on an Atari-class fragment
RL_IMPALA_CFG = dict(lr=5e-3, gamma=0.99, grad_clip=40.0, vf_loss_coeff=0.5,
                     entropy_coeff=0.01, vtrace_rho_clip=1.0,
                     vtrace_c_clip=1.0, clip_param=0.3)
RL_IMPALA = (
    ("impala_mlp", dict(obs_dim=4, action_dim=2, hidden=(64, 64)), False,
     (64, 2)),
    ("appo_mlp", dict(obs_dim=4, action_dim=2, hidden=(64, 64)), True,
     (64, 2)),
    ("impala_nature_cnn", dict(obs_shape=(84, 84, 4), action_dim=6), False,
     (64, 8)),
)
RL_CORPUS_STEPS = 6000     # CartPole-shaped offline corpus, transitions
RL_OFFLINE_UPDATES = 10    # one train() of the offline learners
RL_APEX_BATCH = 64         # the Ape-X gate's batch (tests/test_rllib_apex.py)
RL_EXTERNAL_T = 256        # PPO's external-mode fragment, 3 iterations
# The learner and replay actors on the runtime (phase rllib_learner_actors)
RL_RUNTIME_STORE = 512 << 20   # the object store: a conv rollout is ~116 MB
RL_RUNTIME_CPUS = 4            # the runtime's CPUs, and its idle pool's size
RL_WARM_HOLD_S = 3.0           # a warm-up task holds its worker this long
RL_SHARD_CAPACITY = 4096       # each ReplayShard's capacity
RL_FREE_WAIT_S = 5             # the card's memory back after shutdown()


def log(msg: str) -> None:
    print(msg, flush=True)


#: each phase's seconds, in order, and the script's start (the ``phases``
#: line at the end)
PHASE_S = {}
T_START = time.perf_counter()


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== phase {name}")
    yield
    PHASE_S[name] = time.perf_counter() - t0
    log(f"== phase {name}: {PHASE_S[name]:.1f} s")


def nvidia_smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def card_line() -> str:
    return nvidia_smi("name,power.limit")


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock as nvidia-smi reports it ("1980 MHz")."""
    return float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound_ms(b, s, h, kv, d, causal):
    """Least time for the work this input needs: q.k and p.v over the
    (q, k) pairs the mask keeps, at the bf16 tensor-core peak, against
    q/k/v read once and out (bf16) + lse (f32) written once, at the HBM
    rate."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * d * pairs
    nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kv * d) + 4 * b * h * s
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sdpa_call(q, k, v, causal, scale=None):
    """One library call computing the same function on the same inputs
    (layout change made outside the timed call)."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True, scale=scale)


def check_flash(dev):
    """Phase 3: the flash kernel against its plain version."""
    import torch
    from ray_tpu_torch.ops import flash_attention as fa

    cases = [  # (B, S, H, KV, D, causal, timed, strided)
        (8, 2048, 32, 8, 128, True, True, False),   # bucket-2048 prefill
        (8, 1024, 32, 8, 128, True, True, False),   # bucket-1024 prefill
        # a tp=2 shard's prefill (Llama's and Mixtral's 32 q / 8 KV heads
        # over two shards)
        (8, 2048, 16, 4, 128, True, True, False),
        (8, 1024, 16, 4, 128, True, False, False),
        (8, 2048, 16, 8, 128, True, True, False),   # llama_1b training batch
        *MESH_SHARD_CASES,
        (2, 1024, 16, 4, 64, False, False, False),
        (2, 1000, 32, 8, 128, True, False, False),  # ragged edge
        (2, 1088, 32, 8, 128, True, False, False),  # 64 past a 128-row tile
        (1, 1024, 8, 2, 256, True, False, False),
        # q, k, v as head slices of one fused [B, S, H + 2 KV, D] tensor
        (2, 1088, 32, 8, 128, True, False, True),
    ]
    gen = torch.Generator(device=dev).manual_seed(0)
    results = []
    for b, s, h, kv, d, causal, timed, strided in cases:
        if strided:
            qkv = torch.randn((b, s, h + 2 * kv, d), generator=gen,
                              device=dev, dtype=torch.bfloat16)
            q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
        else:
            q = torch.randn((b, s, h, d), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            k = torch.randn((b, s, kv, d), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            v = torch.randn((b, s, kv, d), generator=gen, device=dev,
                            dtype=torch.bfloat16)
        out, lse = fa._flash_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal)
        err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        bound, bound_by = attention_bound_ms(b, s, h, kv, d, causal)
        row = {"shape": [b, s, h, kv, d], "causal": causal,
               "strided": strided, "max_abs_err": err,
               "lse_max_abs_err": lse_err, "bound_ms": bound,
               "bound_by": bound_by}
        if timed:
            row["ms"] = time_ms(lambda: fa._flash_fwd(q, k, v, causal), 10)
            row["plain_ms"] = time_ms(
                lambda: fa.flash_attention_reference(q, k, v, causal), 3, 1)
            row["library_ms"] = time_ms(sdpa_call(q, k, v, causal), 10)
        log("flash_attention_fwd " + json.dumps(row))
        if not (err <= OUT_ATOL and lse_err <= LSE_ATOL):
            raise AssertionError(
                f"flash kernel disagrees with its plain version at "
                f"{row['shape']} causal={causal} strided={strided}: out {err}"
                f" (atol {OUT_ATOL}), lse {lse_err} (atol {LSE_ATOL})")
        results.append(row)
        del q, k, v, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    return results


def attention_bwd_bounds_ms(b, s, h, kv, d, causal):
    """Least times of B2 and B3 for the work this input needs: B2 does
    S = Q.K^T, dP = dO.V^T and dS.K (6 operations per (q, k) pair and
    head dim), B3 S^T, dP^T, P^T.dO and dS^T.Q (8), at the bf16
    tensor-core peak; against q, k, v, dO (bf16) and lse, Delta (f32) read
    once and dq (B2) or dk, dv (B3) written once, at the HBM rate."""
    pairs = s * (s + 1) // 2 if causal else s * s
    q_bytes, kv_bytes, stat_bytes = 2 * b * s * h * d, 2 * b * s * kv * d, \
        4 * b * h * s
    reads = 2 * q_bytes + 2 * kv_bytes + 2 * stat_bytes
    out = {}
    for name, ops, writes in (("dq", 6, q_bytes), ("dkv", 8, 2 * kv_bytes)):
        t_ops = ops * b * h * d * pairs / PEAK_BF16_FLOPS * 1e3
        t_bytes = (reads + writes) / PEAK_BYTES_S * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def sdpa_bwd_call(q, k, v, dout, causal, scale=None):
    """The backward of one library call computing the same function
    (``scaled_dot_product_attention`` with GQA), after an untimed forward:
    dq, dk and dv together, so a yardstick for B2 + B3."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                       enable_gqa=True, scale=scale)
    g = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(o, (qt, kt, vt), g,
                                       retain_graph=True)


def check_flash_bwd(dev):
    """Phase 4: B2 and B3 against their plain versions."""
    import torch
    from ray_tpu_torch.ops import flash_attention as fa

    cases = [  # (B, S, H, KV, D, causal, timed, strided)
        (8, 2048, 16, 8, 128, True, True, False),    # llama_1b training batch
        (8, 1024, 32, 8, 128, True, True, False),    # serving shape, reps 4
        (8, 2048, 32, 8, 128, True, False, False),   # Mixtral training batch
        *MESH_SHARD_CASES,
        (2, 1024, 16, 16, 64, False, False, False),
        (1, 1024, 8, 2, 256, True, False, False),
        (2, 1000, 32, 8, 128, True, False, False),   # ragged edge
        (2, 1088, 32, 8, 128, True, False, False),   # 64 past a kv tile
        # q, k, v as head slices of one fused [B, S, H + 2 KV, D] tensor,
        # dO a transposed view of a [B, H, S, D] tensor
        (2, 1088, 32, 8, 128, True, False, True),
        # dq's edges: a q tile whose upper warpgroup has no live row; GQA
        # reps 4 at D=256 past a 1024-row boundary
        (2, 64, 8, 2, 128, True, False, False),
        (1, 1088, 16, 4, 256, True, False, False),
    ]
    gen = torch.Generator(device=dev).manual_seed(1)
    results = []
    for b, s, h, kv, d, causal, timed, strided in cases:
        if strided:
            qkv = torch.randn((b, s, h + 2 * kv, d), generator=gen,
                              device=dev, dtype=torch.bfloat16)
            q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
            dout = torch.randn((b, h, s, d), generator=gen, device=dev,
                               dtype=torch.bfloat16).transpose(1, 2)
        else:
            q, k, v, dout = (torch.randn(shape, generator=gen, device=dev,
                                         dtype=torch.bfloat16)
                             for shape in ((b, s, h, d), (b, s, kv, d),
                                           (b, s, kv, d), (b, s, h, d)))
        out, lse = fa._flash_fwd(q, k, v, causal)
        delta = fa._delta(out, dout)

        def kernels():
            return (fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta,
                                              causal),
                    *fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                                causal))

        got = kernels()
        again = kernels()
        torch.cuda.synchronize()
        same_bits = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        args = fa._bwd_reference_args(q, k, v, dout, lse, delta, causal)
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                                causal)
        bounds = attention_bwd_bounds_ms(b, s, h, kv, d, causal)
        row = {"shape": [b, s, h, kv, d], "causal": causal,
               "strided": strided, "bitwise_repeatable": same_bits}
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            diff = (a.float() - w.float()).abs().max().item()
            row[f"{name}_max_abs_err"] = diff
            row[f"{name}_rel_err"] = diff / w.float().abs().max().item()
            row[f"{name}_finite"] = bool(torch.isfinite(a).all())
        row["dkv_max_abs_err"] = max(row["dk_max_abs_err"],
                                     row["dv_max_abs_err"])
        for name in ("dq", "dkv"):
            row[f"{name}_bound_ms"], row[f"{name}_bound_by"] = bounds[name]
        if timed:
            row["dq_ms"] = time_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, dout, lse, delta, causal), 10)
            row["dkv_ms"] = time_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, dout, lse, delta, causal), 10)
            row["delta_ms"] = time_ms(lambda: fa._delta(out, dout), 10)
            row["dq_plain_ms"] = time_ms(
                lambda: fa._bwd_dq_reference(*args), 3, 1)
            row["dkv_plain_ms"] = time_ms(
                lambda: fa._bwd_dkv_reference(*args), 3, 1)
            row["sdpa_bwd_ms"] = time_ms(
                sdpa_bwd_call(q, k, v, dout, causal), 10)
        log("flash_attention_bwd " + json.dumps(row))
        bad = [n for n in ("dq", "dk", "dv")
               if not (row[f"{n}_finite"] and row[f"{n}_rel_err"] <= GRAD_RTOL)]
        if bad or not same_bits:
            raise AssertionError(
                f"backward kernels at {row['shape']} causal={causal} "
                f"strided={strided}: "
                f"{bad} exceed {GRAD_RTOL} of the plain version's largest "
                f"magnitude (or are not finite); bitwise repeatable: "
                f"{same_bits}")
        results.append(row)
        del q, k, v, dout, out, lse, delta, got, again, want, args
    torch.cuda.empty_cache()
    return results


def splash_bounds_ms(b, s, h, kv, d, causal, softcap, clock_hz):
    """B4's least times (forward, dq, dk/dv): flash's tensor-core and HBM
    terms, and the special-function units' term: an exp per kept (q, k)
    score and head, and a tanh with the softcap, at 16 per clock per SM.
    -> {pass: (ms, bound_by, {term: ms})}"""
    pairs = s * (s + 1) // 2 if causal else s * s
    special_ms = ((2 if softcap else 1) * b * h * pairs
                  / (SFU_PER_CLOCK * clock_hz) * 1e3)
    fwd = attention_bound_ms(b, s, h, kv, d, causal)
    bwd = attention_bwd_bounds_ms(b, s, h, kv, d, causal)
    out = {}
    for name, (ms, by) in (("fwd", fwd), ("dq", bwd["dq"]),
                           ("dkv", bwd["dkv"])):
        terms = {"tensor_cores" if by == "operations" else "hbm": ms,
                 "special_functions": special_ms}
        out[name] = ((special_ms, "operations") if special_ms > ms
                     else (ms, by)) + (terms,)
    return out


def check_splash(dev, clock_hz):
    """Phase 7: kernel B4 (forward, dq, dk/dv) against its plain versions
    on a q scaled by D^-0.5 in bf16, as ``splash_mha`` scales it, and with
    a softcap c by c · CAP_SCORE_STD besides."""
    import torch
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import splash_attention as sa

    cases = [  # (B, S, H, KV, D, causal, softcap, timed)
        (8, 2048, 16, 8, 128, True, 0.0, True),    # llama_1b training batch
        (8, 2048, 16, 8, 128, True, SPLASH_SOFTCAP, True),
        (1, 1024, 8, 2, 256, True, SPLASH_SOFTCAP, False),
        (2, 1024, 16, 16, 128, False, SPLASH_SOFTCAP, False),
        (2, 1024, 16, 8, 128, False, 0.0, False),
    ]
    gen = torch.Generator(device=dev).manual_seed(3)
    results = []
    for b, s, h, kv, d, causal, cap, timed in cases:
        q, k, v, dout = (torch.randn(shape, generator=gen, device=dev,
                                     dtype=torch.bfloat16)
                         for shape in ((b, s, h, d), (b, s, kv, d),
                                       (b, s, kv, d), (b, s, h, d)))
        qs = q * (d ** -0.5 * (cap * CAP_SCORE_STD if cap else 1.0))
        blk = sa._pick_block(s, sa.DEFAULT_BLOCK)
        out, lse = sa._splash_fwd(qs, k, v, causal, cap, blk, blk)
        delta = fa._delta(out, dout)

        def kernels():
            return (sa.splash_attention_bwd_dq(qs, k, v, dout, lse, delta,
                                               causal, cap),
                    *sa.splash_attention_bwd_dkv(qs, k, v, dout, lse, delta,
                                                 causal, cap))

        got = kernels()
        again = kernels()
        torch.cuda.synchronize()
        same_bits = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        ref_out, ref_lse = fa.flash_attention_reference(qs, k, v, causal, blk,
                                                        blk, cap, 1.0)
        want = fa.flash_attention_bwd_reference(qs, k, v, out, lse, dout,
                                                causal, blk, blk, cap, 1.0)
        row = {"shape": [b, s, h, kv, d], "causal": causal, "softcap": cap,
               "max_abs_err": (out.float() - ref_out.float()).abs().max()
               .item(),
               "lse_max_abs_err": (lse - ref_lse).abs().max().item(),
               "bitwise_repeatable": same_bits}
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            diff = (a.float() - w.float()).abs().max().item()
            row[f"{name}_max_abs_err"] = diff
            row[f"{name}_rel_err"] = diff / w.float().abs().max().item()
            row[f"{name}_finite"] = bool(torch.isfinite(a).all())
        bounds = splash_bounds_ms(b, s, h, kv, d, causal, cap, clock_hz)
        for name, (ms, by, terms) in bounds.items():
            row[f"{name}_bound_ms"], row[f"{name}_bound_by"] = ms, by
            row[f"{name}_bound_terms_ms"] = terms
        if timed:
            args = fa._bwd_reference_args(qs, k, v, dout, lse, delta, causal,
                                          blk, blk, cap, 1.0)
            row["fwd_ms"] = time_ms(
                lambda: sa._splash_fwd(qs, k, v, causal, cap, blk, blk), 10)
            row["dq_ms"] = time_ms(lambda: sa.splash_attention_bwd_dq(
                qs, k, v, dout, lse, delta, causal, cap), 10)
            row["dkv_ms"] = time_ms(lambda: sa.splash_attention_bwd_dkv(
                qs, k, v, dout, lse, delta, causal, cap), 10)
            row["fwd_plain_ms"] = time_ms(lambda: fa.flash_attention_reference(
                qs, k, v, causal, blk, blk, cap, 1.0), 3, 1)
            row["dq_plain_ms"] = time_ms(
                lambda: fa._bwd_dq_reference(*args), 3, 1)
            row["dkv_plain_ms"] = time_ms(
                lambda: fa._bwd_dkv_reference(*args), 3, 1)
            # no library call computes the softcapped function
            row["sdpa_fwd_ms"] = None if cap else time_ms(
                sdpa_call(qs, k, v, causal, scale=1.0), 10)
            row["sdpa_bwd_ms"] = None if cap else time_ms(
                sdpa_bwd_call(qs, k, v, dout, causal, scale=1.0), 10)
        log("splash_attention " + json.dumps(row))
        bad = [n for n in ("dq", "dk", "dv")
               if not (row[f"{n}_finite"] and row[f"{n}_rel_err"] <= GRAD_RTOL)]
        if (bad or not same_bits or row["max_abs_err"] > OUT_ATOL
                or row["lse_max_abs_err"] > LSE_ATOL):
            raise AssertionError(
                f"splash kernel at {row['shape']} causal={causal} softcap="
                f"{cap}: out {row['max_abs_err']} (atol {OUT_ATOL}), lse "
                f"{row['lse_max_abs_err']} (atol {LSE_ATOL}), {bad} exceed "
                f"{GRAD_RTOL} of the plain version's largest magnitude (or "
                f"are not finite); bitwise repeatable: {same_bits}")
        results.append(row)
        del q, k, v, dout, qs, out, lse, delta, got, again, want
    torch.cuda.empty_cache()
    return results


@contextlib.contextmanager
def patched(module, name: str, fn):
    """Route ``module.name`` (an attention entry point) through ``fn`` for
    one comparison run, then restore it."""
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, real)


def sync_cards():
    """Wait for every card (a tp engine's shards may run on several)."""
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def cards(devices=None):
    """The card indices of ``devices`` (None: the current card)."""
    import torch
    if devices is None:
        return [torch.cuda.current_device()]
    return sorted({torch.device(d).index for d in devices})


def reset_peaks(devices=None):
    import torch
    sync_cards()
    for i in cards(devices):
        torch.cuda.reset_peak_memory_stats(i)


def peak_gb(devices=None):
    """The largest peak of allocated memory on the cards since
    ``reset_peaks``, GB."""
    import torch
    return max(torch.cuda.max_memory_allocated(i) for i in cards(devices)) / 1e9


def peaks_by_card(devices, base=None):
    """Each card's peak of allocated memory since ``reset_peaks``, GB,
    less ``base`` (bytes by card index: what the card held before the
    run, such as the reference's compared trees)."""
    import torch
    base = base or {}
    return {f"cuda:{i}": (torch.cuda.max_memory_allocated(i)
                          - base.get(i, 0)) / 1e9 for i in cards(devices)}


def allocated(devices):
    """Bytes allocated on each card of ``devices``, by card index."""
    import torch
    return {i: torch.cuda.memory_allocated(i) for i in cards(devices)}


def tp_placement():
    """The tp phases' shard devices: cuda:0 and cuda:1 with two cards or
    more, else cuda:0 twice (both shards on one card, one after the other:
    their times are one card's, not a two-card speed)."""
    import torch
    two = torch.cuda.device_count() >= 2
    devices = [torch.device("cuda", 0), torch.device("cuda", 1 if two else 0)]
    log(f"tp placement: shards on {[str(d) for d in devices]} ("
        + ("one card each)" if two else "both on one card: times are one "
           "card running both shards, not a two-card speed)"))
    return devices


def engine_kw(devices=None):
    """LLMEngine's placement: the current card (None), or one tp shard on
    each of ``devices``."""
    if devices is None:
        return dict(device="cuda")
    return dict(device=list(devices), tp=len(devices))


def on_shards(cache, devices=None):
    """A cache made on the first card, split over the tp shards on
    ``devices`` as the engine splits its own (None: as it is)."""
    if devices is None:
        return cache
    from ray_tpu_torch.models.convert import tp_split
    return tp_split(cache, len(devices),
                    lambda t, i: t.to(devices[i], copy=True))


def serving_params(name, cfg, dev):
    """A model's random bf16 weights, drawn once from seed 0 as
    ``LLMEngine`` draws them, and passed to every serving engine."""
    import torch
    from ray_tpu_torch.models import transformer

    t0 = time.perf_counter()
    params = transformer.init_params(
        torch.Generator(device=dev).manual_seed(0), cfg, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"{name} params (random bf16 weights, {cfg.num_params() / 1e9:.2f}"
        f" B params): {time.perf_counter() - t0:.1f} s")
    return params


def serving_prompts(cfg):
    """The serving phases' 8 prompts (numpy seed 0): 5 long, 3 short."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab_size, n).tolist()
            for n in LONG_PROMPTS + SHORT_PROMPTS]


def warm(eng, cfg, lengths):
    """First use of each bucket (cuBLAS heuristics, allocator growth) on
    tokens of their own (numpy seed 99: no prefix-cache hit for the
    measured prompts), outside the measured run."""
    import numpy as np
    rng = np.random.default_rng(99)
    for n in lengths:
        eng.generate(rng.integers(1, cfg.vocab_size, n).tolist(),
                     max_tokens=2)


def collect(req):
    """One request's streamed tokens; an error in the engine raises."""
    toks = []
    while True:
        item = req.out.get(timeout=600)
        if isinstance(item, BaseException):
            raise item
        if not isinstance(item, int):
            return toks
        toks.append(item)


def run_requests(eng, cfg, prompts, max_tokens=MAX_TOKENS):
    """Submit every prompt at once, collect every stream, check lengths and
    vocabulary.  -> (outs, reqs, stats: TTFT per request from the common
    submit time, decode tokens/s after the first token, wall)."""
    t_submit = time.monotonic()
    reqs = [eng.submit(p, max_tokens=max_tokens) for p in prompts]
    outs = [collect(r) for r in reqs]
    t_done = time.monotonic()
    for p, toks in zip(prompts, outs):
        if len(toks) != max_tokens or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"prompt of {len(p)} tokens returned "
                                 f"{len(toks)} tokens: {toks}")
    ttft = sorted((r.first_token_at - t_submit) * 1e3 for r in reqs)
    first = min(r.first_token_at for r in reqs)
    return outs, reqs, {
        "requests": len(reqs), "tokens_out": sum(map(len, outs)),
        "ttft_ms": ttft, "ttft_ms_p50": ttft[len(ttft) // 2],
        "decode_tok_s": sum(len(t) - 1 for t in outs) / (t_done - first),
        "wall_s": t_done - t_submit}


def long_batches_since(eng, before):
    """Admit batches at buckets >= 1024 (of whole prompts) since
    ``before``, a copy of ``eng.admit_batches_by_bucket``."""
    return sum(n - before.get(bk, 0)
               for bk, n in eng.admit_batches_by_bucket.items() if bk >= 1024)


def serve_llama(dev, cfg, params):
    """Phase 5: the serving path at full width."""
    import torch
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.serve.llm import LLMEngine

    eng = LLMEngine(cfg, params, device="cuda", num_slots=8, max_len=2048)
    prompts = serving_prompts(cfg)
    try:
        warm(eng, cfg, (LONG_PROMPTS[0], SHORT_PROMPTS[0]))
        batches_before = dict(eng.admit_batches_by_bucket)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        outs, reqs, stats = run_requests(eng, cfg, prompts)
        launches = flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        long_batches = long_batches_since(eng, batches_before)
    finally:
        eng.shutdown()

    if long_batches < 1 or launches < cfg.num_layers * long_batches:
        raise AssertionError(
            f"flash kernel launched {launches} times for {long_batches} "
            f"prefill batches at bucket >= 1024 ({cfg.num_layers} layers)")
    stats.update(long_prefill_batches=long_batches, flash_launches=launches,
                 peak_mem_gb=peak / 1e9)
    log("serve " + json.dumps(stats))
    check_prefill_logits(eng, cfg, prompts, dev)
    return stats, launches, outs


def serving_replica():
    """-> the replica class of phase ``serve_llama3_8b_deployment``:
    ``LLMServer`` (its ``__init__``, ``__call__``, ``stats`` and
    ``prefix_digest`` unchanged) with two readers for this script: B1's
    launch count and the engine's admit batches, and a tensor's checksums
    on the replica's card.  Made in a function, so that cloudpickle ships
    the class by value."""
    from ray_tpu_torch.serve.llm import LLMServer

    class ServingReplica(LLMServer):
        def launches(self, reset=False):
            """B1's launches in this process and the engine's admit
            batches by bucket, the card's name and the peak memory since
            the last reset; ``reset`` then zeroes the count and the
            peak."""
            import torch
            from ray_tpu_torch.ops.flash_attention import flash_attention
            torch.cuda.synchronize()
            got = {"flash_launches": flash_attention.launches,
                   "admit_batches_by_bucket": dict(
                       self.engine.admit_batches_by_bucket),
                   "device": torch.cuda.get_device_name(),
                   "allocated_gb": torch.cuda.memory_allocated() / 1e9,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            if reset:
                torch.cuda.reset_peak_memory_stats()
                flash_attention.launches = 0
            return got

        async def checksums(self, ref):
            """The object ``ref`` names (an ``ObjectRef``: the handle
            passes it through unresolved) onto the card, and
            ``tensor_checksums`` there."""
            import asyncio

            import torch
            import ray_tpu_torch
            t = await asyncio.wrap_future(ray_tpu_torch.as_future(ref))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = t.to("cuda")
            torch.cuda.synchronize()
            copy_s = time.perf_counter() - t0
            return {"device": str(x.device), "dtype": str(x.dtype),
                    "numel": x.numel(), "sums": tensor_checksums(x),
                    "host_to_card_s": copy_s}

    return ServingReplica


def tensor_checksums(x):
    """Two exact integer checksums of a bf16 tensor's bits, on its device:
    their sum, and their sum weighted by position mod 251 (a permutation
    moves it)."""
    import torch
    bits = x.reshape(-1).view(torch.int16).to(torch.int64)
    weights = torch.arange(bits.numel(), device=x.device) % 251
    return [int(bits.sum().item()), int((bits * weights).sum().item())]


def wait_free_memory(want, timeout):
    """Poll the card's free memory until it is at least ``want`` bytes,
    up to ``timeout`` s; -> the last reading."""
    import torch
    deadline = time.monotonic() + timeout
    while True:
        free, _ = torch.cuda.mem_get_info()
        if free >= want or time.monotonic() > deadline:
            return free
        time.sleep(0.5)


def stream_together(handle, prompts, timeout_s):
    """Every prompt's stream sent through the deployment handle together,
    one thread each, each ``stream`` bounded by ``timeout_s``: -> (streams,
    stats as ``run_requests`` gives them: TTFT per request from the common
    start, at this end of the handle, and decode tokens/s after the first
    token; and each request's first chunk to its last).  They are not
    served together: the runtime sends a process's calls to one actor in
    batches, each after the previous batch's reply (ROADMAP C12), so the
    later streams reach the replica when the first one ends, and each
    stream's chunks arrive together at its end.  Concurrent admission
    through the handle is not exercised until C12 is decided."""
    import threading

    outs = [[] for _ in prompts]
    firsts, lasts = [None] * len(prompts), [None] * len(prompts)
    errors = []

    def one(i):
        try:
            for tok in handle.stream({"tokens": prompts[i],
                                      "max_tokens": MAX_TOKENS},
                                     timeout_s=timeout_s):
                lasts[i] = time.monotonic()
                if firsts[i] is None:
                    firsts[i] = lasts[i]
                outs[i].append(tok)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(prompts))]
    t_start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout_s + 30)
    t_done = time.monotonic()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"streams failed or hung: {errors}")
    ttft = sorted((f - t_start) * 1e3 for f in firsts)
    return outs, {
        "requests": len(prompts), "tokens_out": sum(map(len, outs)),
        "ttft_ms": ttft, "ttft_ms_p50": ttft[len(ttft) // 2],
        # per request in the prompts' order: its first chunk to its last
        "first_to_last_ms": [(b - a) * 1e3 for a, b in zip(firsts, lasts)],
        "decode_tok_s": sum(len(t) - 1 for t in outs) / (t_done
                                                          - min(firsts)),
        "wall_s": t_done - t_start}


def start_serve_runtime():
    """The port's runtime for phase ``serve_llama3_8b_deployment``, started
    ahead of it with its pool warmed in the background (``rl_warm``: a
    worker process spends 7-13 s importing torch on an H100's machine),
    so that the kernels' build covers the imports (``rl_warm_wait`` ends
    them before the first timed kernel) and the replica takes a warm
    worker; -> (the session's directory, the seconds ``init`` took)."""
    import ray_tpu_torch
    t0 = time.perf_counter()
    session_dir = ray_tpu_torch.init(num_cpus=RL_RUNTIME_CPUS)["session_dir"]
    init_s = time.perf_counter() - t0
    rl_warm(RL_RUNTIME_CPUS)
    return session_dir, init_s


def serve_llama_deployment(dev, cfg, prompts, in_stats, in_outs, runtime):
    """Phase serve_llama3_8b_deployment: the port's serve library on the
    card, on the runtime ``start_serve_runtime`` started (``runtime``: its
    session, ``init`` seconds and the warm-up's import seconds, its pool
    warmed before the kernel phases).  ``init`` counts the card as a
    ``GPU`` resource and puts its session under the temporary directory
    (``TMPDIR``).
    ``serve.run`` deploys ``llm_deployment(SERVE_PRESET)`` (8 slots,
    ``max_len`` 2048, weights drawn on the replica's card from seed 0: the
    in-process phase's Llama-3-8B, a second 16 GB copy) on a
    ``num_gpus=1`` lease, with ``serving_replica()`` as its class, and
    waits until it is HEALTHY.  The dense phase's 8 requests go through
    the ``DeploymentHandle`` together: the same streams as the in-process
    engine (``in_outs``), B1 at least ``num_layers`` times per long
    prefill batch inside the replica; ``stats()`` through the handle with
    ``LLMServer``'s keys, its ``tokens_out`` 128 more than before the
    requests; the first prompt again through the replica's streaming
    generator method (the proxies' path), the same tokens;
    ``serve.slo_signal()`` with every request's TTFT; a 256 MB CPU bf16
    tensor through ``put``, its ``ObjectRef`` through the handle into the
    replica and onto its card, checksums equal to the host's; the
    runtime's ``GPU`` held by the replica's lease while it serves.  Then
    ``serve.shutdown()`` and ``shutdown()``: the card's free memory back
    within 1 GB of where it stood.  Every wait has a timeout."""
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import llm_deployment

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    free_before, _ = torch.cuda.mem_get_info()
    t_phase = time.perf_counter()
    session_dir, init_s, warm_s = runtime
    try:
        gpus = ray_tpu_torch.cluster_resources().get("GPU")
        if gpus != torch.cuda.device_count():
            raise AssertionError(f"the runtime counts {gpus} GPUs, torch "
                                 f"{torch.cuda.device_count()}")
        dep = llm_deployment(
            SERVE_PRESET, num_slots=8, max_len=SERVE_MAX_LEN,
            engine_kwargs=dict(DEPLOY_ENGINE_KW),
            ray_actor_options={"num_gpus": 1},
            health_check_timeout_s=RUNTIME_WAIT_S)
        dep = dataclasses.replace(dep, func_or_class=serving_replica())
        t0 = time.perf_counter()
        handle = serve.run(dep, timeout_s=RUNTIME_WAIT_S)
        healthy_s = time.perf_counter() - t0
        # the replica's lease holds the card while it serves
        gpus_leased = gpus - ray_tpu_torch.available_resources().get("GPU", 0)
        ready = handle.launches.remote(True).result(timeout_s=RUNTIME_WAIT_S)
        stats_before = handle.stats.remote().result(timeout_s=RUNTIME_WAIT_S)
        outs, stats = stream_together(handle, prompts, RUNTIME_WAIT_S)
        got = handle.launches.remote().result(timeout_s=RUNTIME_WAIT_S)
        before = ready["admit_batches_by_bucket"]
        long_batches = sum(
            n - before.get(bk, 0)
            for bk, n in got["admit_batches_by_bucket"].items() if bk >= 1024)
        server_stats = handle.stats.remote().result(timeout_s=RUNTIME_WAIT_S)
        # the path the HTTP and gRPC proxies take: the replica's streaming
        # generator method, each token its own object
        replica = ray_tpu_torch.get_actor(
            serve.status()[dep.name]["replicas"][0]["name"])
        gen = replica.handle_request_gen.options(
            num_returns="streaming").remote(
                ({"tokens": prompts[0], "max_tokens": MAX_TOKENS},), {}, None)
        generated = []
        while True:
            try:
                ref = gen.next(timeout=RUNTIME_WAIT_S)
            except StopIteration:
                break
            generated.append(ray_tpu_torch.get(ref, timeout=RUNTIME_WAIT_S))
        g = torch.Generator().manual_seed(0)
        host = torch.randn(RUNTIME_PUT_ELEMS, generator=g).to(torch.bfloat16)
        want_sums = tensor_checksums(host)
        t0 = time.perf_counter()
        ref = ray_tpu_torch.put(host)
        put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sums = handle.checksums.remote(ref).result(timeout_s=RUNTIME_WAIT_S)
        call_s = time.perf_counter() - t0
        del ref
        # the replica's SLO window reaches the controller with its health
        # check (every 2 s)
        deadline = time.monotonic() + RUNTIME_WAIT_S
        while True:
            slo = serve.slo_signal().get(dep.name, {})
            if (slo.get("window_n", 0) >= len(prompts)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.5)
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    free_after = wait_free_memory(free_before - RUNTIME_FREE_SLACK,
                                  RUNTIME_WAIT_S)

    row = {
        "card": card_line(), "deployment": dep.name,
        "init_s": init_s, "warm_import_s": warm_s,
        "deploy_to_healthy_s": healthy_s,
        "gpu_resource": gpus, "gpus_leased": gpus_leased,
        "session_dir": session_dir, "device": got["device"],
        "replica_allocated_gb": ready["allocated_gb"],
        "warmup_admit_batches_by_bucket": ready["admit_batches_by_bucket"],
        "warmup_steps": stats_before["steps"],
        "ttft_ms_p50": stats["ttft_ms_p50"], "ttft_ms": stats["ttft_ms"],
        "first_to_last_ms": stats["first_to_last_ms"],
        "decode_tok_s": stats["decode_tok_s"],
        "in_process": {"ttft_ms_p50": in_stats["ttft_ms_p50"],
                       "decode_tok_s": in_stats["decode_tok_s"]},
        "flash_launches": got["flash_launches"],
        "long_prefill_batches": long_batches,
        "peak_mem_gb": got["peak_mem_gb"],
        "streams_equal_in_process": outs == in_outs,
        "tokens_equal_in_process": sum(
            a == b for x, y in zip(outs, in_outs) for a, b in zip(x, y)),
        "stats": server_stats,
        "tokens_out_delta": (server_stats["tokens_out"]
                             - stats_before["tokens_out"]),
        "generator_stream_equal": generated == outs[0],
        "slo_signal": slo,
        "put_bytes": host.numel() * host.element_size(), "put_s": put_s,
        "put_call_s": call_s, "host_to_card_s": sums["host_to_card_s"],
        "checksums_equal": sums["sums"] == want_sums,
        "free_gb_before": free_before / 1e9, "free_gb_after": free_after / 1e9,
        "phase_s": time.perf_counter() - t_phase}
    log("serve_deployment " + json.dumps(row))
    stats_keys = {"steps", "tokens_out", "active", "free_slots",
                  "admit_batches", "batch_occupancy", "padding_fraction",
                  "active_slots", "num_slots"}
    failures = []
    if Path(session_dir).parent != Path(tempfile.gettempdir(), "raytpu"):
        failures.append(f"the session {session_dir} is not under the "
                        f"temporary directory {tempfile.gettempdir()}")
    if row["device"] != torch.cuda.get_device_name(0) or gpus_leased != 1:
        failures.append(f"the replica ran on {row['device']} with "
                        f"{gpus_leased} GPUs leased")
    if long_batches < 1 or got["flash_launches"] < (
            cfg.num_layers * long_batches):
        failures.append(
            f"flash kernel launched {got['flash_launches']} times in the "
            f"replica for {long_batches} prefill batches at bucket >= 1024 "
            f"({cfg.num_layers} layers)")
    if not row["streams_equal_in_process"]:
        failures.append(f"the deployment's streams {outs} differ from the "
                        f"in-process engine's {in_outs}")
    if not row["generator_stream_equal"]:
        failures.append(f"the replica's generator method streamed "
                        f"{generated}, the handle {outs[0]}")
    if set(server_stats) != stats_keys or row["tokens_out_delta"] != (
            len(prompts) * MAX_TOKENS):
        failures.append(f"stats() gave {stats_before}, then {server_stats}")
    if not (slo.get("window_n", 0) >= len(prompts)
            and slo.get("ttft_p95_ms", 0) > 0):
        failures.append(f"slo_signal() lacks the requests' TTFT: {slo}")
    if not (row["checksums_equal"] and sums["dtype"] == "torch.bfloat16"
            and sums["numel"] == host.numel()
            and sums["device"].startswith("cuda")):
        failures.append(f"the tensor reached the card as {sums}, host "
                        f"checksums {want_sums}")
    if free_after < free_before - RUNTIME_FREE_SLACK:
        failures.append(
            f"the card has {free_after / 1e9:.2f} GB free after shutdown(),"
            f" {free_before / 1e9:.2f} GB before the phase")
    if failures:
        raise AssertionError("serve_llama3_8b_deployment: "
                             + "; ".join(failures))
    return row


def _prefill_batch(cfg, prompts, batch, dev, cycle=len(LONG_PROMPTS)):
    """A bucket-2048 batch of the first ``cycle`` prompts, repeated."""
    import numpy as np
    import torch
    bucket = 2048
    toks = np.zeros((batch, bucket), np.int32)
    lens = []
    for i in range(batch):
        p = prompts[i % (cycle or len(prompts))]
        toks[i, :len(p)] = p
        lens.append(len(p))
    return (torch.from_numpy(toks).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev),
            torch.arange(batch, dtype=torch.int32, device=dev))


def check_prefill_logits(eng, cfg, prompts, dev):
    """Prefill logits of one batch (two long prompts, bucket 2048) through
    the kernel, against the same prefill with attention through the
    kernel's plain version, and (for scale) through plain attention."""
    import torch
    from ray_tpu_torch.models import decode as dec
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.ops import flash_attention as fa

    toks, lengths, slots = _prefill_batch(cfg, prompts, 2, dev)
    with torch.inference_mode():
        cache = dec.init_kv_cache(cfg, 2, 2048, torch.bfloat16, dev)
        _, kern = dec.prefill(eng.params, cache, toks, lengths, slots, cfg)
        with patched(attention, "mha",
                     lambda q, k, v, causal=True, logit_softcap=0.0:
                     fa.flash_attention_reference(q, k, v, causal)[0]):
            _, ref = dec.prefill(eng.params, cache, toks, lengths, slots, cfg)
        with patched(attention, "mha",
                     lambda q, k, v, causal=True, logit_softcap=0.0:
                     attention.attend(q, k, v, causal=causal)):
            _, plain = dec.prefill(eng.params, cache, toks, lengths, slots,
                                   cfg)
    spread = ref.std().item()

    def rms(a, b):
        return (a - b).pow(2).mean().sqrt().item()

    row = {"std": spread,
           "rms_diff_plain_version": rms(kern, ref),
           "max_abs_diff_plain_version": (kern - ref).abs().max().item(),
           "rms_diff_plain_attention": rms(kern, plain),
           "rms_diff_plain_version_vs_plain_attention": rms(ref, plain),
           "argmax_agree": (kern.argmax(-1) == ref.argmax(-1)).float()
           .mean().item(),
           "finite": bool(torch.isfinite(kern).all())}
    log("prefill_logits " + json.dumps(row))
    if not (row["finite"]
            and row["rms_diff_plain_version"] <= LOGITS_RMS * spread
            and row["max_abs_diff_plain_version"] <= LOGITS_MAX * spread):
        raise AssertionError(
            f"prefill logits through the kernel differ from the plain "
            f"version's by rms {row['rms_diff_plain_version']}, max "
            f"{row['max_abs_diff_plain_version']} (limits {LOGITS_RMS}, "
            f"{LOGITS_MAX} x std {spread})")


def where_time_goes(eng, cfg, prompts, dev, prefix=""):
    """One prefill batch (8 x bucket 2048) and one decode dispatch (8 steps,
    8 slots), each timed with a synchronize and traced once with
    torch.profiler: device-busy share and the kernels that take the most
    device time (``time`` lines named with ``prefix``)."""
    from ray_tpu_torch.models import decode as dec

    toks, lengths, slots = _prefill_batch(cfg, prompts, 8, dev)
    steps = eng.steps_per_dispatch

    def run_prefill():
        dec.prefill(eng.params, eng.cache, toks, lengths, slots, cfg)

    def run_decode():
        dec.decode_state_loop(eng.params, eng.cache, eng._state, steps, cfg)

    trace_calls(((f"{prefix}prefill_8x2048", run_prefill, 1),
                 (f"{prefix}decode_dispatch", run_decode, steps)))


def trace_calls(calls):
    """Each (name, fn, steps) timed once with a synchronize after a warm
    run, then traced once with torch.profiler: device-busy share and the
    kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        for name, fn, per in calls:
            fn()
            sync_cards()
            t0 = time.perf_counter()
            fn()
            sync_cards()
            wall_ms = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                sync_cards()
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in kernels) / 1e3
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
            log("time " + json.dumps({
                "phase": name, "wall_ms": wall_ms,
                "ms_per_step": wall_ms / per,
                "device_busy_ms_traced": busy,
                "device_busy_share": busy / wall_ms,
                "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                                   for e in top}}))


def logits_check(name, got, want, max_share=LOGITS_MAX,
                 rms_share=LOGITS_RMS):
    """Last-token logits ``got`` against ``want`` ([N, V] f32) within the
    prefill limits: rms and largest difference as shares of ``want``'s
    std (a share of None makes that difference a reading)."""
    import torch
    spread = want.std().item()
    row = {"check": name, "std": spread,
           "rms_diff": (got - want).pow(2).mean().sqrt().item(),
           "max_abs_diff": (got - want).abs().max().item(),
           "argmax_agree": (got.argmax(-1) == want.argmax(-1)).float()
           .mean().item(),
           "finite": bool(torch.isfinite(got).all())}
    log("logits " + json.dumps(row))
    if not (row["finite"]
            and (rms_share is None or row["rms_diff"] <= rms_share * spread)
            and (max_share is None
                 or row["max_abs_diff"] <= max_share * spread)):
        raise AssertionError(
            f"{name}: logits differ by rms {row['rms_diff']}, max "
            f"{row['max_abs_diff']} (limits {rms_share}, {max_share} x std "
            f"{spread})")
    return row


def paged_cache_for(cfg, slots, pages_per_slot, dev, dtype=None):
    """A paged cache (the serving engine's page size and block-table
    width) in which slot s owns pages 1 + s * pages_per_slot onwards."""
    import torch
    from ray_tpu_torch.models import paged_decode as pdec
    cache = pdec.init_paged_cache(cfg, slots * pages_per_slot + 1, PAGE_SIZE,
                                  slots, SERVE_MAX_LEN // PAGE_SIZE,
                                  dtype or torch.bfloat16, dev)
    cache["block_table"][:, :pages_per_slot] = 1 + torch.arange(
        slots * pages_per_slot, device=dev).reshape(slots, pages_per_slot)
    return cache


def _zeros(n, dev):
    import torch
    return torch.zeros(n, dtype=torch.int32, device=dev)


def serve_llama_paged(dev, cfg, params, devices=None):
    """Phase serve_llama3_8b_paged: the serving phase's requests through
    the paged engine (``paged=True, page_size=64``).  The paged prefill
    attends with f32 einsums over the gathered pages, as the JAX package's
    does, so no kernel launches; its logits are held against the dense
    prefill's (through B1), and one paged prefill batch and one paged
    decode dispatch are timed and traced.  With ``devices`` the same at
    tp = len(devices), ``params`` the shards ("tp2_" lines), but for the
    trace: the dense tp=2 phase traces its prefill and decode."""
    import torch
    from ray_tpu_torch.models import decode as dec
    from ray_tpu_torch.models import paged_decode as pdec
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.serve.llm import LLMEngine

    tag = "tp2_" if devices else ""
    eng = LLMEngine(cfg, params, num_slots=8, max_len=SERVE_MAX_LEN,
                    paged=True, page_size=PAGE_SIZE, **engine_kw(devices))
    prompts = serving_prompts(cfg)
    try:
        warm(eng, cfg, (LONG_PROMPTS[0], SHORT_PROMPTS[0]))
        reset_peaks(devices)
        flash_attention.launches = 0
        _, _, stats = run_requests(eng, cfg, prompts)
        launches = flash_attention.launches
        stats.update(flash_launches=launches, peak_mem_gb=peak_gb(devices),
                     kv_pages=eng.breakdown()["kv_pages"],
                     num_pages=eng.num_pages)
    finally:
        eng.shutdown()
    log(f"serve_{tag}paged " + json.dumps(stats))
    if launches:
        raise AssertionError(f"the paged engine launched the flash kernel "
                             f"{launches} times; its prefill has none")

    toks, lengths, slots = _prefill_batch(cfg, prompts, 2, dev)
    with torch.inference_mode():
        _, dense = dec.prefill(params, on_shards(dec.init_kv_cache(
            cfg, 2, SERVE_MAX_LEN, torch.bfloat16, dev), devices), toks,
            lengths, slots, cfg)
        _, paged = pdec.paged_prefill(
            params, on_shards(paged_cache_for(
                cfg, 2, SERVE_MAX_LEN // PAGE_SIZE, dev), devices),
            toks, lengths, slots, _zeros(2, dev), cfg)
    logits_check(f"{tag}paged_prefill_vs_dense_prefill_b1", paged, dense)
    del dense, paged

    if devices:
        return stats
    toks, lengths, slots = _prefill_batch(cfg, prompts, 8, dev)
    pc = paged_cache_for(cfg, 8, SERVE_MAX_LEN // PAGE_SIZE, dev)
    steps = eng.steps_per_dispatch
    trace_calls((
        ("paged_prefill_8x2048", lambda: pdec.paged_prefill(
            params, pc, toks, lengths, slots, _zeros(8, dev), cfg), 1),
        ("paged_decode_dispatch", lambda: pdec.paged_decode_state_loop(
            params, eng.cache, eng._state, steps, cfg), steps)))
    return stats


def serve_llama_paged_prefix(dev, cfg, params, devices=None):
    """Phase serve_llama3_8b_paged_prefix: prompts of one shared 1024-token
    prefix and a 32-token tail of their own, as bench_llm.py's prefix arm
    builds them; 4 requests, then 4 more, whose admissions reuse the
    prefix's 16 pages each.  The second wave's first-token logits (a suffix
    prefill from position 1024) are held against a cold paged prefill of
    the same prompts.  With ``devices`` the same at tp = len(devices),
    ``params`` the shards ("tp2_" lines)."""
    import numpy as np
    import torch
    from ray_tpu_torch.models import paged_decode as pdec
    from ray_tpu_torch.serve.llm import LLMEngine

    tag = "tp2_" if devices else ""
    rng = np.random.default_rng(1)
    prefix = rng.integers(1, cfg.vocab_size, PREFIX_LEN).tolist()
    prompts = [prefix + rng.integers(1, cfg.vocab_size, TAIL_LEN).tolist()
               for _ in range(8)]
    eng = LLMEngine(cfg, params, num_slots=8, max_len=SERVE_MAX_LEN,
                    paged=True, page_size=PAGE_SIZE, **engine_kw(devices))
    try:
        warm(eng, cfg, (PREFIX_LEN + TAIL_LEN, TAIL_LEN))
        waves = [run_requests(eng, cfg, wave)[2]
                 for wave in (prompts[:4], prompts[4:])]
        bd = eng.breakdown()
    finally:
        eng.shutdown()
    pc_stats = bd["prefix_cache"]
    stats = {"wave_1": waves[0], "wave_2": waves[1],
             "prefix_cache": pc_stats, "kv_pages": bd["kv_pages"]}
    log(f"serve_{tag}paged_prefix " + json.dumps(stats))
    if (pc_stats["hits"], pc_stats["tokens_reused"]) != (4, 4 * PREFIX_LEN):
        raise AssertionError(f"prefix cache: {pc_stats}; want 4 hits reusing "
                             f"{PREFIX_LEN // PAGE_SIZE} pages each")

    # cold: slots 0-3 prefill whole prompts; warm: slots 4-7 read slot 0's
    # prefix pages and prefill their tails from position PREFIX_LEN
    n, per = 4, -(-(PREFIX_LEN + TAIL_LEN) // PAGE_SIZE)
    shared = PREFIX_LEN // PAGE_SIZE
    cache = paged_cache_for(cfg, 2 * n, per, dev)
    cache["block_table"][n:, :shared] = cache["block_table"][0, :shared]
    toks, lengths, slots = _prefill_batch(cfg, prompts[4:], n, dev, None)
    tails = torch.tensor([p[PREFIX_LEN:] for p in prompts[4:]],
                         dtype=torch.int32, device=dev)
    cache = on_shards(cache, devices)
    with torch.inference_mode():
        _, cold = pdec.paged_prefill(params, cache, toks, lengths, slots,
                                     _zeros(n, dev), cfg)
        _, warm_logits = pdec.paged_prefill(
            params, cache, tails, torch.full_like(lengths, TAIL_LEN),
            slots + n, torch.full_like(lengths, PREFIX_LEN), cfg)
    logits_check(f"{tag}prefix_reuse_vs_cold_paged_prefill", warm_logits,
                 cold)
    return stats


def serve_llama_paged_spec(dev, cfg, params):
    """Phase serve_llama3_8b_paged_spec: the serving phase's requests
    through the paged engine with speculative decoding (k 4, a 1-layer
    draft), as bench_llm.py's paged_spec arm runs it, on weights whose
    blocks past the first are damped by 0.02 (so that the draft agrees as
    a trained pair would).  The draft's prefill runs B1 at buckets >= 1024;
    its launches are counted.  The same requests through the vanilla paged
    engine on the same weights give the streams' agreement (a reading: bf16
    near-ties can flip an argmax between a window and a single step), and
    the verify window's logits are held against sequential decode steps."""
    import torch
    from ray_tpu_torch.models import speculative as spec
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.serve.llm import LLMEngine

    damped = spec.damp_block_outputs(params, 0.02, from_layer=1)
    prompts = serving_prompts(cfg)
    kw = dict(device="cuda", num_slots=8, max_len=SERVE_MAX_LEN, paged=True,
              page_size=PAGE_SIZE)
    eng = LLMEngine(cfg, damped, spec_decode_enabled=True, spec_k=4,
                    spec_draft_layers=1, **kw)
    try:
        warm(eng, cfg, (LONG_PROMPTS[0], SHORT_PROMPTS[0]))
        before = dict(eng.admit_batches_by_bucket)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        outs, _, stats = run_requests(eng, cfg, prompts)
        launches = flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        long_batches = long_batches_since(eng, before)
        sp = eng.breakdown()["spec"]
        draft_error = eng.spec_draft_last_error
    finally:
        eng.shutdown()
    if sp["draft_errors"]:
        raise AssertionError(f"the draft's prefill failed {sp['draft_errors']}"
                             f" times; the last error: {draft_error!r}")
    if long_batches < 1 or launches < sp["draft_layers"] * long_batches:
        raise AssertionError(
            f"flash kernel launched {launches} times for {long_batches} draft "
            f"prefill batches at bucket >= 1024 ({sp['draft_layers']} layers)")

    vanilla = LLMEngine(cfg, damped, **kw)
    try:
        warm(vanilla, cfg, (LONG_PROMPTS[0], SHORT_PROMPTS[0]))
        outs_v, _, stats_v = run_requests(vanilla, cfg, prompts)
    finally:
        vanilla.shutdown()
    agree = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                  len(x)) for x, y in zip(outs, outs_v)]
    stats.update(spec=sp, flash_launches=launches,
                 long_prefill_batches=long_batches, peak_mem_gb=peak / 1e9,
                 vanilla={k: stats_v[k] for k in ("ttft_ms_p50",
                                                  "decode_tok_s", "wall_s")},
                 tokens_agreeing_before_divergence=agree)
    log("serve_paged_spec " + json.dumps(stats))
    check_verify_windows(cfg, damped, prompts, outs, dev)
    return stats, launches


def check_verify_windows(cfg, params, prompts, outs, dev):
    """A 4-token window per slot (the first tokens of two streams) through
    ``verify_window`` (dense cache) and ``paged_verify_window``, against 4
    sequential one-token steps on a copy of the same cache."""
    import torch
    from ray_tpu_torch.models import decode as dec
    from ray_tpu_torch.models import paged_decode as pdec
    from ray_tpu_torch.models import speculative as spec

    toks, lengths, slots = _prefill_batch(cfg, prompts, 2, dev)
    window = torch.tensor([o[:4] for o in outs[:2]], dtype=torch.int32,
                          device=dev)
    active = torch.ones(2, dtype=torch.bool, device=dev)
    with torch.inference_mode():
        for name, cache, verify, step in (
                ("dense", dec.init_kv_cache(cfg, 2, SERVE_MAX_LEN,
                                            torch.bfloat16, dev),
                 spec.verify_window, dec.decode_step),
                ("paged", paged_cache_for(cfg, 2, SERVE_MAX_LEN // PAGE_SIZE,
                                          dev),
                 pdec.paged_verify_window, pdec.paged_decode_step)):
            if name == "dense":
                cache, _ = dec.prefill(params, cache, toks, lengths, slots,
                                       cfg)
            else:
                cache, _ = pdec.paged_prefill(params, cache, toks, lengths,
                                              slots, _zeros(2, dev), cfg)
            copy = {k: v.clone() for k, v in cache.items()}
            _, wl = verify(params, cache, window, active, cfg)
            steps = []
            for j in range(window.shape[1]):
                copy, sl = step(params, copy, window[:, j], active, cfg)
                steps.append(sl)
            logits_check(f"verify_window_{name}_vs_4_decode_steps",
                         wl.flatten(0, 1), torch.stack(steps, 1).flatten(0, 1))
            del cache, copy


def spec_exact_f32(dev):
    """Phase serve_f32_spec_exactness: a 2-layer cut of Llama-3-8B at full
    width (f32 weights from seed 0, damped past the first block, f32
    compute), 4 greedy requests through the paged engine with and without
    speculative decoding.  The streams must be equal token for token, and
    the spec engine's pages must pass ``rollback_kv_diff``."""
    import numpy as np
    import torch
    from ray_tpu_torch.models import config as mcfg
    from ray_tpu_torch.models import speculative as spec
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = dataclasses.replace(mcfg.llama3_8b(), num_layers=2)
    params = spec.damp_block_outputs(transformer.init_params(
        torch.Generator(device=dev).manual_seed(0), cfg, dtype=torch.float32),
        0.02, from_layer=1)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in EXACT_PROMPTS]
    kw = dict(device="cuda", num_slots=len(prompts), max_len=SERVE_MAX_LEN,
              paged=True, page_size=PAGE_SIZE, compute_dtype=torch.float32)
    runs = {}
    for name, extra in (("vanilla", {}),
                        ("spec", dict(spec_decode_enabled=True, spec_k=4,
                                      spec_draft_layers=1))):
        eng = LLMEngine(cfg, params, **kw, **extra)
        try:
            runs[name] = (eng, *run_requests(eng, cfg, prompts,
                                             EXACT_MAX_TOKENS))
        finally:
            eng.shutdown()
    eng, outs, reqs, _ = runs["spec"]
    outs_v = runs["vanilla"][1]
    lens_ok, worst = rollback_kv_diff(eng, reqs, params, cfg, dev)
    sp = eng.breakdown()["spec"]
    row = {"streams_equal": outs == outs_v, "lengths_match": lens_ok,
           "kv_max_rel_diff": worst, "spec": sp,
           "tokens_agreeing_before_divergence": [
               next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                    len(x)) for x, y in zip(outs, outs_v)],
           "decode_tok_s": {k: runs[k][3]["decode_tok_s"] for k in runs}}
    log("spec_exact_f32 " + json.dumps(row))
    if not (row["streams_equal"] and lens_ok and worst <= SPEC_KV_RTOL
            and sp["draft_errors"] == 0):
        raise AssertionError(f"f32 speculative decoding: {row}")


def rollback_kv_diff(eng, reqs, params, cfg, dev):
    """The rollback invariant after a spec engine's run: each request's
    slot has the length of its verified sequence (its prompt and every
    streamed token but the last), and its pages hold what a fresh paged
    prefill of that sequence writes.  -> (lengths match, largest K/V
    difference as a share of the fresh cache's largest magnitude)."""
    import torch
    from ray_tpu_torch.models import paged_decode as pdec

    verified = [r.tokens[:-1] for r in reqs]
    longest = max(map(len, verified))
    fresh = paged_cache_for(cfg, len(reqs), -(-longest // PAGE_SIZE), dev,
                            torch.float32)
    toks = torch.zeros((len(reqs), 1 << (longest - 1).bit_length()),
                       dtype=torch.int32, device=dev)
    for i, v in enumerate(verified):
        toks[i, :len(v)] = torch.tensor(v, dtype=torch.int32)
    lengths = torch.tensor(list(map(len, verified)), dtype=torch.int32,
                           device=dev)
    with torch.inference_mode():
        pdec.paged_prefill(params, fresh, toks, lengths,
                           torch.arange(len(reqs), dtype=torch.int32,
                                        device=dev),
                           _zeros(len(reqs), dev), cfg, torch.float32)
    lens_ok = all(int(eng.cache["length"][r.slot]) == len(v)
                  for r, v in zip(reqs, verified))

    def rows(cache, slot, n, key):
        pos = torch.arange(n, device=dev)
        pages = cache["block_table"][slot, pos // PAGE_SIZE].long()
        return cache[key][:, pages, pos % PAGE_SIZE]

    worst = 0.0
    for i, (r, v) in enumerate(zip(reqs, verified)):
        for key in ("k", "v"):
            got = rows(eng.cache, r.slot, len(v), key)
            want = rows(fresh, i, len(v), key)
            worst = max(worst, ((got - want).abs().max()
                                / want.abs().max()).item())
    return lens_ok, worst


def layer_cut(cfg, params, n):
    """``cfg`` and ``params`` cut to their first ``n`` layers (the block
    weights' views)."""
    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:n]

    return (dataclasses.replace(cfg, num_layers=n),
            {**params, "blocks": cut(params["blocks"])})


def serve_llama_tp(dev, cfg, params, devices):
    """Phase serve_llama3_8b_tp2: ``LLMEngine(tp=2)`` splits the serving
    weights (``params``: ``main`` passes them cut to TP_SERVE_LAYERS) over
    two shards on ``devices``, and the dense phase's 8 requests go through
    it: B1 launches 2 x ``cfg.num_layers`` per bucket-2048
    prefill batch (each shard's prefill at 16 q and 4 KV heads); TTFT,
    decode tok/s and peak memory, a prefill batch and a decode dispatch
    traced.  Then one 8 x 2048 prefill batch at tp=2 against tp=1 on the
    same weights (rms limit, the largest difference a reading: the shards'
    halves of each projection add in bf16 in another order), and the paged
    engine and the prefix waves on the same shards (``serve_llama_paged``,
    untraced, ``serve_llama_paged_prefix``: no launch, 4 hits reusing 4096
    tokens)."""
    import torch
    from ray_tpu_torch.models import decode as dec
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.serve.llm import LLMEngine

    tp = len(devices)
    eng = LLMEngine(cfg, params, num_slots=8, max_len=SERVE_MAX_LEN,
                    **engine_kw(devices))
    prompts = serving_prompts(cfg)
    try:
        warm(eng, cfg, (LONG_PROMPTS[0], SHORT_PROMPTS[0]))
        before = dict(eng.admit_batches_by_bucket)
        reset_peaks(devices)
        flash_attention.launches = 0
        _, _, stats = run_requests(eng, cfg, prompts)
        launches = flash_attention.launches
        peaks = peaks_by_card(devices)
        long_batches = long_batches_since(eng, before)
    finally:
        eng.shutdown()
    stats.update(
        tp=tp, devices=[str(d) for d in devices],
        num_layers=cfg.num_layers,
        long_prefill_batches=long_batches, flash_launches=launches,
        peak_mem_gb=max(peaks.values()), peak_mem_gb_by_card=peaks)
    log("serve_tp2 " + json.dumps(stats))
    if long_batches < 1 or launches < tp * cfg.num_layers * long_batches:
        raise AssertionError(
            f"flash kernel launched {launches} times for {long_batches} "
            f"prefill batches at bucket >= 1024 ({tp} shards x "
            f"{cfg.num_layers} layers)")

    toks, lengths, slots = _prefill_batch(cfg, prompts, 8, dev)
    with torch.inference_mode():
        _, one = dec.prefill(params, dec.init_kv_cache(
            cfg, 8, SERVE_MAX_LEN, torch.bfloat16, dev), toks, lengths,
            slots, cfg)
        _, two = dec.prefill(eng.params, on_shards(dec.init_kv_cache(
            cfg, 8, SERVE_MAX_LEN, torch.bfloat16, dev), devices), toks,
            lengths, slots, cfg)
    logits_check("tp2_prefill_vs_tp1_prefill_8x2048", two, one,
                 max_share=None)
    del one, two
    where_time_goes(eng, cfg, prompts, dev, "tp2_")
    shards = eng.params
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    serve_llama_paged(dev, cfg, shards, devices)
    serve_llama_paged_prefix(dev, cfg, shards, devices)
    return stats, launches


def tp_exact_f32(dev, devices):
    """Phase serve_f32_tp_exactness: a 2-layer cut of Llama-3-8B at full
    width (f32 weights from seed 0, f32 compute; 6 GB, and 6 GB more of
    shards), the f32 exactness run's 4 greedy requests through the dense
    and the paged engine at tp=1 and at tp=2 on ``devices``.  The tp=2
    streams must equal tp=1's token for token (on a difference, the top-2
    logit gap of tp=1 at the first differing token is printed), and each
    shard's K/V at every request's positions must equal tp=1's at that
    shard's KV heads within SPEC_KV_RTOL of the largest magnitude."""
    import numpy as np
    import torch
    from ray_tpu_torch.models import config as mcfg
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = dataclasses.replace(mcfg.llama3_8b(), num_layers=2)
    params = transformer.init_params(
        torch.Generator(device=dev).manual_seed(0), cfg, dtype=torch.float32)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in EXACT_PROMPTS]
    for mode, kw in (("dense", {}),
                     ("paged", dict(paged=True, page_size=PAGE_SIZE))):
        runs = []
        for place in (None, devices):
            eng = LLMEngine(cfg, params, num_slots=len(prompts),
                            max_len=SERVE_MAX_LEN,
                            compute_dtype=torch.float32, **kw,
                            **engine_kw(place))
            try:
                outs, reqs, stats = run_requests(eng, cfg, prompts,
                                                 EXACT_MAX_TOKENS)
            finally:
                eng.shutdown()
            runs.append((eng, outs, reqs, stats))
        (one, outs_1, reqs_1, stats_1), (two, outs_2, reqs_2, stats_2) = runs
        row = {"mode": mode, "streams_equal": outs_2 == outs_1,
               "slots_equal": ([r.slot for r in reqs_1]
                               == [r.slot for r in reqs_2]),
               "kv_max_rel_diff_by_shard": tp_kv_diffs(one, two, reqs_1, dev),
               "decode_tok_s": {"tp1": stats_1["decode_tok_s"],
                                "tp2": stats_2["decode_tok_s"]}}
        if not row["streams_equal"]:
            i, j = next((i, j) for i, (x, y) in enumerate(zip(outs_1, outs_2))
                        for j, (a, b) in enumerate(zip(x, y)) if a != b)
            row["first_difference"] = {
                "request": i, "token": j,
                "tp1_top2_logit_gap": top2_gap(
                    params, cfg, prompts[i] + outs_1[i][:j], dev)}
        log("tp_exact_f32 " + json.dumps(row))
        if not (row["streams_equal"] and row["slots_equal"]
                and max(row["kv_max_rel_diff_by_shard"]) <= SPEC_KV_RTOL):
            raise AssertionError(f"f32 tp=2 against tp=1: {row}")
        del runs, one, two


def tp_kv_diffs(one, two, reqs, dev):
    """Each shard's K/V of engine ``two`` (tp shards) against engine
    ``one``'s (tp=1) at that shard's KV heads, over every request's
    positions but its last token's (which no step fed back): the largest
    difference as a share of the largest magnitude, per shard."""
    import torch

    def rows(cache, slot, n, key):
        if "block_table" not in cache:
            return cache[key][:, slot, :n]
        pos = torch.arange(n, device=cache[key].device)
        pages = cache["block_table"][slot, pos // PAGE_SIZE].long()
        return cache[key][:, pages, pos % PAGE_SIZE]

    worst = [0.0] * len(two.cache)
    for r in reqs:
        n = len(r.tokens) - 1
        for key in ("k", "v"):
            want = rows(one.cache, r.slot, n, key)
            for s, shard in enumerate(two.cache):
                got = rows(shard, r.slot, n, key).to(dev)
                kv = got.shape[2]
                ref = want[:, :, s * kv:(s + 1) * kv]
                worst[s] = max(worst[s], ((got - ref).abs().max()
                                          / ref.abs().max()).item())
    return worst


def top2_gap(params, cfg, seq, dev):
    """The gap between the two largest next-token logits after ``seq``,
    from one f32 prefill."""
    import torch
    from ray_tpu_torch.models import decode as dec
    n = len(seq)
    bucket = 1 << (n - 1).bit_length()
    toks = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    toks[0, :n] = torch.tensor(seq, dtype=torch.int32)
    with torch.inference_mode():
        _, logits = dec.prefill(
            params, dec.init_kv_cache(cfg, 1, bucket, torch.float32, dev),
            toks, torch.tensor([n], dtype=torch.int32, device=dev),
            _zeros(1, dev), cfg, torch.float32)
    top = logits[0].topk(2).values
    return (top[0] - top[1]).item()


def moe_weights(cfg, dev, seed=3):
    """One Mixtral MoE layer's random bf16 weights at init_params' scales:
    router [H, E], w_gate and w_in [E, H, M], w_out [E, M, H]."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, m, e = cfg.hidden_size, cfg.mlp_size, cfg.num_experts

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16).mul_(std)
    return (normal((h, e), h ** -0.5), normal((e, h, m), h ** -0.5),
            normal((e, h, m), h ** -0.5), normal((e, m, h), m ** -0.5))


def check_moe(dev):
    """Phase moe_layer: ``moe_mlp`` (routing indices, the kept tokens
    gathered into [E, C, H], three batched matmuls, a gather and a weighted
    sum) against ``moe_mlp_onehot`` (the reference's einsums against
    one-hot [T, E, C] tensors, with its own top-k and routing loop) at
    Mixtral's width in bf16, on random inputs of unit rms (a norm's output)
    for each case of MOE_CASES.  The kept (token, choice) pairs and their
    buffer positions must be the same, the output within MOE_OUT_RTOL, and
    the skewed router's case must drop pairs; both timed, beside the
    layer's bound: the larger of its three expert products over every slot
    at the bf16 peak, and its weights, input and output moved once at the
    HBM rate."""
    import torch
    from ray_tpu_torch.models import config as mcfg
    from ray_tpu_torch.ops import moe

    cfg = mcfg.mixtral_8x7b()
    h, m, e = cfg.hidden_size, cfg.mlp_size, cfg.num_experts
    k, cf = cfg.experts_per_token, cfg.expert_capacity_factor
    router, *experts = moe_weights(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    for b, s, skewed in MOE_CASES:
        scale = MOE_ROUTER_SKEW ** (
            (torch.arange(e, device=dev) - (e - 1) / 2) / ((e - 1) / 2))
        weights = ((router.float() * scale).to(router.dtype) if skewed
                   else router, *experts)
        x = torch.randn((b, s, h), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        t, cap = b * s, moe.capacity(cf, k, b, s, e)
        with torch.inference_mode():
            out, aux = moe.moe_mlp(x, *weights, k, cf)
            ref, ref_aux = moe.moe_mlp_onehot(x, *weights, k, cf)
            logits = x.reshape(t, h) @ weights[0]
            r = moe.route(logits, k, cap)
            dispatch = moe.top_k_routing(logits, k, cap)[0].view(t, -1)
            at_slot = dispatch.gather(1, torch.where(r.kept, r.slot, 0))
            same_pairs = bool((at_slot[r.kept] == 1).all()) and int(
                dispatch.sum()) == int(r.kept.sum())
            del dispatch, at_slot
            ms = time_ms(lambda: moe.moe_mlp(x, *weights, k, cf), 5, 1)
            onehot_ms = time_ms(
                lambda: moe.moe_mlp_onehot(x, *weights, k, cf), 3, 1)
        flops_ms = 2 * 3 * e * cap * h * m / PEAK_BF16_FLOPS * 1e3
        bytes_ms = 2 * (3 * e * h * m + h * e + 2 * t * h) / PEAK_BYTES_S * 1e3
        row = {"tokens": t, "capacity": cap, "skewed_router": skewed,
               "max_abs_err": (out - ref).abs().max().item(),
               "onehot_max_abs": ref.abs().max().item(),
               "aux": aux.item(), "onehot_aux": ref_aux.item(),
               "same_kept_pairs_and_positions": same_pairs,
               "dropped_share": 1.0 - r.kept.float().mean().item(),
               "dropped_share_by_choice":
                   (1.0 - r.kept.float().mean(0)).tolist(),
               "finite": bool(torch.isfinite(out).all()),
               "ms": ms, "onehot_ms": onehot_ms,
               "flops_bound_ms": flops_ms, "bytes_bound_ms": bytes_ms,
               "bound_ms": max(flops_ms, bytes_ms),
               "bound_by": "operations" if flops_ms >= bytes_ms else "bytes"}
        log("moe_layer " + json.dumps(row))
        del x, out, ref
        if not (row["finite"] and same_pairs
                and row["max_abs_err"] <= MOE_OUT_RTOL * row["onehot_max_abs"]
                and abs(row["aux"] - row["onehot_aux"]) <= 1e-6
                and (row["dropped_share"] > 0 or not skewed)):
            raise AssertionError(f"moe_mlp against moe_mlp_onehot: {row}")


@contextlib.contextmanager
def routing_log(calls, replay=None):
    """Record every MoE call's routing in ``calls`` while the block runs, as
    (tokens, dropped (token, choice) pairs as a device tensor, the
    ``Routing`` detached), with no host sync.  With ``replay`` (the calls
    of an earlier run on the same batch, in the same order), each call
    takes that run's discrete routing (experts, slots, kept) and computes
    its weights and aux loss from its own logits (``replayed``)."""
    from ray_tpu_torch.ops import moe
    real = moe.route
    earlier = iter(replay or ())

    def route(logits, k, cap):
        r = (replayed(logits, next(earlier)[2]) if replay is not None
             else real(logits, k, cap))
        calls.append((logits.shape[0], (~r.kept).sum(),
                      moe.Routing(*(f.detach() for f in r))))
        return r

    with patched(moe, "route", route):
        yield


def replayed(logits, was):
    """``was``'s experts, slots and kept flags, with the weights and the
    aux loss computed from ``logits`` as the reference computes them: the
    f32 softmax gathered at those experts and renormalised, 0 where
    dropped; E * sum(mean(probs) * share routed to each by choice 0)."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import moe
    e = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    top_p = probs.gather(-1, was.expert)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    aux = e * torch.sum(probs.mean(0)
                        * F.one_hot(was.expert[:, 0], e).float().mean(0))
    return moe.Routing(was.expert, was.slot, was.kept, top_p * was.kept, aux)


def dropped_shares(log_rows, decode_tokens):
    """Dropped shares of the (token, choice) pairs over the prefill calls
    and over the decode calls (``decode_tokens`` rows a call), every row of
    a call counted (padding rows and inactive slots too)."""
    out = {}
    for name, calls in (
            ("prefill", [c for c in log_rows if c[0] != decode_tokens]),
            ("decode", [c for c in log_rows if c[0] == decode_tokens])):
        pairs = 2 * sum(c[0] for c in calls)
        out[name] = (sum(int(c[1]) for c in calls) / pairs) if pairs else None
    return out


def serve_mixtral(dev, cfg, params):
    """Phase serve_mixtral_8x7b: the serving phase's 8 requests through
    ``LLMEngine`` on Mixtral-8x7B cut to MIXTRAL_SERVE_LAYERS layers (random
    bf16 weights, seed 0): the dense engine (B1 launches 16 per bucket-2048
    prefill batch; TTFT, decode tok/s, peak memory, dropped shares; a
    prefill batch and a decode dispatch traced), then the paged engine on
    the same weights (no kernel launch); then
    ``mixtral_prefill_checks``."""
    import torch
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.serve.llm import LLMEngine

    prompts = serving_prompts(cfg)
    runs = {}
    for name, kw in (("dense", {}),
                     ("paged", dict(paged=True, page_size=PAGE_SIZE))):
        eng = LLMEngine(cfg, params, device="cuda", num_slots=8,
                        max_len=SERVE_MAX_LEN, **kw)
        routes = []
        try:
            warm(eng, cfg, (LONG_PROMPTS[0], SHORT_PROMPTS[0]))
            before = dict(eng.admit_batches_by_bucket)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.flash_attention.launches = 0
            with routing_log(routes):
                _, _, stats = run_requests(eng, cfg, prompts)
            launches = fa.flash_attention.launches
            stats.update(flash_launches=launches,
                         long_prefill_batches=long_batches_since(eng, before),
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                         dropped_share=dropped_shares(routes,
                                                      eng.num_slots + 1))
            if name == "dense":
                where_time_goes(eng, cfg, prompts, dev, "mixtral_")
        finally:
            eng.shutdown()
        log(f"serve_mixtral_{name} " + json.dumps(stats))
        runs[name] = stats
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    dense, paged = runs["dense"], runs["paged"]
    if (dense["long_prefill_batches"] < 1 or dense["flash_launches"]
            < cfg.num_layers * dense["long_prefill_batches"]):
        raise AssertionError(
            f"flash kernel launched {dense['flash_launches']} times for "
            f"{dense['long_prefill_batches']} prefill batches at bucket >= "
            f"1024 ({cfg.num_layers} layers)")
    if paged["flash_launches"]:
        raise AssertionError(f"the paged engine launched the flash kernel "
                             f"{paged['flash_launches']} times")

    mixtral_prefill_checks(cfg, params, prompts, dev)
    return dense, paged


def mixtral_prefill_checks(cfg, params, prompts, dev):
    """One bucket-2048 batch of two long prompts through the dense prefill
    with B1, with B1's plain version and with plain attention, and through
    the paged prefill.  Routing is discontinuous: bf16 rounding of P at
    other tile boundaries flips near-tied router choices, a flip moves the
    token's MLP output and what the capacity drops, and through 16 layers
    the logits part.  Each run routing freely is a reading (with the share
    of tokens routed otherwise than in B1's run); the checks replay B1's
    routing in the other run (``routing_log``), so that they compare the
    attention paths: B1 against its plain version, and the paged prefill
    (f32 attention over pages) against the dense one, each within the rms
    limit, the largest difference a reading.  Replayed, the paged
    prefill's padding positions (their K/V go to the null page, where the
    dense prefill's attend over the padded row) no longer move what the
    capacity drops for the real tokens."""
    import torch
    from ray_tpu_torch.models import decode as dec
    from ray_tpu_torch.models import paged_decode as pdec
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.ops import flash_attention as fa

    toks, lengths, slots = _prefill_batch(cfg, prompts, 2, dev)
    real = (torch.arange(SERVE_MAX_LEN, device=dev)[None]
            < lengths[:, None]).reshape(-1)                # [T]

    def plain_version(q, k, v, causal=True, logit_softcap=0.0):
        return fa.flash_attention_reference(q, k, v, causal)[0]

    def plain_attention(q, k, v, causal=True, logit_softcap=0.0):
        return attention.attend(q, k, v, causal=causal)

    def prefill(mha, calls, replay=None):
        with torch.inference_mode(), patched(attention, "mha", mha), \
                routing_log(calls, replay):
            return dec.prefill(params, dec.init_kv_cache(
                cfg, 2, SERVE_MAX_LEN, torch.bfloat16, dev), toks, lengths,
                slots, cfg)[1]

    def paged_prefill(calls, replay=None):
        cache = paged_cache_for(cfg, 2, SERVE_MAX_LEN // PAGE_SIZE, dev)
        with torch.inference_mode(), routing_log(calls, replay):
            return pdec.paged_prefill(params, cache, toks, lengths, slots,
                                      _zeros(2, dev), cfg)[1]

    b1_calls = []
    b1 = prefill(attention.mha, b1_calls)
    free = {}
    for name, run in (("plain_version", lambda c: prefill(plain_version, c)),
                      ("plain_attention",
                       lambda c: prefill(plain_attention, c)),
                      ("paged", paged_prefill)):
        calls = []
        free[name] = run(calls)
        differs = torch.stack([(a[2].expert != b[2].expert).any(-1)
                               for a, b in zip(b1_calls, calls)])  # [L, T]
        log("mixtral_routing " + json.dumps({
            "b1_vs": name,
            "layer_token_rows_routed_differently":
                differs.float().mean().item(),
            "real_tokens_routed_differently_in_any_layer":
                differs[:, real].any(0).float().mean().item(),
            "padding_tokens_routed_differently_in_any_layer":
                differs[:, ~real].any(0).float().mean().item()}))
        logits_check(f"mixtral_prefill_b1_vs_{name}_free_routing_reading",
                     b1, free[name], max_share=None, rms_share=None)
    logits_check("mixtral_prefill_plain_version_vs_plain_attention_"
                 "free_routing_reading", free["plain_version"],
                 free["plain_attention"], max_share=None, rms_share=None)
    logits_check("mixtral_prefill_b1_vs_plain_version_b1_routing",
                 prefill(plain_version, [], b1_calls), b1, max_share=None)
    logits_check("mixtral_paged_prefill_vs_dense_prefill_b1_routing",
                 paged_prefill([], b1_calls), b1, max_share=None)


def serve_mixtral_tp(dev, cfg, params, devices):
    """Phase serve_mixtral_8x7b_tp2: Mixtral-8x7B cut to MIXTRAL_TP_LAYERS
    layers, split by ``LLMEngine(tp=2)`` over ``devices`` (experts split on
    M, routed once on shard 0): the serving requests through the dense
    engine (B1 2 x 8 launches per bucket-2048 batch; TTFT, tok/s, peak
    memory, dropped shares as readings).  Then one 8 x 2048 prefill batch
    at tp=2 against tp=1 on the same weights: with tp=1's routing replayed
    (``routing_log``) the logits within the rms limit; routed freely, the
    logits, the share of rows routed otherwise and the dropped shares are
    readings (bf16 sums of the shards' halves flip near-tied
    router choices, as other attention tiles do; PERF.md §6)."""
    import torch
    from ray_tpu_torch.models import decode as dec
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.serve.llm import LLMEngine

    tp = len(devices)
    prompts = serving_prompts(cfg)
    eng = LLMEngine(cfg, params, num_slots=8, max_len=SERVE_MAX_LEN,
                    **engine_kw(devices))
    routes = []
    try:
        warm(eng, cfg, (LONG_PROMPTS[0], SHORT_PROMPTS[0]))
        before = dict(eng.admit_batches_by_bucket)
        reset_peaks(devices)
        fa.flash_attention.launches = 0
        with routing_log(routes):
            _, _, stats = run_requests(eng, cfg, prompts)
        launches = fa.flash_attention.launches
        peaks = peaks_by_card(devices)
        stats.update(tp=tp, flash_launches=launches,
                     long_prefill_batches=long_batches_since(eng, before),
                     peak_mem_gb=max(peaks.values()),
                     peak_mem_gb_by_card=peaks,
                     dropped_share=dropped_shares(routes, eng.num_slots + 1))
    finally:
        eng.shutdown()
    log("serve_mixtral_tp2 " + json.dumps(stats))
    if (stats["long_prefill_batches"] < 1 or launches
            < tp * cfg.num_layers * stats["long_prefill_batches"]):
        raise AssertionError(
            f"flash kernel launched {launches} times for "
            f"{stats['long_prefill_batches']} prefill batches at bucket >= "
            f"1024 ({tp} shards x {cfg.num_layers} layers)")
    shards = eng.params
    del eng

    toks, lengths, slots = _prefill_batch(cfg, prompts, 8, dev)

    def prefill(p, calls, replay=None):
        cache = dec.init_kv_cache(cfg, 8, SERVE_MAX_LEN, torch.bfloat16, dev)
        with torch.inference_mode(), routing_log(calls, replay):
            return dec.prefill(p, cache if p is params else on_shards(
                cache, devices), toks, lengths, slots, cfg)[1]

    one_calls, free_calls, replay_calls = [], [], []
    one = prefill(params, one_calls)
    free = prefill(shards, free_calls)
    differs = torch.stack([(a[2].expert != b[2].expert).any(-1)
                           for a, b in zip(one_calls, free_calls)])
    log("mixtral_tp_routing " + json.dumps({
        "tp2_vs_tp1_layer_token_rows_routed_differently":
            differs.float().mean().item()}))
    logits_check("mixtral_tp2_vs_tp1_prefill_free_routing_reading", free, one,
                 max_share=None, rms_share=None)
    logits_check("mixtral_tp2_vs_tp1_prefill_tp1_routing",
                 prefill(shards, replay_calls, one_calls), one,
                 max_share=None)
    log("mixtral_tp_dropped_reading " + json.dumps({
        "tp1": dropped_shares(one_calls, None)["prefill"],
        "tp2_free_routing": dropped_shares(free_calls, None)["prefill"]}))
    return stats


def plain_attention():
    """Attention through the kernels' plain versions, forward (B1's, on
    512 x 512 tiles) and backward (B2's and B3's), as a differentiable
    function with ``mha``'s signature."""
    import torch
    from ray_tpu_torch.ops import flash_attention as fa

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal):
            out, lse = fa.flash_attention_reference(q, k, v, causal,
                                                    512, 512)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.causal = causal
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, out, lse = ctx.saved_tensors
            return (*fa.flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                                      ctx.causal), None)

    return lambda q, k, v, causal=True, logit_softcap=0.0: Plain.apply(
        q, k, v, causal)


def plain_splash_attention():
    """Splash attention through B4's plain versions, forward and backward,
    as a differentiable function with ``splash_attention``'s signature."""
    import torch
    from ray_tpu_torch.ops import flash_attention as fa

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, qs, k, v, causal, softcap, blocks):
            out, lse = fa.flash_attention_reference(qs, k, v, causal,
                                                    *blocks[:2], softcap, 1.0)
            ctx.save_for_backward(qs, k, v, out, lse)
            ctx.args = causal, softcap, blocks
            return out

        @staticmethod
        def backward(ctx, dout):
            qs, k, v, out, lse = ctx.saved_tensors
            causal, softcap, blocks = ctx.args
            return (*fa.flash_attention_bwd_reference(
                qs, k, v, out, lse, dout, causal, *blocks[2:], softcap, 1.0),
                None, None, None)

    return lambda qs, k, v, causal=True, softcap=0.0, blocks=(512,) * 4: \
        Plain.apply(qs, k, v, causal, softcap, tuple(blocks))


def attention_counters():
    """Every attention kernel's wrapper, by kernel name: each counts its
    launches."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import splash_attention as sa
    return {"flash_attention_fwd": fa.flash_attention,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "splash_attention_fwd": sa.splash_attention,
            "splash_attention_bwd_dq": sa.splash_attention_bwd_dq,
            "splash_attention_bwd_dkv": sa.splash_attention_bwd_dkv}


# full remat replays the whole layer: B1 runs again in the backward
FLASH_PER_LAYER = {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 1,
                   "flash_attention_bwd_dkv": 1}


def run_training(name, cfg, remat, per_layer):
    """``make_optimizer`` / ``init_sharded_state`` / ``make_train_step`` on
    ``cfg`` (fp32 params and Adam state, bf16 compute), TRAIN_STEPS steps on
    one batch of TRAIN_BATCH x (TRAIN_SEQ + 1) tokens from numpy seed 0,
    the launch counters zeroed just before and read just after.  Fails
    unless the loss is finite and falling and every attention kernel
    launched ``per_layer`` times per layer and step.  -> (state, step,
    batch, stats, launches)."""
    import numpy as np
    import torch
    from ray_tpu_torch.parallel import (init_sharded_state, make_optimizer,
                                        make_train_step)
    from ray_tpu_torch.parallel.train_step import _leaves

    counters = attention_counters()
    opt = make_optimizer(warmup_steps=2, total_steps=100)
    t0 = time.perf_counter()
    state, sh = init_sharded_state(cfg, None, opt, seed=0)
    step = make_train_step(cfg, None, opt, sh, remat=remat)  # bf16 compute
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(state.params))
    log(f"train state up ({name}, {n_params / 1e9:.3f} B params, fp32 "
        f"params and Adam state): {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (TRAIN_BATCH, TRAIN_SEQ + 1))
             .astype(np.int32)}
    tokens = TRAIN_BATCH * TRAIN_SEQ

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    losses, aux, step_ms = [], [], []
    for i in range(TRAIN_STEPS):
        t = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(metrics["loss"].item())
        aux.append(metrics["moe_aux_loss"].item())
        log(f"train step {i}: loss {losses[-1]:.6f}, moe_aux_loss "
            f"{aux[-1]:.6f}, grad_norm {metrics['grad_norm'].item():.4f}, "
            f"{step_ms[-1]:.1f} ms")
    launches = {n: c.launches for n, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    timed = sorted(step_ms[TRAIN_UNTIMED:])
    med = timed[len(timed) // 2] if len(timed) % 2 else (
        timed[len(timed) // 2 - 1] + timed[len(timed) // 2]) / 2
    flops = cfg.flops_per_token(TRAIN_SEQ) * tokens
    stats = {"model": name, "layers": cfg.num_layers,
             "attention_impl": cfg.attention_impl, "remat": remat,
             "steps": TRAIN_STEPS, "untimed": TRAIN_UNTIMED,
             "losses": losses, "moe_aux_losses": aux, "step_ms": step_ms,
             "step_ms_median": med, "tokens_per_s": tokens / (med / 1e3),
             "model_flops_per_step": flops,
             "share_of_bf16_peak": flops / (med / 1e3) / PEAK_BF16_FLOPS,
             "peak_mem_gb": peak / 1e9,
             "launches_per_step": {n: c / TRAIN_STEPS
                                   for n, c in launches.items()}}
    log("train " + json.dumps(stats))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[1]:
        raise AssertionError(f"training losses not finite and falling: "
                             f"{losses}")
    want = {n: per_layer.get(n, 0) * cfg.num_layers * TRAIN_STEPS
            for n in counters}
    if launches != want:
        raise AssertionError(f"kernel launches over {TRAIN_STEPS} steps "
                             f"(L = {cfg.num_layers}): {launches}, want "
                             f"{want}")
    return state, step, batch, stats, launches


def train_llama(dev, splash: bool = False):
    """Phase 6 (``splash`` False) and phase 8: the training path at full
    width, with flash attention under full remat, or with splash attention
    under ``remat="save_acts"`` as bench.py's splash arm runs it."""
    from ray_tpu_torch.models import config as mcfg
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.ops import splash_attention as sa

    cfg = mcfg.llama_1b()
    if splash:
        cfg = dataclasses.replace(cfg, attention_impl="splash")
        remat = "save_acts"
        # "save_acts" keeps q, k, v and the attention output, but splash's
        # residuals carry no checkpoint names (the JAX package builds the
        # kernel without residual_checkpoint_name), so lse is not kept and
        # the backward runs B4's forward again: 2 forward launches per
        # layer and step, dq and dk/dv once
        per_layer = {"splash_attention_fwd": 2, "splash_attention_bwd_dq": 1,
                     "splash_attention_bwd_dkv": 1}
        plain = (sa, "splash_attention", plain_splash_attention())
    else:
        remat = True
        per_layer = FLASH_PER_LAYER
        plain = (transformer, "mha", plain_attention())
    state, step, batch, stats, launches = run_training(
        "llama_1b", cfg, remat, per_layer)

    compare_train_step(state, batch, cfg, dev, remat, plain,
                       SPLASH_STEP_LOSS_ATOL if splash else STEP_LOSS_ATOL)
    if not splash:
        time_lm_head_loss(state, cfg, dev)
    profile_step(step, state, batch,
                 "train_step_splash" if splash else "train_step")
    return stats, launches


def trainer_loop(config):
    """``train_llama_1b_tuner``'s loop, run by the ``num_gpus=1`` worker
    (pickled by value: it takes everything from ``config`` and closes over
    nothing of this script).  llama_1b from seed 0 as ``run_training``
    builds it, ``config["steps"]`` steps on the one batch of its dataset
    shard, on the card; each step reports its loss, its ms and the process
    group, the first the batch and the state's build, the last the
    attention kernels' launches, zeroed just before the first step."""
    import hashlib
    import time

    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models import config as mcfg
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import splash_attention as sa
    from ray_tpu_torch.parallel import (init_sharded_state, make_optimizer,
                                        make_train_step)

    entered = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = mcfg.llama_1b()
    opt = make_optimizer(warmup_steps=2, total_steps=100)
    t0 = time.perf_counter()
    state, sh = init_sharded_state(cfg, None, opt, seed=0)
    step = make_train_step(cfg, None, opt, sh, remat=True)
    torch.cuda.synchronize()
    state_s = time.perf_counter() - t0
    batches = list(train.get_dataset_shard("train").iter_torch_batches(
        batch_size=config["rows"], device="cuda"))
    tokens = batches[0]["tokens"]
    counters = {"flash_attention_fwd": fa.flash_attention,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
                "splash_attention_fwd": sa.splash_attention,
                "splash_attention_bwd_dq": sa.splash_attention_bwd_dq,
                "splash_attention_bwd_dkv": sa.splash_attention_bwd_dkv}
    first = {"entered": entered, "trial_entered": config["trial_entered"],
             "state_s": state_s,
             "batches": len(batches), "shape": list(tokens.shape),
             "batch_device": str(tokens.device),
             "tokens_sha256": hashlib.sha256(
                 tokens.cpu().numpy().tobytes()).hexdigest(),
             "card": torch.cuda.get_device_name(dev),
             "mesh": [str(d) for d in
                      train.get_context().mesh().devices.flat]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    for i in range(config["steps"]):
        t = time.perf_counter()
        state, metrics = step(state, batches[0])
        torch.cuda.synchronize()
        row = {"step": i, "step_ms": (time.perf_counter() - t) * 1e3,
               "loss": metrics["loss"].item(),
               "backend": dist.get_backend(),
               "world_size": dist.get_world_size()}
        if i == 0:
            row.update(first)
        if i == config["steps"] - 1:
            row["launches"] = {n: c.launches for n, c in counters.items()}
            row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        train.report(row)


def start_tuner_runtime():
    """The port's runtime for phase ``train_llama_1b_tuner`` (``init``, the
    card auto-detected), started ahead of it with its pool warmed in the
    background (``rl_warm``) over phase ``train_f32_mesh_exactness``,
    which times no kernel: the trial's actor and the trainer's worker, and
    phase darray_collective's block tasks and its rank 0, then take warm
    workers instead of importing torch for 7-13 s each (TUNER_RUNTIME_CPUS
    of them: the pool keeps that many idle).  -> the seconds ``init``
    took."""
    import ray_tpu_torch
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=TUNER_RUNTIME_CPUS,
                       object_store_memory=TUNER_RUNTIME_STORE)
    init_s = time.perf_counter() - t0
    rl_warm(TUNER_RUNTIME_CPUS)
    return init_s


def train_llama_tuner(in_process, runtime):
    """Phase train_llama_1b_tuner: the training path through the tune and
    train libraries, on the runtime ``start_tuner_runtime`` started
    (``runtime``: the seconds ``init`` took and the warm-up's import
    seconds).  It runs ``tune.Tuner`` over a ``TorchTrainer`` with one ``num_gpus=1``
    worker on NCCL, fed by a ``ray_tpu_torch.data`` dataset holding
    ``train_llama_1b``'s batch (8 x 2049 tokens from numpy seed 0): one
    trial (a grid of one ``steps`` value) on a one-CPU lease, whose
    trainable (the trainer's ``as_trainable``) runs ``fit()`` inside the
    trial's actor; the worker leases the card and trains llama_1b uncut
    for TRAINER_STEPS steps (``trainer_loop``), each report reaching the
    trial through ``report_bridge``.  Fails unless the ``ResultGrid``
    holds one TERMINATED trial with no error, its ``metrics_history`` the
    worker's TRAINER_STEPS reports, its ``result.json`` and
    ``progress.csv`` as many rows, ``get_best_result()``'s loss the last
    report's; the group is NCCL of world size 1, the worker got the batch
    on the card, each loss is within STEP_LOSS_ATOL of ``in_process``'s
    (``train_llama_1b``'s stats: the same seed, batch, kernels and card)
    at the same step, B1/B2/B3 launched FLASH_PER_LAYER times per layer
    and step in the worker (B4 not at all).  The runtime stays up for
    phase job_submit, which shuts it down and holds the card's free
    memory to where it stood before this phase (shut down here only when
    the phase fails).  Readings: the trial's ready time (``Tuner.fit()``
    to the trainable's ``fit()``), the worker's (that ``fit()`` to the
    loop's entry), its median step ms beside the in-process one, the
    phase's wall time.  -> (the launches, the card's free bytes before
    the phase)."""
    import csv
    import hashlib
    import os
    import shutil

    import numpy as np
    import torch

    import ray_tpu_torch
    import ray_tpu_torch.data as tdata
    from ray_tpu_torch import tune
    from ray_tpu_torch.models import config as mcfg
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    class StampedTorchTrainer(TorchTrainer):
        """``TorchTrainer`` whose ``fit()`` hands its start time to the
        loop (``trial_entered``): in a trial, the trainable's entry.
        Defined here, so that the trial's actor gets it by value."""

        def fit(self):
            import time
            self.train_loop_config = dict(self.train_loop_config,
                                          trial_entered=time.time())
            return super().fit()

    cfg = mcfg.llama_1b()
    tokens = training_batch(cfg)["tokens"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    free_before, _ = torch.cuda.mem_get_info()
    t_phase = time.perf_counter()
    init_s, warm_s = runtime
    storage = tempfile.mkdtemp(prefix="train_llama_1b_tuner-")
    try:
        try:
            # held until Tuner.fit() returns: its blocks are this
            # process's puts, and they reach the trial inside the pickled
            # trainable (C9)
            ds = tdata.from_items([{"tokens": row} for row in tokens],
                                  parallelism=1)
            trainer = StampedTorchTrainer(
                train_loop_per_worker=trainer_loop,
                train_loop_config={"rows": TRAIN_BATCH,
                                   "steps": TRAINER_STEPS},
                datasets={"train": ds},
                scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                run_config=RunConfig(name="train_llama_1b_trainer",
                                     storage_path=storage))
            tuner = tune.Tuner(
                trainer,
                param_space={"train_loop_config": {
                    "steps": tune.grid_search([TRAINER_STEPS])}},
                tune_config=tune.TuneConfig(metric="loss", mode="min"),
                run_config=RunConfig(name="train_llama_1b_tuner",
                                     storage_path=storage),
                resources_per_trial={"CPU": 1})
            t_fit = time.time()
            grid = tuner.fit()
            fit_s = time.time() - t_fit
            trials = [{"status": t.status, "error": t.error,
                       "rows": t.metrics_history, "dir": t.trial_dir}
                      for t in grid.trials]
            logged = {}
            for t in trials:
                with open(os.path.join(t["dir"], "result.json")) as f:
                    logged["result_json"] = sum(1 for _ in f)
                with open(os.path.join(t["dir"], "progress.csv")) as f:
                    logged["progress_csv"] = len(list(csv.DictReader(f)))
            best = grid.get_best_result() if not grid.errors else None
        except BaseException:
            ray_tpu_torch.shutdown()
            raise
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    wall_s = time.perf_counter() - t_phase

    if (len(trials) != 1 or trials[0]["status"] != "TERMINATED"
            or trials[0]["error"] is not None or best is None):
        raise AssertionError(f"the ResultGrid holds {len(trials)} trials: "
                             f"{[(t['status'], t['error']) for t in trials]}")
    rows = trials[0]["rows"]
    first, last = rows[0], rows[-1]
    step_ms = [r["step_ms"] for r in rows]
    timed = sorted(step_ms[TRAIN_UNTIMED:])
    med = timed[len(timed) // 2] if len(timed) % 2 else (
        timed[len(timed) // 2 - 1] + timed[len(timed) // 2]) / 2
    want_losses = in_process["losses"][:TRAINER_STEPS]
    losses = [r["loss"] for r in rows]
    row = {"init_s": init_s, "warm_import_s": warm_s, "tuner_fit_s": fit_s,
           "trial_ready_s": first["trial_entered"] - t_fit,
           "worker_ready_s": first["entered"] - first["trial_entered"],
           "state_s": first["state_s"], "phase_wall_s": wall_s,
           "trials": len(trials), "status": trials[0]["status"],
           "reports": len(rows), "logged_rows": logged,
           "training_iterations": [r["training_iteration"] for r in rows],
           "best_loss": best.metrics["loss"],
           "backend": sorted({r["backend"] for r in rows}),
           "world_size": sorted({r["world_size"] for r in rows}),
           "card": first["card"], "mesh": first["mesh"],
           "batch": {k: first[k] for k in ("batches", "shape",
                                           "batch_device")},
           "losses": losses, "in_process_losses": want_losses,
           "loss_gaps": [a - b for a, b in zip(losses, want_losses)],
           "step_ms": step_ms, "step_ms_median": med,
           "in_process_step_ms_median": in_process["step_ms_median"],
           "peak_mem_gb": last.get("peak_mem_gb"),
           "launches": last.get("launches"),
           "free_gb_before": free_before / 1e9}
    log("tuner " + json.dumps(row))
    if len(rows) != TRAINER_STEPS or row["training_iterations"] != list(
            range(1, TRAINER_STEPS + 1)):
        raise AssertionError(f"the trial holds {len(rows)} reports of "
                             f"{TRAINER_STEPS}")
    if logged != {"result_json": TRAINER_STEPS,
                  "progress_csv": TRAINER_STEPS}:
        raise AssertionError(f"the trial's logger files hold {logged} rows, "
                             f"not {TRAINER_STEPS}")
    if row["best_loss"] != losses[-1]:
        raise AssertionError(f"get_best_result()'s loss {row['best_loss']} "
                             f"is not the last report's {losses[-1]}")
    if row["backend"] != ["nccl"] or row["world_size"] != [1]:
        raise AssertionError(f"the worker's process group is "
                             f"{row['backend']} of {row['world_size']}")
    want_sha = hashlib.sha256(np.ascontiguousarray(tokens).tobytes())
    if (row["batch"] != {"batches": 1, "shape": [TRAIN_BATCH, TRAIN_SEQ + 1],
                         "batch_device": "cuda:0"}
            or first["tokens_sha256"] != want_sha.hexdigest()):
        raise AssertionError(f"the worker's dataset shard gave "
                             f"{row['batch']}, not train_llama_1b's batch")
    if first["card"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"the worker trained on {first['card']}")
    if not all(abs(g) <= STEP_LOSS_ATOL for g in row["loss_gaps"]):
        raise AssertionError(f"the worker's losses {losses} are not within "
                             f"{STEP_LOSS_ATOL} of train_llama_1b's "
                             f"{want_losses}")
    want = {n: FLASH_PER_LAYER.get(n, 0) * cfg.num_layers * TRAINER_STEPS
            for n in row["launches"]}
    if row["launches"] != want:
        raise AssertionError(f"kernel launches in the worker over "
                             f"{TRAINER_STEPS} steps: {row['launches']}, "
                             f"want {want}")
    return row["launches"], free_before


#: phase job_submit's entrypoint: a driver script that joins the cluster
#: that runs it and runs B1 once in a ``num_gpus=1`` task; argv: the shape
#: "B,S,H,KV,D" and the device
JOB_ENTRY = r'''
import json
import sys
import time

t0 = time.perf_counter()
import ray_tpu_torch

ray_tpu_torch.init(address="auto")
init_s = time.perf_counter() - t0


@ray_tpu_torch.remote(num_gpus=1)
def flash_once(shape, device):
    """B1 once against its plain version, causal, bf16, inputs from a
    generator seeded 0; -> the card, B1's launches in this process, the
    errors and the seconds."""
    import time
    t0 = time.perf_counter()
    import torch
    from ray_tpu_torch.ops import flash_attention as fa
    import_s = time.perf_counter() - t0
    dev = torch.device(device)
    b, s, h, kv, d = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(sh, generator=gen, device=dev,
                           dtype=torch.bfloat16)
               for sh in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    fa.flash_attention.launches = 0
    out, lse = fa._flash_fwd(q, k, v, True)
    launches = fa.flash_attention.launches
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, True)
    return {"card": (torch.cuda.get_device_name(dev)
                     if dev.type == "cuda" else str(dev)),
            "launches": launches,
            "max_abs_err": (out.float() - ref_out.float()).abs().max().item(),
            "lse_max_abs_err": (lse - ref_lse).abs().max().item(),
            "torch_import_s": import_s, "task_s": time.perf_counter() - t0}


t = time.perf_counter()
shape = [int(n) for n in sys.argv[1].split(",")]
row = ray_tpu_torch.get(flash_once.remote(shape, sys.argv[2]), timeout=300)
row.update(shape=shape, init_s=init_s,
           task_wall_s=time.perf_counter() - t)
print("job_submit_task " + json.dumps(row), flush=True)
ray_tpu_torch.shutdown()
'''


def job_submit(free_before):
    """Phase job_submit: a job through the port's CLI on the runtime that
    ``start_tuner_runtime`` started, in this process (the CLI's
    ``_connect()`` returns it).  ``cli.main(["submit", "--", python,
    entry.py, shape, device])`` runs JOB_ENTRY as the job's entrypoint:
    it joins the cluster and runs B1 once in a ``num_gpus=1`` task at
    JOB_SHAPE.  Fails unless the CLI prints the job ``SUCCEEDED``, ``job
    status`` shows exit code 0, ``job logs`` hold the task's line with one
    launch on this card and both errors within OUT_ATOL and LSE_ATOL,
    ``status`` lists the ``GPU`` resource, and after ``shutdown()`` the
    card's free memory is back within 1 GB of ``free_before`` (where it
    stood before ``train_llama_1b_tuner``) in TRAINER_FREE_WAIT_S s.
    Readings: submit to ``SUCCEEDED``, the entrypoint's ``init``, the
    task's seconds (its torch import among them: 0 on a warm worker).
    -> the ``job_submit`` row."""
    import io
    import os
    import re
    import shutil

    import torch

    import ray_tpu_torch
    from ray_tpu_torch.scripts import cli

    def run_cli(*argv):
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                cli.main(list(argv))
        except SystemExit as e:
            raise AssertionError(f"cli {' '.join(argv[:2])} exited {e.code}:"
                                 f"\n{buf.getvalue()[-4000:]}") from None
        return buf.getvalue()

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="job_submit-")
    try:
        try:
            entry = os.path.join(work, "entry.py")
            with open(entry, "w") as f:
                f.write(JOB_ENTRY)
            t = time.perf_counter()
            submitted = run_cli(
                "submit", "--timeout", str(JOB_TIMEOUT_S), "--",
                sys.executable, entry, ",".join(map(str, JOB_SHAPE)),
                JOB_DEVICE)
            submit_s = time.perf_counter() - t
            job_id = re.search(r"^submitted (\S+)$", submitted, re.M)[1]
            info = json.loads(run_cli("job", "status", job_id))
            logs = run_cli("job", "logs", job_id)
            status = run_cli("status")
        finally:
            ray_tpu_torch.shutdown()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    free_after = wait_free_memory(free_before - RUNTIME_FREE_SLACK,
                                  TRAINER_FREE_WAIT_S)
    lines = [ln for ln in logs.splitlines()
             if ln.startswith("job_submit_task ")]
    task = json.loads(lines[0].split(" ", 1)[1]) if lines else {}
    gpus = re.findall(r"^  GPU: (\S+)/(\S+) available$", status, re.M)
    row = {"job_id": job_id, "submit_to_succeeded_s": submit_s,
           "status": info["status"], "exit_code": info["exit_code"],
           "gpu_resource": gpus, **task,
           "phase_wall_s": time.perf_counter() - t_phase,
           "free_gb_before": free_before / 1e9,
           "free_gb_after": free_after / 1e9}
    log("job_submit " + json.dumps(row))
    if not re.search(rf"^job {job_id}: SUCCEEDED$", submitted, re.M):
        raise AssertionError(f"the CLI did not print the job SUCCEEDED:\n"
                             f"{submitted[-4000:]}")
    if info["exit_code"] != 0 or info["status"] != "SUCCEEDED":
        raise AssertionError(f"job status shows {info}")
    if len(lines) != 1:
        raise AssertionError(f"the job's logs hold {len(lines)} task lines:"
                             f"\n{logs[-4000:]}")
    if task["card"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"the job's task ran on {task['card']}")
    if task["launches"] != 1:
        raise AssertionError(f"B1 launched {task['launches']} times in the "
                             f"job's task, want 1")
    if not (task["max_abs_err"] <= OUT_ATOL
            and task["lse_max_abs_err"] <= LSE_ATOL):
        raise AssertionError(
            f"B1 in the job's task disagrees with its plain version: out "
            f"{task['max_abs_err']} (atol {OUT_ATOL}), lse "
            f"{task['lse_max_abs_err']} (atol {LSE_ATOL})")
    if len(gpus) != 1 or float(gpus[0][1]) < 1:
        raise AssertionError(f"status lists no GPU resource:\n{status}")
    if free_after < free_before - RUNTIME_FREE_SLACK:
        raise AssertionError(
            f"the card has {free_after / 1e9:.2f} GB free "
            f"{TRAINER_FREE_WAIT_S} s after shutdown(), "
            f"{free_before / 1e9:.2f} GB before train_llama_1b_tuner")
    return row


def collective_rank():
    """The host group's rank as an actor class (defined here, so that the
    actors get it by value): ``run`` forms the group and runs the
    reference test's sequence (barrier, allreduce, broadcast, allgather,
    send / recv) plus ``reducescatter``, passing each payload as a tensor
    on ``device`` (None: numpy); -> each op's result and seconds."""
    import ray_tpu_torch

    @ray_tpu_torch.remote
    class CollectiveRank:
        def ready(self):
            """-> whether this worker had torch imported (warm)."""
            import sys
            return "torch" in sys.modules

        def run(self, rank, world, name, device):
            import time

            import numpy as np

            from ray_tpu_torch.util import collective as col

            if device is not None:
                import torch

            def give(x):
                return x if device is None else torch.from_numpy(x).to(device)

            g = col.init_collective_group(world, rank, group_name=name)
            out, seconds = {}, {}

            def timed(op, fn):
                t = time.perf_counter()
                out[op] = fn()
                seconds[op] = time.perf_counter() - t

            timed("barrier", g.barrier)
            timed("allreduce",
                  lambda: g.allreduce(give(np.array([1.0 * (rank + 1)]))))
            timed("broadcast", lambda: g.broadcast(
                give(np.array([42.0 + rank])), src_rank=1))
            timed("allgather", lambda: g.allgather(give(np.array([rank]))))
            timed("reducescatter", lambda: g.reducescatter(
                give(np.arange(4, dtype=np.float32) * (rank + 1))))
            if rank == 0:
                timed("send", lambda: g.send(give(np.array([7.0])),
                                             dst_rank=1))
            else:
                timed("recv", lambda: g.recv(src_rank=0))
            values = [x for v in out.values() if v is not None
                      for x in (v if isinstance(v, list) else [v])]
            return {"rank": rank, "seconds": seconds,
                    "gave": ("numpy" if device is None
                             else str(give(np.zeros(1)).device)),
                    "all_numpy": all(isinstance(v, np.ndarray)
                                     for v in values),
                    "results": {k: (None if v is None else
                                    [x.tolist() for x in v]
                                    if isinstance(v, list) else v.tolist())
                                for k, v in out.items()}}

        def destroy(self, name):
            from ray_tpu_torch.util import collective as col
            col.destroy_collective_group(name)

    return CollectiveRank


def darray_collective(dev):
    """Phase darray_collective: ``experimental/darray.py`` and
    ``util/collective.py`` on the runtime ``start_tuner_runtime`` started,
    after ``train_llama_1b_tuner`` (``job_submit`` shuts it down; this
    phase does when it fails).

    1. ``darray.dot`` of two seeded DARRAY_N^2 f32 arrays at
       ``DEFAULT_BLOCK``: one ``num_gpus=1`` task per output block (64),
       each summing 8 block products on the card; the assembled product
       within DARRAY_REL_L2 relative L2 of a float64 numpy product; an
       int64 case (DARRAY_INT_SHAPE) equal bit for bit to the same call
       with ``device="cpu"`` and to numpy's product wrapped to int32.
    2. ``to_torch()`` a tensor on ``dev`` equal bit for bit to
       ``assemble()``; ``to_torch(mesh, PartitionSpec("dp", None))`` on a
       2-entry mesh of ``dev`` two parts of DARRAY_N / 2 rows on it, equal
       to the host slices.
    3. ``mesh_collectives`` on a dp=2, tp=2 mesh of ``dev``: every op and
       keyword of COLLECTIVE_OPS along dp and tp, each result on ``dev``
       and equal bit for bit to the same call on CPU parts.
    4. ``CollectiveGroup`` of two actors: rank 0 on a ``num_gpus=1`` lease
       passing tensors on ``dev``, rank 1 on a CPU passing numpy (rank 0
       made first, while the pool's warm workers are idle); every result
       numpy and equal to numpy's; then ``destroy_collective_group``
       removes the group's state actor.
    Readings: seconds to ``from_numpy``, ``dot`` (submit to every block
    done) and ``assemble``, GFLOP/s, one output block's product run in
    this process (no task: the task's own share), rank 0's ready seconds
    and whether its worker was warm, each group op's seconds, the phase's
    wall time.  -> the row."""
    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.experimental import darray
    from ray_tpu_torch.parallel.mesh import MeshSpec, PartitionSpec
    from ray_tpu_torch.util import collective as col

    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    n = DARRAY_N
    name = "darray_collective"
    actors = []
    try:
        a, b = (rng.standard_normal((n, n), dtype=np.float32)
                for _ in range(2))
        t = time.perf_counter()
        da, db = darray.from_numpy(a), darray.from_numpy(b)
        from_numpy_s = time.perf_counter() - t
        t = time.perf_counter()
        dc = darray.dot(da, db)
        refs = list(dc.blocks.flat)
        ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                      timeout=RUNTIME_WAIT_S)
        dot_s = time.perf_counter() - t
        t = time.perf_counter()
        c = dc.assemble()
        assemble_s = time.perf_counter() - t
        # one output block's product in this process, with no task around
        # it: what of a task's time is the product and its copies
        blocks = ray_tpu_torch.get([da.blocks[0, j] for j in range(
            da.num_blocks[1])] + [db.blocks[i, 0]
                                  for i in range(db.num_blocks[0])])
        block_ms = []
        for _ in range(3):
            t = time.perf_counter()
            darray._k_matmul_sum(*blocks)
            block_ms.append((time.perf_counter() - t) * 1e3)
        del blocks
        want = a.astype(np.float64) @ b.astype(np.float64)
        rel_l2 = float(np.linalg.norm(c - want) / np.linalg.norm(want))

        m, k, p = DARRAY_INT_SHAPE
        ai = rng.integers(-2 ** 20, 2 ** 20, (m, k))
        bi = rng.integers(-2 ** 20, 2 ** 20, (k, p))
        dai, dbi = darray.from_numpy(ai), darray.from_numpy(bi)
        int_card = darray.dot(dai, dbi).assemble()
        int_cpu = darray.dot(dai, dbi, device="cpu").assemble()
        wrapped = (ai @ bi + 2 ** 31) % 2 ** 32 - 2 ** 31

        whole = dc.to_torch()
        whole_ok = whole.device == dev and torch.equal(whole.cpu(),
                                                       torch.from_numpy(c))
        del whole
        mesh2 = MeshSpec(dp=2, fsdp=1).build([dev] * 2)
        sharded = dc.to_torch(mesh2, PartitionSpec("dp", None))
        parts_ok = [part.device == dev and tuple(part.shape) == (n // 2, n)
                    and torch.equal(part.cpu(), torch.from_numpy(
                        c[i * n // 2:(i + 1) * n // 2]))
                    for i, part in enumerate(sharded.parts)]
        del sharded

        spec = MeshSpec(dp=2, fsdp=1, tp=2)
        card_mesh, cpu_mesh = spec.build([dev] * 4), spec.build(["cpu"] * 4)
        host_parts = [torch.from_numpy(x) for x in rng.standard_normal(
            (4, *COLLECTIVE_PART), dtype=np.float32)]
        card_parts = [x.to(dev) for x in host_parts]
        mesh_calls, mesh_differ = 0, []
        t = time.perf_counter()
        for axis in ("dp", "tp"):
            for method, kw in COLLECTIVE_OPS:
                fn = getattr(col.mesh_collectives, method)
                got = fn(card_parts, card_mesh, axis, **kw)
                ref = fn(host_parts, cpu_mesh, axis, **kw)
                mesh_calls += 1
                if not all(g.device == dev and torch.equal(g.cpu(), r)
                           for g, r in zip(got, ref)):
                    mesh_differ.append(f"{method} {kw} along {axis}")
        mesh_s = time.perf_counter() - t
        del card_parts

        # the darray tasks' leases back in the pool first: rank 0 then
        # takes a warm worker (torch imported)
        rl_warm_wait()
        rank_cls = collective_rank()
        t = time.perf_counter()
        actors.append(rank_cls.options(num_gpus=1).remote())
        rank0_warm = ray_tpu_torch.get(actors[0].ready.remote(),
                                       timeout=RUNTIME_WAIT_S)
        rank0_ready_s = time.perf_counter() - t
        actors.append(rank_cls.remote())
        ray_tpu_torch.get(actors[1].ready.remote(), timeout=RUNTIME_WAIT_S)
        t = time.perf_counter()
        ranks = ray_tpu_torch.get(
            [actors[0].run.remote(0, 2, name, str(dev)),
             actors[1].run.remote(1, 2, name, None)],
            timeout=RUNTIME_WAIT_S)
        group_s = time.perf_counter() - t
        ray_tpu_torch.get(actors[0].destroy.remote(name),
                          timeout=RUNTIME_WAIT_S)
        deadline = time.monotonic() + 10
        state_gone = False
        while not state_gone and time.monotonic() < deadline:
            try:
                ray_tpu_torch.get_actor(f"_collective:{name}")
                time.sleep(0.1)
            except ValueError:
                state_gone = True
        for actor in actors:
            ray_tpu_torch.kill(actor)
    except BaseException:
        ray_tpu_torch.shutdown()
        raise

    want_ranks = [
        {"barrier": None, "allreduce": [3.0], "broadcast": [43.0],
         "allgather": [[0], [1]], "reducescatter": [0.0, 3.0],
         "send": None},
        {"barrier": None, "allreduce": [3.0], "broadcast": [43.0],
         "allgather": [[0], [1]], "reducescatter": [6.0, 9.0],
         "recv": [7.0]}]
    row = {"card": card_line(), "n": n, "block": darray.DEFAULT_BLOCK,
           "dot_tasks": len(refs), "from_numpy_s": from_numpy_s,
           "dot_s": dot_s, "assemble_s": assemble_s,
           "dot_gflop_s": 2 * n ** 3 / dot_s / 1e9,
           "dot_ms_per_task": dot_s / len(refs) * 1e3,
           "block_product_in_process_ms": block_ms, "rel_l2": rel_l2,
           "int_shape": list(DARRAY_INT_SHAPE),
           "int_dtype": str(int_card.dtype),
           "to_torch_whole": whole_ok, "to_torch_parts": parts_ok,
           "mesh_calls": mesh_calls, "mesh_differ": mesh_differ,
           "mesh_s": mesh_s, "rank0_ready_s": rank0_ready_s,
           "rank0_warm": rank0_warm,
           "group_s": group_s,
           "group_op_s": {r["rank"]: r["seconds"] for r in ranks},
           "rank0_gave": ranks[0]["gave"], "state_actor_gone": state_gone,
           "phase_wall_s": time.perf_counter() - t_phase}
    log("darray_collective " + json.dumps(row))
    if len(ready) != len(refs):
        raise AssertionError(f"{len(ready)} of {len(refs)} block products "
                             f"done in {RUNTIME_WAIT_S} s")
    if c.dtype != np.float32 or not rel_l2 <= DARRAY_REL_L2:
        raise AssertionError(f"the {n}^2 dot ({c.dtype}) is {rel_l2} "
                             f"relative L2 from float64 (limit "
                             f"{DARRAY_REL_L2})")
    if not (np.array_equal(int_card, int_cpu)
            and np.array_equal(int_card, wrapped)):
        raise AssertionError("the int64 dot on the card differs from the "
                             "CPU tasks' or from numpy's wrapped to int32")
    if not whole_ok or parts_ok != [True, True]:
        raise AssertionError(f"to_torch on {dev}: whole {whole_ok}, "
                             f"mesh parts {parts_ok}")
    if mesh_differ:
        raise AssertionError(f"mesh_collectives on {dev} differ from the "
                             f"CPU: {mesh_differ}")
    if ranks[0]["gave"] != str(dev) or ranks[1]["gave"] != "numpy":
        raise AssertionError(f"the ranks passed {ranks[0]['gave']} and "
                             f"{ranks[1]['gave']}")
    for got, want_rank in zip(ranks, want_ranks):
        if got["results"] != want_rank or not got["all_numpy"]:
            raise AssertionError(f"rank {got['rank']}'s results "
                                 f"{got['results']} (numpy: "
                                 f"{got['all_numpy']}), want {want_rank}")
    if not state_gone:
        raise AssertionError("destroy_collective_group left the group's "
                             "state actor")
    return row


def train_mixtral(dev):
    """Phase train_mixtral_8x7b: Mixtral-8x7B at full width and 1 layer
    (MIXTRAL_TRAIN_LAYERS), flash attention under full remat, as phase 6
    trains llama_1b: B1/B2/B3 launch 2/1/1 a step; the MoE step replays in
    the backward.  The aux loss must be finite and above 0 on every
    step; one step is held against the same step through B1-B3's plain
    versions (``compare_train_step``, B1's routing replayed)."""
    import numpy as np
    from ray_tpu_torch.models import config as mcfg
    from ray_tpu_torch.models import transformer

    cfg = dataclasses.replace(mcfg.mixtral_8x7b(),
                              num_layers=MIXTRAL_TRAIN_LAYERS)
    state, step, batch, stats, launches = run_training(
        "mixtral_8x7b", cfg, True, FLASH_PER_LAYER)
    aux = stats["moe_aux_losses"]
    if not (all(np.isfinite(aux)) and min(aux) > 0):
        raise AssertionError(f"moe_aux_loss not finite and above 0: {aux}")
    compare_train_step(state, batch, cfg, dev, True,
                       (transformer, "mha", plain_attention()),
                       STEP_LOSS_ATOL)
    profile_step(step, state, batch, "train_step_mixtral")
    return stats, launches


def profile_step(step, state, batch, name: str):
    """One step traced (``profile_call``)."""
    def run():
        _, metrics = step(state, batch)
        metrics["loss"].item()
    profile_call(run, name)


def profile_call(fn, name: str):
    """One call of ``fn`` traced: device-busy share, device time by
    category and the kernels that take the most, as a ``time`` line;
    returns (share, device ms).  The profiler slows the host, so the share
    is a floor: an untraced call's time beside the device ms gives the
    share outside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # the quantized collectives' passes are record_function ranges
    # (parallel/quant_collectives.py): on the device timeline each is a
    # span over its kernels, read apart and left out of the kernels' sums
    ranges = {}
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.key in QUANT_RANGES:
            ranges[e.key] = e.device_time_total / 1e3
        else:
            kernels.append(e)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    by_category = {}
    for e in kernels:
        cat = kernel_category(e.key)
        by_category[cat] = (by_category.get(cat, 0.0)
                            + e.self_device_time_total / 1e3)
    log("time " + json.dumps({
        "phase": name, "wall_ms": wall_ms,
        "device_busy_ms_traced": busy, "device_busy_share": busy / wall_ms,
        "by_category_ms": dict(sorted(by_category.items(),
                                      key=lambda kv: -kv[1])),
        "top_kernels_ms": {e.key[:80]: e.self_device_time_total / 1e3
                           for e in top},
        "device_calls": sum(e.count for e in kernels),
        **({"quant_ranges_device_span_ms": ranges} if ranges else {})}))
    return busy / wall_ms, busy


def kernel_category(name: str) -> str:
    """A device kernel's name -> what it does, for the time breakdown."""
    for cat, keys in (
            ("splash_fwd (B4)", ("splash_fwd_kernel",)),
            ("splash_bwd_dq (B4)", ("splash_bwd_dq_kernel",)),
            ("splash_bwd_dkv (B4)", ("splash_bwd_dkv_kernel",)),
            ("flash_fwd (B1)", ("flash_fwd_kernel",)),
            ("flash_bwd_dq (B2)", ("flash_bwd_dq_kernel",)),
            ("flash_bwd_dkv (B3)", ("flash_bwd_dkv_kernel",)),
            ("matmul (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
            ("gather and scatter", ("index", "scatter", "gather")),
            ("sort", ("sort", "radix")),
            ("optimizer (foreach)", ("foreach", "multi_tensor")),
            ("reductions", ("reduce",)),
            ("copies and casts", ("copy",)),
            ("elementwise", ("elementwise",))):
        if any(k in name for k in keys):
            return cat
    return "other"


def compare_train_step(state, batch, cfg, dev, remat, plain_entry,
                       loss_atol):
    """One step's loss and gradients with attention through the kernels,
    against the same step with attention through their plain versions
    (``plain_entry``: the (module, name, function) to patch in).  With MoE,
    bf16 rounding at other tile boundaries flips near-tied router choices,
    and a flip moves a token's MLP output, its gradient to other experts
    and what the capacity drops: the plain run that routes freely is a
    reading (with the share of tokens routed otherwise), and the checked
    one replays the kernels' run's experts, slots and kept flags, its
    weights and aux loss (and their gradients to the router) its own
    (``routing_log``)."""
    import torch
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.parallel.train_step import _leaves

    batch_t = {"tokens": torch.from_numpy(batch["tokens"]).to(dev)}
    leaves = _leaves(state.params)
    moe = cfg.num_experts > 1

    def loss_and_grads(calls, replay=None):
        with routing_log(calls, replay):
            total, metrics = transformer.causal_lm_loss(
                state.params, batch_t, cfg, remat=remat)
            return metrics["loss"].item(), torch.autograd.grad(total, leaves)

    def gaps(loss_a, grads_a, loss_b, grads_b):
        rel = [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
               for a, b in zip(grads_a, grads_b)]
        return {"abs_loss_diff": abs(loss_a - loss_b),
                "max_leaf_rel_l2": max(rel),
                "median_leaf_rel_l2": sorted(rel)[len(rel) // 2],
                "leaves": len(rel)}

    kern_calls = []
    kern_loss, kern = loss_and_grads(kern_calls)
    with patched(*plain_entry):
        if moe:
            free_calls = []
            free_loss, free = loss_and_grads(free_calls)
            log("train_step_vs_plain_free_routing_reading " + json.dumps({
                **gaps(kern_loss, kern, free_loss, free),
                "token_calls_routed_differently": torch.stack(
                    [(a[2].expert != b[2].expert).any(-1).float().mean()
                     for a, b in zip(kern_calls, free_calls)]).tolist()}))
            del free, free_calls
        plain_loss, plain = loss_and_grads([], kern_calls if moe else None)
    row = {"attention_impl": cfg.attention_impl,
           "routing": "replayed from the kernels' run" if moe else None,
           "loss_kernels": kern_loss, "loss_plain_versions": plain_loss,
           **gaps(kern_loss, kern, plain_loss, plain)}
    log("train_step_vs_plain " + json.dumps(row))
    if not (row["abs_loss_diff"] <= loss_atol
            and row["max_leaf_rel_l2"] <= STEP_GRAD_REL_L2):
        raise AssertionError(
            f"training step through the kernels differs from the plain "
            f"versions' by |dloss| {row['abs_loss_diff']} (limit "
            f"{loss_atol}), leaf rel L2 {row['max_leaf_rel_l2']} "
            f"(limit {STEP_GRAD_REL_L2})")
    del kern, plain, kern_calls


def time_lm_head_loss(state, cfg, dev):
    """The loss layer alone: ``chunked_cross_entropy`` (LM head + cross
    entropy, chunks of 512) forward and backward at the training shape,
    beside its four head products' bound at the bf16 peak."""
    import torch
    from ray_tpu_torch.models import transformer

    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.hidden_size), generator=gen,
                    device=dev, dtype=torch.bfloat16).requires_grad_()
    w = transformer.lm_head_weight(state.params, cfg, torch.bfloat16)
    w = w.detach().requires_grad_()
    targets = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                            generator=gen, device=dev)

    def fwd_bwd():
        nll = transformer.chunked_cross_entropy(x, w, targets, 512)
        torch.autograd.grad(nll.mean(), (x, w))

    flops = 4 * 2 * TRAIN_BATCH * TRAIN_SEQ * cfg.hidden_size * cfg.vocab_size
    row = {"ms": time_ms(fwd_bwd, 3, 1),
           "head_products_bound_ms": flops / PEAK_BF16_FLOPS * 1e3}
    log("lm_head_loss " + json.dumps(row))


# ---------------------------------------------------------------------------
# The mesh train step (models/sharding.py, parallel/train_step.py's mesh)
# ---------------------------------------------------------------------------

def mesh_placement(n: int):
    """The devices of an n-shard mesh: one card each with n cards or more,
    else cuda:0 n times (every shard on one card, one after the other:
    times are one card running every shard, not an n-card speed)."""
    import torch
    spread = torch.cuda.device_count() >= n
    devices = [torch.device("cuda", i if spread else 0) for i in range(n)]
    log(f"mesh placement: {n} shards on {sorted({str(d) for d in devices})} "
        + ("(one card each)" if spread else "(every shard on one card: "
           "times are one card running them all, not a multi-card speed)"))
    return devices


def mesh_label(spec) -> str:
    return ",".join(f"{k}={v}" for k, v in spec.items())


def host_tree(tree, device="cpu"):
    """path -> a copy of the whole leaf on ``device``, the host by default
    (a Sharded leaf put together)."""
    from ray_tpu_torch.parallel.mesh import Sharded

    def rec(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from rec(v, f"{prefix}{k}.")
            else:
                yield prefix + k, (v.full(device) if isinstance(v, Sharded)
                                   else v.detach().to(device, copy=True))
    return dict(rec(tree, ""))


def leaf_rel_l2(got, want, dev, base=None):
    """Each leaf's relative L2 distance, computed on the card one leaf at
    a time; with ``base``, that of the changes ``got - base`` and ``want -
    base``."""
    out = {}
    for path, w in want.items():
        a, b = got[path].to(dev).float(), w.to(dev).float()
        if base is not None:
            p0 = base[path].to(dev).float()
            a, b = a - p0, b - p0
            del p0
        out[path] = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
        del a, b
    return out


def training_batch(cfg, seed=0):
    import numpy as np
    return {"tokens": np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(np.int32)}


def one_device_reference(cfg, batch, steps, compute_dtype, remat,
                         calls=None, final=False):
    """``mesh=None`` from seed 0 for ``steps`` steps on ``batch``: each
    step's loss, grad norm and aux loss, the adam mu after the first step
    (the first clipped gradient times 1 - b1), and with ``final`` the last
    state's params, mu and nu, copies on the state's card (the compared
    trees never cross to the host).  With ``calls`` the MoE routing is
    recorded there (``routing_log``)."""
    import torch
    from ray_tpu_torch.parallel import (init_sharded_state, make_optimizer,
                                        make_train_step)
    opt = make_optimizer(warmup_steps=2, total_steps=100)
    state, _ = init_sharded_state(cfg, None, opt, seed=0)
    step = make_train_step(cfg, None, opt, None, compute_dtype=compute_dtype,
                           remat=remat)
    rows, mu0 = [], None
    with (routing_log(calls) if calls is not None
          else contextlib.nullcontext()):
        for i in range(steps):
            state, m = step(state, batch)
            rows.append({k: m[k].item() for k in
                         ("loss", "grad_norm", "moe_aux_loss")})
            if i == 0:
                mu0 = host_tree(state.opt_state["mu"], state.step.device)
    last = ({name: host_tree(tree, state.step.device) for name, tree in
             (("params", state.params), ("mu", state.opt_state["mu"]),
              ("nu", state.opt_state["nu"]))} if final else None)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return rows, mu0, last


def mesh_training(cfg, spec, remat, batch, steps, compute_dtype, per_layer,
                  ref_rows, ref_mu0, replay=None):
    """``init_sharded_state`` / ``make_train_step`` on a mesh of ``spec``
    (seed 0, as the reference), ``steps`` steps on ``batch`` with the
    launch counters zeroed just before and read after.  The first
    ``len(ref_rows)`` losses against the reference's (|d loss| <=
    STEP_LOSS_ATOL; with MESH_COMPARE_STEPS the last of them follows an
    update with a nonzero learning rate) and the adam mu after step 0,
    put back together, leaf by leaf (rel. L2 <= STEP_GRAD_REL_L2); the loss finite and falling; B1-B3 launched
    ``per_layer`` times per layer, step and shard.  With ``replay`` (MoE)
    step 0 routes as the reference's step did; later steps route freely
    and their dropped share is read.  -> (stats, launches, state, step)."""
    import numpy as np
    import torch
    from ray_tpu_torch.parallel import (init_sharded_state, make_optimizer,
                                        make_train_step)
    from ray_tpu_torch.parallel.mesh import MeshSpec

    n = int(np.prod(list(spec.values())))
    devices = mesh_placement(n)
    mesh = MeshSpec(**spec).build(devices)
    counters = attention_counters()
    opt = make_optimizer(warmup_steps=2, total_steps=100)
    base = allocated(devices)
    t0 = time.perf_counter()
    state, sh = init_sharded_state(cfg, mesh, opt, seed=0)
    step = make_train_step(cfg, mesh, opt, sh, compute_dtype=compute_dtype,
                           remat=remat)
    sync_cards()
    init_s = time.perf_counter() - t0
    state_gb = {f"cuda:{i}": (b - base[i]) / 1e9
                for i, b in allocated(devices).items()}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for c in counters.values():
        c.launches = 0
    losses, aux, norms, step_ms, free_calls, gaps = [], [], [], [], [], None
    for i in range(steps):
        calls = []
        route = (routing_log(calls, replay) if replay is not None and i == 0
                 else routing_log(free_calls) if cfg.num_experts > 1
                 else contextlib.nullcontext())
        t = time.perf_counter()
        with route:
            state, m = step(state, batch)
        sync_cards()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(m["loss"].item())
        aux.append(m["moe_aux_loss"].item())
        norms.append(m["grad_norm"].item())
        log(f"mesh step {i} ({mesh_label(spec)}): loss {losses[-1]:.6f}, "
            f"moe_aux_loss {aux[-1]:.6f}, grad_norm {norms[-1]:.4f}, "
            f"{step_ms[-1]:.1f} ms")
        if i == 0:
            rel = leaf_rel_l2(host_tree(state.opt_state["mu"], devices[0]),
                              ref_mu0, devices[0])
            gaps = {"max_leaf_rel_l2_mu_after_step_0": max(rel.values()),
                    "worst_leaf": max(rel, key=rel.get),
                    "leaves": len(rel)}
            reset_peaks(devices)
    launches = {k: c.launches for k, c in counters.items()}
    timed = sorted(step_ms[TRAIN_UNTIMED:])
    med = timed[len(timed) // 2] if len(timed) % 2 else (
        timed[len(timed) // 2 - 1] + timed[len(timed) // 2]) / 2
    loss_diffs = [abs(a - r["loss"]) for a, r in zip(losses, ref_rows)]
    stats = {"layers": cfg.num_layers, "mesh": spec, "shards": n,
             "devices": sorted({str(d) for d in devices}),
             "compute_dtype": str(compute_dtype), "remat": remat,
             "init_s": init_s, "state_gb_by_card": state_gb,
             "losses": losses, "moe_aux_losses": aux, "grad_norms": norms,
             "reference_losses": [r["loss"] for r in ref_rows],
             "abs_loss_diffs": loss_diffs, **gaps, "step_ms": step_ms,
             "step_ms_median": med, "tokens_per_s": tokens / (med / 1e3),
             "peak_gb_by_card": peaks_by_card(devices, base),
             "launches_per_step": {k: v / steps for k, v in launches.items()}}
    if free_calls:
        stats["dropped_share_free_steps"] = sum(
            int(c[1]) for c in free_calls) / sum(2 * c[0] for c in free_calls)
    log("train_mesh " + json.dumps(stats))
    if not (all(np.isfinite(losses)) and losses[-1] < losses[1]):
        raise AssertionError(f"mesh training losses not finite and falling: "
                             f"{losses}")
    if not (max(loss_diffs) <= STEP_LOSS_ATOL
            and gaps["max_leaf_rel_l2_mu_after_step_0"] <= STEP_GRAD_REL_L2):
        raise AssertionError(
            f"mesh step ({mesh_label(spec)}) differs from mesh=None: |dloss| "
            f"{loss_diffs} (limit {STEP_LOSS_ATOL}), mu leaf rel L2 "
            f"{gaps['max_leaf_rel_l2_mu_after_step_0']} (limit "
            f"{STEP_GRAD_REL_L2})")
    want = {k: per_layer.get(k, 0) * cfg.num_layers * n * steps
            for k in counters}
    if launches != want:
        raise AssertionError(f"mesh launches over {steps} steps (L = "
                             f"{cfg.num_layers}, {n} shards): {launches}, "
                             f"want {want}")
    return stats, launches, state, step


def train_llama_mesh(dev):
    """Phase train_llama_1b_mesh: llama_1b at full width and depth (bf16
    compute, fp32 state, full remat) on each mesh of LLAMA_MESHES: every
    shard runs B1 (forward and replay), B2 and B3 on its rows and heads;
    the first MESH_COMPARE_STEPS losses against ``mesh=None`` from the same
    seed and batch."""
    import torch
    from ray_tpu_torch.models import config as mcfg
    cfg = mcfg.llama_1b()
    batch = training_batch(cfg)
    ref_rows, ref_mu0, _ = one_device_reference(
        cfg, batch, MESH_COMPARE_STEPS, torch.bfloat16, True)
    out = {}
    for spec in LLAMA_MESHES:
        stats, launches, state, step = mesh_training(
            cfg, spec, True, batch, MESH_TRAIN_STEPS, torch.bfloat16,
            FLASH_PER_LAYER, ref_rows, ref_mu0)
        out[mesh_label(spec)] = (stats, launches)
        if spec in MESH_TRACED:
            profile_step(step, state, batch,
                         f"train_step_mesh[{mesh_label(spec)}]")
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_f32_exactness(dev):
    """Phase train_f32_mesh_exactness: llama_1b's width in f32 compute
    (plain attention; the ring's recurrence under sp), cut to
    MESH_F32_LAYERS layers for the mesh step on dp=2,fsdp=2,tp=2 and to
    SP_PP_F32_LAYERS and SP_PP_F32_ROWS rows for each run of SP_PP_RUNS
    (the sp step and the pipeline), against ``mesh=None`` on the same
    cut and rows over MESH_F32_STEPS
    steps: loss and grad norm per step, and every leaf of params, mu and
    nu (merged from stages), within MESH_F32_RTOL relative."""
    import torch
    from ray_tpu_torch.models import config as mcfg

    def reference(layers, rows=TRAIN_BATCH):
        cfg = dataclasses.replace(mcfg.llama_1b(), num_layers=layers)
        batch = {k: v[:rows] for k, v in training_batch(cfg).items()}
        return (cfg, batch, *one_device_reference(
            cfg, batch, MESH_F32_STEPS, torch.float32, True, final=True))

    def check(label, stats, state, virtual):
        rel = {}
        for name, tree in (("params", state.params),
                           ("mu", state.opt_state["mu"]),
                           ("nu", state.opt_state["nu"])):
            for path, r in leaf_rel_l2(merged_host_tree(tree, virtual, dev),
                                       ref_last[name], dev).items():
                rel[f"{name}.{path}"] = r
        per_step = [max(abs(a - r["loss"]) / abs(r["loss"]),
                        abs(g - r["grad_norm"]) / r["grad_norm"])
                    for a, g, r in zip(stats["losses"], stats["grad_norms"],
                                       ref_rows)]
        row = {"run": label, "layers": cfg.num_layers,
               "steps": MESH_F32_STEPS,
               "max_rel_loss_or_grad_norm": max(per_step),
               "max_leaf_rel_l2": max(rel.values()),
               "worst_leaf": max(rel, key=rel.get), "leaves": len(rel)}
        log("train_f32_mesh_exactness " + json.dumps(row))
        if not (row["max_rel_loss_or_grad_norm"] <= MESH_F32_RTOL
                and row["max_leaf_rel_l2"] <= MESH_F32_RTOL):
            raise AssertionError(f"f32 step against mesh=None: {row}")

    cfg, batch, ref_rows, ref_mu0, ref_last = reference(MESH_F32_LAYERS)
    spec = LLAMA_MESHES[-1]
    stats, _, state, _ = mesh_training(
        cfg, spec, True, batch, MESH_F32_STEPS, torch.float32, {}, ref_rows,
        ref_mu0)
    check(mesh_label(spec), stats, state, None)
    del state
    cfg, batch, ref_rows, ref_mu0, ref_last = reference(SP_PP_F32_LAYERS,
                                                        SP_PP_F32_ROWS)
    for label, spec, virtual in SP_PP_RUNS:
        stats, _, state, _, _ = sp_pp_training(
            cfg, label, spec, virtual, batch, MESH_F32_STEPS, torch.float32,
            {}, ref_rows, ref_mu0)
        check(label, stats, state, virtual)
        del state
        gc.collect()
        torch.cuda.empty_cache()


def train_mixtral_mesh(dev):
    """Phase train_mixtral_mesh: the 1-layer Mixtral-8x7B cut on
    MIXTRAL_MESH (experts split over ep, everything cut over fsdp; dp
    would hold its 27.4 GB of state twice), full remat.  Step 0 replays
    the routing of ``mesh=None``'s step on the same seed and batch (routing
    is global, so it is the same decision; bf16 rounding flips near ties
    otherwise) and is held to it; the aux loss > 0 every step."""
    import numpy as np
    import torch
    from ray_tpu_torch.models import config as mcfg
    cfg = dataclasses.replace(mcfg.mixtral_8x7b(),
                              num_layers=MIXTRAL_TRAIN_LAYERS)
    batch = training_batch(cfg)
    calls = []
    ref_rows, ref_mu0, _ = one_device_reference(
        cfg, batch, 1, torch.bfloat16, True, calls=calls)
    stats, launches, state, _ = mesh_training(
        cfg, MIXTRAL_MESH, True, batch, TRAIN_STEPS, torch.bfloat16,
        FLASH_PER_LAYER, ref_rows, ref_mu0, replay=calls)
    aux = stats["moe_aux_losses"]
    if not (all(np.isfinite(aux)) and min(aux) > 0):
        raise AssertionError(f"mesh moe_aux_loss not finite and above 0: "
                             f"{aux}")
    del state
    return stats, launches


def checkpoint_roundtrip(dev):
    """Phase checkpoint_roundtrip: llama_1b's width cut to CKPT_LAYERS
    layers, f32 compute, on fsdp=2, tp=2: 4 uninterrupted steps; then 2
    steps, ``save_pytree``, ``load_pytree`` onto ``mesh=None``, 2 more.
    The first two losses equal, the last two within 1e-6 relative (the
    one-device step sums in another order).  Write and read seconds and
    the file's bytes."""
    import os
    import shutil
    import tempfile
    import torch
    from ray_tpu_torch.models import config as mcfg
    from ray_tpu_torch.parallel import (init_sharded_state, make_optimizer,
                                        make_train_step)
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train import load_pytree, save_pytree
    from ray_tpu_torch.train.torch_utils import STATE_FILE

    cfg = dataclasses.replace(mcfg.llama_1b(), num_layers=CKPT_LAYERS)
    batches = [training_batch(cfg, seed) for seed in range(4)]
    spec = dict(fsdp=2, tp=2)
    mesh = MeshSpec(**spec).build(mesh_placement(4))
    opt = make_optimizer(warmup_steps=2, total_steps=100)

    def mesh_state():
        state, sh = init_sharded_state(cfg, mesh, opt, seed=0)
        return state, make_train_step(cfg, mesh, opt, sh,
                                      compute_dtype=torch.float32)

    state, step = mesh_state()
    want = [step(state, b)[1]["loss"].item() for b in batches]
    state, step = mesh_state()
    got = [step(state, b)[1]["loss"].item() for b in batches[:2]]
    where = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        sync_cards()
        t = time.perf_counter()
        save_pytree(where, state)
        write_s = time.perf_counter() - t
        size = os.path.getsize(os.path.join(where, STATE_FILE))
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
        target, _ = init_sharded_state(cfg, None, opt, seed=1)
        t = time.perf_counter()
        state = load_pytree(where, target=target)
        sync_cards()
        read_s = time.perf_counter() - t
        del target
    finally:
        shutil.rmtree(where, ignore_errors=True)
    step = make_train_step(cfg, None, opt, None, compute_dtype=torch.float32)
    got += [step(state, b)[1]["loss"].item() for b in batches[2:]]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    row = {"mesh": spec, "layers": cfg.num_layers, "losses_resumed": got,
           "losses_uninterrupted": want, "rel_diffs": rel,
           "write_s": write_s, "read_s": read_s, "bytes": size,
           "resumed_on": "mesh=None", "step": int(state.step)}
    log("checkpoint_roundtrip " + json.dumps(row))
    if not (got[:2] == want[:2] and max(rel[2:]) <= 1e-6
            and int(state.step) == 4):
        raise AssertionError(f"resumed run differs: {row}")
    del state


# ---------------------------------------------------------------------------
# The dp-manual train step (parallel/zero.py, parallel/quant_collectives.py)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Sequence parallelism and the pipeline (ops/ring_attention.py,
# parallel/pipeline.py)
# ---------------------------------------------------------------------------

def merged_host_tree(tree, virtual, device):
    """``host_tree`` of a staged tree (``virtual`` stages; None: not
    staged) on ``device`` with every block leaf merged back to [L, ...]."""
    from ray_tpu_torch.parallel.pipeline import merge_layers
    host = host_tree(tree, device)
    if virtual is None:
        return host
    return {path: merge_layers({"blocks": {"x": t}}, virtual)["blocks"]["x"]
            if path.startswith("blocks.") else t
            for path, t in host.items()}


def sp_pp_training(cfg, label, spec, virtual, batch, steps, compute_dtype,
                   per_layer, ref_rows, ref_mu0):
    """llama_1b (or its cut) from seed 0 on the mesh ``spec``: through
    ``make_train_step(sp_axis="sp")`` when ``virtual`` is None, else
    through ``init_pp_state`` / ``make_pp_train_step`` with ``virtual``
    stages and PP_MICROBATCHES microbatches; ``steps`` steps on ``batch``
    given pre-shifted (``tokens`` and ``targets``, each dividing by sp),
    the launch counters zeroed just before and read just after.  The
    first ``len(ref_rows)`` losses against ``mesh=None``'s (|d loss| <=
    STEP_LOSS_ATOL) and the adam mu after step 0, put back together (and
    merged from stages), leaf by leaf (rel. L2 <= STEP_GRAD_REL_L2); the
    loss finite and falling; B1-B3 launched ``per_layer`` times per layer
    and step.  -> (stats, launches, state, step, shifted batch)."""
    import numpy as np
    import torch
    from ray_tpu_torch.parallel import (init_pp_state, init_sharded_state,
                                        make_optimizer, make_pp_train_step,
                                        make_train_step)
    from ray_tpu_torch.parallel.mesh import MeshSpec

    n = int(np.prod(list(spec.values())))
    devices = mesh_placement(n)
    mesh = MeshSpec(fsdp=1, **spec).build(devices)
    counters = attention_counters()
    opt = make_optimizer(warmup_steps=2, total_steps=100)
    base = allocated(devices)
    t0 = time.perf_counter()
    if virtual is None:
        state, sh = init_sharded_state(cfg, mesh, opt, seed=0)
        step = make_train_step(cfg, mesh, opt, sh,
                               compute_dtype=compute_dtype, sp_axis="sp",
                               remat=True)
    else:
        state, sh = init_pp_state(cfg, mesh, opt, seed=0,
                                  virtual_stages=virtual)
        step = make_pp_train_step(cfg, mesh, opt, sh,
                                  num_microbatches=PP_MICROBATCHES,
                                  compute_dtype=compute_dtype,
                                  virtual_stages=virtual)
    sync_cards()
    init_s = time.perf_counter() - t0
    state_gb = {f"cuda:{i}": (b - base[i]) / 1e9
                for i, b in allocated(devices).items()}
    shifted = {"tokens": batch["tokens"][:, :-1],
               "targets": batch["tokens"][:, 1:]}
    tokens = shifted["targets"].size
    for c in counters.values():
        c.launches = 0
    losses, norms, step_ms, gaps = [], [], [], None
    for i in range(steps):
        t = time.perf_counter()
        state, m = step(state, shifted)
        sync_cards()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        log(f"{label} step {i}: loss {losses[-1]:.6f}, grad_norm "
            f"{norms[-1]:.4f}, {step_ms[-1]:.1f} ms")
        if i == 0:
            rel = leaf_rel_l2(merged_host_tree(state.opt_state["mu"],
                                               virtual, devices[0]),
                              ref_mu0, devices[0])
            gaps = {"max_leaf_rel_l2_mu_after_step_0": max(rel.values()),
                    "worst_leaf": max(rel, key=rel.get), "leaves": len(rel)}
            reset_peaks(devices)
    launches = {k: c.launches for k, c in counters.items()}
    timed = sorted(step_ms[1:])
    med = timed[len(timed) // 2] if len(timed) % 2 else (
        timed[len(timed) // 2 - 1] + timed[len(timed) // 2]) / 2
    flops = cfg.flops_per_token(TRAIN_SEQ) * tokens
    loss_diffs = [abs(a - r["loss"]) for a, r in zip(losses, ref_rows)]
    stats = {"run": label, "layers": cfg.num_layers, "mesh": spec,
             "virtual_stages": virtual,
             "microbatches": None if virtual is None else PP_MICROBATCHES,
             "shards": n, "devices": sorted({str(d) for d in devices}),
             "compute_dtype": str(compute_dtype), "init_s": init_s,
             "state_gb_by_card": state_gb, "losses": losses,
             "grad_norms": norms,
             "reference_losses": [r["loss"] for r in ref_rows],
             "abs_loss_diffs": loss_diffs, **gaps, "step_ms": step_ms,
             "step_ms_median": med, "tokens_per_s": tokens / (med / 1e3),
             "share_of_bf16_peak": flops / (med / 1e3) / PEAK_BF16_FLOPS,
             "peak_gb_by_card": peaks_by_card(devices, base),
             "launches_per_step": {k: v / steps for k, v in launches.items()}}
    log("train_sp_pp " + json.dumps(stats))
    if not (all(np.isfinite(losses)) and losses[-1] < losses[1]):
        raise AssertionError(f"{label} losses not finite and falling: "
                             f"{losses}")
    if not (max(loss_diffs) <= STEP_LOSS_ATOL
            and gaps["max_leaf_rel_l2_mu_after_step_0"] <= STEP_GRAD_REL_L2):
        raise AssertionError(
            f"{label} step differs from mesh=None: |dloss| {loss_diffs} "
            f"(limit {STEP_LOSS_ATOL}), mu leaf rel L2 "
            f"{gaps['max_leaf_rel_l2_mu_after_step_0']} (limit "
            f"{STEP_GRAD_REL_L2})")
    want = {k: per_layer.get(k, 0) * cfg.num_layers * steps
            for k in counters}
    if launches != want:
        raise AssertionError(f"{label} launches over {steps} steps (L = "
                             f"{cfg.num_layers}): {launches}, want {want}")
    return stats, launches, state, step, shifted


def check_ring(dev):
    """``ring_attention`` on sp=2 at RING_SHAPE in bf16, through B1-B3
    against the same call through their plain versions: out within
    OUT_ATOL, dq, dk and dv within GRAD_RTOL of the plain version's
    largest magnitude, the kernels' run bitwise repeatable; its forward
    and forward + backward timed.  ``ulysses_attention`` against plain
    attention (B1's plain version on the whole sequence), within
    OUT_ATOL."""
    import torch
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import ring_attention as ra
    from ray_tpu_torch.parallel.mesh import MeshSpec

    mesh = MeshSpec(sp=2, fsdp=1).build(mesh_placement(2))
    b, s, h, kv, d = RING_SHAPE
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16).requires_grad_()
               for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    g = torch.randn((b, s, h, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)

    def ring(backward=True):
        out = ra.ring_attention(q, k, v, mesh, "sp")
        if not backward:
            return out
        loss = sum((p.float() * g[sl].to(p.device).float()).sum().to(dev)
                   for p, sl in zip(out.parts, out.sharding.slices(g.shape)))
        return (out.full(dev), *torch.autograd.grad(loss, (q, k, v)))

    got, again = ring(), ring()
    with patched(ra, "_flash_fwd",
                 lambda q, k, v, causal: fa.flash_attention_reference(
                     q, k, v, causal)), \
            patched(ra, "_flash_bwd_stats", fa.flash_bwd_stats_reference):
        want = ring()
    sync_cards()
    row = {"shape": list(RING_SHAPE), "sp": 2,
           "bitwise_repeatable": all(torch.equal(a, b_)
                                     for a, b_ in zip(got, again)),
           "out_max_abs_err": (got[0].float() - want[0].float()).abs()
           .max().item()}
    for name, a, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        row[f"{name}_rel_err"] = ((a.float() - w.float()).abs().max()
                                  / w.float().abs().max()).item()
    row["fwd_ms"] = time_ms(lambda: ring(False), 5)
    row["fwd_bwd_ms"] = time_ms(ring, 3)
    uly = ra.ulysses_attention(q.detach(), k.detach(), v.detach(), mesh,
                               "sp").full(dev)
    plain = fa.flash_attention_reference(q.detach(), k.detach(), v.detach(),
                                         True)[0]
    row["ulysses_out_max_abs_err"] = (uly.float() - plain.float()).abs() \
        .max().item()
    log("ring_attention " + json.dumps(row))
    bad = [n for n in ("dq", "dk", "dv") if not row[f"{n}_rel_err"]
           <= GRAD_RTOL]
    if (bad or not row["bitwise_repeatable"]
            or not row["out_max_abs_err"] <= OUT_ATOL
            or not row["ulysses_out_max_abs_err"] <= OUT_ATOL):
        raise AssertionError(f"ring / ulysses attention through the kernels "
                             f"against their plain versions: {row}")
    del q, k, v, g, got, again, want, uly, plain
    torch.cuda.empty_cache()
    return row


def train_llama_sp_pp(dev):
    """Phase train_llama_1b_sp_pp: the ring alone (``check_ring``), then
    llama_1b at full width and depth (bf16 compute, fp32 state, full remat)
    through each run of SP_PP_RUNS, held to ``mesh=None``'s first
    MESH_COMPARE_STEPS steps from the same seed and batch; one step of each
    profiled."""
    import torch
    from ray_tpu_torch.models import config as mcfg
    cfg = mcfg.llama_1b()
    batch = training_batch(cfg)
    check_ring(dev)
    ref_rows, ref_mu0, _ = one_device_reference(
        cfg, batch, MESH_COMPARE_STEPS, torch.bfloat16, True)
    out = {}
    for label, spec, virtual in SP_PP_RUNS:
        stats, launches, state, step, shifted = sp_pp_training(
            cfg, label, spec, virtual, batch, SP_PP_STEPS, torch.bfloat16,
            SP_PP_PER_LAYER[label], ref_rows, ref_mu0)
        out[label] = (stats, launches)
        profile_step(step, state, shifted, f"train_step[{label}]")
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


def median(values):
    v = sorted(values)
    k = len(v) // 2
    return v[k] if len(v) % 2 else (v[k - 1] + v[k]) / 2


def dp_arm(cfg, mesh, spec, quant, zero, batch, steps, compute_dtype,
           capture=(), capture_device="cpu"):
    """One of bench.py's training arms on ``mesh`` (dp only), built as
    bench.py builds it (``init_zero_state`` for ZeRO, else
    ``init_sharded_state``; ``make_train_step`` with its keywords), seed 0,
    ``steps`` steps on ``batch`` with the launch counters zeroed just
    before and read after.  The state's bytes on each card after init
    (beside what was there before), each step's loss and time, the peak
    per card, and the params put back together on ``capture_device``
    after each step count in ``capture`` (0: as init drew them).  ->
    (stats, launches, state, step, captured)."""
    import torch
    from ray_tpu_torch.parallel import (init_sharded_state, init_zero_state,
                                        make_train_step)
    devices = mesh.device_list
    counters = attention_counters()
    sync_cards()
    before = {i: torch.cuda.memory_allocated(i) for i in cards(devices)}
    t0 = time.perf_counter()
    if zero:
        state, sh = init_zero_state(cfg, mesh, spec)
    else:
        state, sh = init_sharded_state(cfg, mesh, spec.build())
    step = make_train_step(cfg, mesh, spec.build(), sh,
                           compute_dtype=compute_dtype, remat=True,
                           grad_quant_enabled=quant,
                           zero_sharded_update=zero, opt_spec=spec)
    sync_cards()
    init_s = time.perf_counter() - t0
    resident = {f"cuda:{i}": torch.cuda.memory_allocated(i) - before[i]
                for i in cards(devices)}
    reset_peaks(devices)
    for c in counters.values():
        c.launches = 0
    losses, norms, step_ms, captured = [], [], [], {}
    if 0 in capture:
        captured[0] = host_tree(state.params, capture_device)
    for i in range(steps):
        t = time.perf_counter()
        state, m = step(state, batch)
        sync_cards()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        if i + 1 in capture:
            captured[i + 1] = host_tree(state.params, capture_device)
    launches = {k: c.launches for k, c in counters.items()}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    stats = {"layers": cfg.num_layers, "compute_dtype": str(compute_dtype),
             "steps": steps, "init_s": init_s, "losses": losses,
             "grad_norms": norms, "step_ms": step_ms,
             "resident_bytes_by_card": resident,
             "peak_gb_by_card": peaks_by_card(devices),
             "opt_state_bytes": step.opt_state_bytes,
             "collective_bytes": {f"{op}/{dt}": v for (op, dt), v in
                                  step.collective_bytes.items()},
             "launches_per_step": {k: v / steps for k, v in launches.items()}}
    if steps > TRAIN_UNTIMED:
        med = median(step_ms[TRAIN_UNTIMED:])
        flops = cfg.flops_per_token(TRAIN_SEQ) * tokens
        stats.update(step_ms_median=med, tokens_per_s=tokens / (med / 1e3),
                     share_of_bf16_peak=flops / (med / 1e3) / PEAK_BF16_FLOPS)
    return stats, launches, state, step, captured


def free_cards():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def replica_flat_grad(state, cfg, batch, dp, npad):
    """Replica 0's gradient on its rows, flat in the step's order (sorted
    leaves, ``ravel_pytree``'s), zero-padded to ``npad``, on its card."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.parallel.train_step import _leaves, _map
    params = _map(lambda s: s.parts[0], state.params)
    leaves = _leaves(params)
    dev = leaves[0].device
    rows = TRAIN_BATCH // dp
    tokens = torch.from_numpy(batch["tokens"][:rows]).to(dev)
    total, _ = transformer.causal_lm_loss(params, {"tokens": tokens}, cfg,
                                          remat=True)
    grads = torch.autograd.grad(total, leaves)
    flat = torch.cat([g.reshape(-1) for g in grads])
    del grads
    return F.pad(flat, (0, npad - flat.numel()))


def quantize_card_vs_cpu(flat, dp):
    """``quantize_int8_block`` on the card and on the host on the same flat
    gradient, cut [dp, npad/dp] as the reduce-scatter cuts it: the scales
    equal, the int8 payload equal but for one step at x/scale within
    HALF_INT_TOL of a half-integer (counted)."""
    import torch
    from ray_tpu_torch.parallel import quant_collectives as qc
    x = flat.reshape(dp, -1)
    q_card, s_card = qc.quantize_int8_block(x)
    torch.cuda.synchronize()
    x_host = x.cpu()
    q_host, s_host = qc.quantize_int8_block(x_host)
    q_card, s_card = q_card.cpu(), s_card.cpu()
    diff = (q_card.to(torch.int16) - q_host.to(torch.int16)).abs()
    at = diff.nonzero(as_tuple=True)
    y = (x_host.reshape(dp, -1, qc.DEFAULT_BLOCK)
         / s_host[..., None]).reshape(dp, -1)[at].abs()
    off_half = (y - y.floor() - 0.5).abs()
    row = {"elements": x.numel(), "scales_equal": torch.equal(s_card, s_host),
           "int8_flips": int(at[0].numel()),
           "largest_flip": int(diff.max()),
           "flips_off_half_integer": int((off_half > HALF_INT_TOL).sum()),
           "amax": float(x_host.abs().max())}
    log("quantize_card_vs_cpu " + json.dumps(row))
    if not (row["scales_equal"] and row["largest_flip"] <= 1
            and row["flips_off_half_integer"] == 0):
        raise AssertionError(f"quantize on the card differs from the host: "
                             f"{row}")


def dp_f32_exactness(devices):
    """An f32 cut of llama_1b to DP_F32_LAYERS layers at full width on
    dp=2: ZeRO against the default step over DP_F32_STEPS steps (warmup 2,
    so the params move): each step's loss, every param leaf, and the flat
    mu and nu within DP_F32_RTOL relative."""
    import torch
    from ray_tpu_torch.models import config as mcfg
    from ray_tpu_torch.parallel import OptimizerSpec
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.train_step import _leaves
    cfg = dataclasses.replace(mcfg.llama_1b(), num_layers=DP_F32_LAYERS)
    mesh = MeshSpec(dp=DP, fsdp=1).build(devices)
    spec = OptimizerSpec(warmup_steps=2, total_steps=100)
    batch = training_batch(cfg)
    runs = {}
    for name, zero in (("off", False), ("zero", True)):
        stats, _, state, _, _ = dp_arm(cfg, mesh, spec, False, zero, batch,
                                       DP_F32_STEPS, torch.float32)
        moments = {}
        for k in ("mu", "nu"):
            m = state.opt_state[k]
            moments[k] = (m.full("cpu") if zero else torch.cat(
                [leaf.full("cpu").reshape(-1) for leaf in _leaves(m)]))
        runs[name] = (stats["losses"], host_tree(state.params), moments)
        del state
        free_cards()
    (l_off, p_off, m_off), (l_zero, p_zero, m_zero) = runs["off"], runs["zero"]
    rel = leaf_rel_l2(p_zero, p_off, devices[0])
    for k in ("mu", "nu"):
        a, b = m_zero[k][:m_off[k].numel()], m_off[k]
        rel[k] = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    row = {"layers": cfg.num_layers, "steps": DP_F32_STEPS,
           "max_rel_loss": max(abs(a - b) / abs(b)
                               for a, b in zip(l_zero, l_off)),
           "max_leaf_rel_l2": max(rel.values()),
           "worst_leaf": max(rel, key=rel.get), "leaves": len(rel)}
    log("train_f32_dp_exactness " + json.dumps(row))
    if not (row["max_rel_loss"] <= DP_F32_RTOL
            and row["max_leaf_rel_l2"] <= DP_F32_RTOL):
        raise AssertionError(f"f32 ZeRO step against the default step: "
                             f"{row}")


def train_llama_dp(dev):
    """Phase train_llama_1b_dp: bench.py's training arms without splash,
    in its order (off, quant, zero, quant+zero), on llama_1b at full width
    and depth (bf16 compute, fp32 state, full remat) over a dp=2 mesh, as
    bench.py builds them (``OptimizerSpec(total_steps=max(TRAIN_STEPS,
    10))``, ``make_train_step``'s keywords).  zero against off: the first
    MESH_COMPARE_STEPS losses within STEP_LOSS_ATOL and the params' change
    over them within STEP_GRAD_REL_L2 per leaf (the warmup's learning
    rates move the params by about 1e-5 each, so the params themselves
    could not tell a skipped update; off's change one step short is
    printed beside, the reading such a fault gives); quant against off
    within QUANT_STEP_LOSS_ATOL, and a rerun of QUANT_RERUN_STEPS steps
    equal bit for bit; quant+zero within QUANT_ZERO_STEP_LOSS_ATOL.  Every
    arm: the loss finite and falling, B1-B3 launched FLASH_PER_LAYER times
    per layer, step and replica.  The resident state after init against
    the arithmetic (ZeRO holds 2 n 4 (dp - 1) bytes fewer); one step
    profiled per arm; quantization on the card against the host; then the
    f32 2-layer cut (``dp_f32_exactness``)."""
    import numpy as np
    import torch
    from ray_tpu_torch.models import config as mcfg
    from ray_tpu_torch.parallel import OptimizerSpec
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.quant_collectives import DEFAULT_BLOCK
    from ray_tpu_torch.parallel.zero import _padded, _param_count
    cfg = mcfg.llama_1b()
    n = _param_count(cfg, torch.float32)
    devices = mesh_placement(DP)
    mesh = MeshSpec(dp=DP, fsdp=1).build(devices)
    spec = OptimizerSpec(total_steps=max(TRAIN_STEPS, 10))
    batch = training_batch(cfg)
    arms, out = {}, {}
    for name, quant, zero in DP_ARMS:
        steps = DP_ARM_STEPS[name]
        capture = (QUANT_RERUN_STEPS,) if name == "quant" else ()
        stats, launches, state, step, captured = dp_arm(
            cfg, mesh, spec, quant, zero, batch, steps, torch.bfloat16,
            capture)
        log(f"train_dp[{name}] " + json.dumps(stats))
        losses = stats["losses"]
        if not (all(np.isfinite(losses)) and losses[-1] < losses[1]):
            raise AssertionError(f"dp arm {name}: losses not finite and "
                                 f"falling: {losses}")
        want = {k: FLASH_PER_LAYER.get(k, 0) * cfg.num_layers * DP * steps
                for k in launches}
        if launches != want:
            raise AssertionError(f"dp arm {name}: launches over {steps} "
                                 f"steps (L = {cfg.num_layers}, dp {DP}): "
                                 f"{launches}, want {want}")
        profile_step(step, state, batch, f"train_step_dp[{name}]")
        if name == "zero":
            flat = replica_flat_grad(state, cfg, batch, DP,
                                     _padded(n, DP, DEFAULT_BLOCK))
            quantize_card_vs_cpu(flat, DP)
            del flat
        arms[name] = (stats, captured)
        out[name] = (stats, launches)
        del state, step
        free_cards()
    off, _ = arms["off"]
    rows = {}
    for name, limit, k in (("zero", STEP_LOSS_ATOL, MESH_COMPARE_STEPS),
                           ("quant", QUANT_STEP_LOSS_ATOL, None),
                           ("quant+zero", QUANT_ZERO_STEP_LOSS_ATOL, None)):
        got = arms[name][0]["losses"][:k]
        rows[name] = {"abs_loss_diffs": [abs(a - b) for a, b in zip(
            got, off["losses"])], "limit": limit,
            "off_loss_drop": off["losses"][0] - off["losses"][len(got) - 1]}
    # zero's update against off's: the params' change from off's init (both
    # draw seed 0; a zero init that differed would only add to it) over the
    # compared steps, each arm run again for them with its params kept on
    # the card, so that the timed runs' peaks stay their own
    k = MESH_COMPARE_STEPS
    kept = {}
    for name, zero, capture in (("off", False, (0, k - 1, k)),
                                ("zero", True, (k,))):
        _, _, state, step, kept[name] = dp_arm(
            cfg, mesh, spec, False, zero, batch, k, torch.bfloat16, capture,
            devices[0])
        del state, step
        free_cards()
    got, want = kept["zero"], kept["off"]
    rel = leaf_rel_l2(got[k], want[k], dev, base=want[0])
    short = leaf_rel_l2(want[k - 1], want[k], dev, base=want[0])
    del kept, got, want
    free_cards()
    rows["zero"].update(
        max_leaf_rel_l2_param_change=max(rel.values()),
        worst_leaf=max(rel, key=rel.get), leaves=len(rel),
        min_leaf_rel_l2_one_update_short=min(short.values()))
    # the quant arm again from the same seed: the same bits
    stats, _, state, _, captured = dp_arm(
        cfg, mesh, spec, True, False, batch, QUANT_RERUN_STEPS,
        torch.bfloat16, (QUANT_RERUN_STEPS,))
    del state
    free_cards()
    first = arms["quant"][1][QUANT_RERUN_STEPS]
    again = captured[QUANT_RERUN_STEPS]
    rows["quant"]["rerun_losses_equal"] = (
        stats["losses"] == arms["quant"][0]["losses"][:QUANT_RERUN_STEPS])
    rows["quant"]["rerun_params_equal"] = all(
        torch.equal(again[p], first[p]) for p in first)
    # ZeRO's resident state against the arithmetic: the Adam moments split
    # over dp instead of held by every replica
    saved = {c: off["resident_bytes_by_card"][c]
             - arms["zero"][0]["resident_bytes_by_card"][c]
             for c in off["resident_bytes_by_card"]}
    expect = 2 * n * 4 * (DP - 1) / len(saved)
    rows["zero"].update(resident_bytes_saved_by_card=saved,
                        resident_bytes_saved_expected=expect)
    log(f"card: {card_line()}")
    log("train_dp_checks " + json.dumps(rows))
    bad = [name for name, r in rows.items()
           if max(r["abs_loss_diffs"]) > r["limit"]]
    if bad:
        raise AssertionError(f"dp arms' losses off the default step's: "
                             f"{bad}: {rows}")
    if rows["zero"]["max_leaf_rel_l2_param_change"] > STEP_GRAD_REL_L2:
        raise AssertionError(f"zero params off the default step's: {rows}")
    if not (rows["quant"]["rerun_losses_equal"]
            and rows["quant"]["rerun_params_equal"]):
        raise AssertionError(f"quant rerun differs: {rows['quant']}")
    if any(abs(s - expect) > ZERO_STATE_RTOL * expect
           for s in saved.values()):
        raise AssertionError(f"ZeRO's resident state against the "
                             f"arithmetic: {saved}, expect {expect}")
    dp_f32_exactness(devices)
    return out


# ---------------------------------------------------------------------------
# Phase rllib_learners: RLlib's learners (ray_tpu_torch/rllib) on the card
# ---------------------------------------------------------------------------

def timed_calls(fn, n: int) -> float:
    """Median ms of ``n`` calls, each ended by a synchronize (host clock)."""
    import torch
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return median(times)


def rl_rollout(spec, T: int, B: int, seed: int = RL_SEED):
    """A PPO rollout at a runner's layout from a seed: pixel specs get uint8
    frames; logp near the initial policy's (its logits start near 0), so
    the ratios start near 1 and some clip."""
    import numpy as np
    rng = np.random.default_rng(seed)
    A = spec["action_dim"]
    if "obs_shape" in spec:
        obs = rng.integers(0, 256, (T, B) + tuple(spec["obs_shape"]),
                           dtype=np.uint8)
    else:
        obs = rng.standard_normal((T, B, spec["obs_dim"])).astype(np.float32)
    return {"obs": obs,
            "actions": rng.integers(0, A, (T, B)).astype(np.float32),
            "logp": (-np.log(A) + 0.1 * rng.standard_normal((T, B))
                     ).astype(np.float32),
            "values": (0.5 * rng.standard_normal((T, B))).astype(np.float32),
            "rewards": rng.standard_normal((T, B)).astype(np.float32),
            "dones": (rng.random((T, B)) < 0.02).astype(np.float32),
            "last_values": (0.5 * rng.standard_normal(B)).astype(np.float32)}


def rl_compare(name, got, want, base, losses, rtol, failures):
    """The card's state against the CPU's after the same update: every
    leaf's relative L2 and each loss's relative difference within ``rtol``
    (``failures`` collects what is not); the relative L2 of the leaves'
    changes from ``base`` is a reading."""
    leaf, change = {}, {}
    for path, w in host_tree(want).items():
        g = got[path].double()
        w = w.double()
        leaf[path] = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
        if base is not None:
            d = w - base[path].double()
            change[path] = ((g - w).norm() / d.norm().clamp_min(1e-30)).item()
    loss_rel = {k: abs(a - b) / max(abs(b), 1e-30)
                for k, (a, b) in losses.items()}
    if rtol is not None:
        bad = {k: v for k, v in {**leaf, **loss_rel}.items()
               if not v <= rtol}
        if bad:
            failures.append(f"{name}: card against CPU over {rtol}: {bad}")
    worst = max(leaf, key=leaf.get)
    return {"limit": rtol, "max_leaf_rel_l2": leaf[worst],
            "worst_leaf": worst,
            "max_loss_rel": max(loss_rel.values(), default=0.0),
            "losses_card_cpu": losses,
            **({"max_change_rel_l2_reading": max(change.values())}
               if change else {})}


def rl_line(row):
    log("rllib " + json.dumps(row))


def rl_first_step(name, card, cpu, roll, mb, rtol, failures):
    """GAE, then one minibatch's loss, metrics and gradients at the initial
    state (before Adam moves anything), on the card and on the CPU: the
    advantages and every leaf's gradient by relative L2, the losses
    relative, within ``rtol``."""
    import numpy as np
    import torch
    from ray_tpu_torch.rllib.learner import leaves
    rows = np.random.default_rng(RL_SEED).permutation(
        roll["rewards"].size)[:mb]
    got = []
    for lrn in (card.learner, cpu.learner):
        r = {k: torch.from_numpy(v).to(lrn.device) for k, v in roll.items()}
        adv = lrn._gae(r["rewards"], r["values"], r["dones"],
                       r["last_values"])
        flat = {"obs": r["obs"].reshape(-1, *r["obs"].shape[2:]),
                "actions": r["actions"].reshape(-1),
                "logp": r["logp"].reshape(-1),
                "returns": (adv + r["values"]).reshape(-1)}
        a = adv.reshape(-1)
        flat["advantages"] = (a - a.mean()) / (a.std(unbiased=False) + 1e-8)
        idx = torch.from_numpy(rows).to(lrn.device)
        keys = sorted(lrn.params)
        p = {k: lrn.params[k].detach().requires_grad_() for k in keys}
        loss, aux = lrn._loss(p, {k: v[idx] for k, v in flat.items()})
        grads = torch.autograd.grad(loss, [p[k] for k in keys])
        got.append(({"advantages": adv.detach(),
                     **{f"grad.{k}": g for k, g in zip(keys, grads)}},
                    {"loss": loss.item(),
                     **{k: v.item() for k, v in aux.items()}}))
    (tc, lc), (tp, lp) = got
    return rl_compare(f"{name} first step", host_tree(tc), tp, None,
                      {k: (lc[k], lp[k]) for k in lc if k != "kl"}, rtol,
                      failures)


def rl_ppo(name, spec, cfg, shape, dev, rtol, failures, held=True):
    """One PPO learner: GAE and the first minibatch's gradients on the card
    against the CPU (``rl_first_step``); then a whole update on the card
    against the same update on the CPU (same seed: the same params and
    permutations), held to ``rtol`` when ``held``, else a reading beside
    the CPU's disagreement with itself at half its threads; then the
    update timed and profiled.  Returns the card's learner group."""
    import torch
    from ray_tpu_torch.rllib import LearnerGroup, build_model
    T, B = shape
    roll = rl_rollout(spec, T, B)
    mb = T * B // cfg["num_minibatches"]

    def group(device):
        return LearnerGroup(build_model(spec), cfg, seed=RL_SEED,
                            device=device)

    card, cpu = group(None), group("cpu")
    first = rl_first_step(name, card, cpu, roll, mb, rtol, failures)
    base = host_tree(card.learner.params)
    t = time.perf_counter()
    m_card = card.update(roll)
    first_ms = (time.perf_counter() - t) * 1e3
    m_cpu = cpu.update(roll)
    check = rl_compare(name, host_tree(card.learner.params),
                       cpu.learner.params, base,
                       {k: (m_card[k], m_cpu[k])
                        for k in ("policy_loss", "vf_loss", "entropy")},
                       rtol if held else None, failures)
    if not held:
        threads = torch.get_num_threads()
        torch.set_num_threads(max(1, threads // 2))
        try:
            other = group("cpu")
            other.update(roll)
        finally:
            torch.set_num_threads(threads)
        check["cpu_against_cpu_at_half_threads"] = rl_compare(
            f"{name} cpu", host_tree(other.learner.params),
            cpu.learner.params, base, {}, None, failures)
        del other
    ms = timed_calls(lambda: card.update(roll), RL_TIMED["ppo"])
    busy, dev_ms = profile_call(lambda: card.update(roll), f"rllib[{name}]")
    samples = mb * cfg["num_minibatches"] * cfg["num_epochs"]
    rl_line({"learner": name, "model": spec, "rollout": [T, B],
             "update": {k: cfg[k] for k in ("num_epochs", "num_minibatches")},
             "minibatch": mb, "first_update_ms": first_ms,
             "ms_per_update": ms, "samples_per_update": samples,
             "samples_per_s": samples / (ms / 1e3),
             "device_busy_share_traced": busy, "device_ms": dev_ms,
             "device_share_untraced": dev_ms / ms,
             "kl_card_cpu": [m_card["kl"], m_cpu["kl"]],
             "first_step": first, "update_held": held, **check})
    del cpu
    return card


def rl_policy_path(card, spec, dev):
    """A runner's policy step on the card: the conv model's apply,
    sample_action and log_prob on RL_POLICY_BATCH frames (f32, as a runner
    passes them), the results brought to the host."""
    import numpy as np
    import torch
    from ray_tpu_torch.rllib import build_model
    model = build_model(spec)
    params = card.learner.params
    frames = np.random.default_rng(RL_SEED).integers(
        0, 256, (RL_POLICY_BATCH,) + tuple(spec["obs_shape"])
    ).astype(np.float32)
    gen = torch.Generator().manual_seed(RL_SEED)

    @torch.no_grad()
    def step():
        obs = torch.from_numpy(frames).to(dev)
        pi, value = model.apply(params, obs)
        action = model.sample_action(pi, gen)
        logp = model.log_prob(pi, action)
        return action.cpu(), logp.cpu(), value.cpu()

    step()
    ms = timed_calls(step, RL_TIMED["off_policy"])
    rl_line({"learner": "ppo_nature_cnn policy step", "batch":
             RL_POLICY_BATCH, "ms_per_step": ms,
             "frames_per_s": RL_POLICY_BATCH / (ms / 1e3)})


def rl_dp(spec, cfg, shape, dev, failures):
    """LearnerGroup(num_learners=2), both shards on the card, against
    num_learners=1 from the same seed: within RL_DP_RTOL."""
    from ray_tpu_torch.rllib import LearnerGroup, build_model
    T, B = shape
    roll = rl_rollout(spec, T, B, seed=RL_SEED + 1)
    one = LearnerGroup(build_model(spec), cfg, seed=RL_SEED, device=dev)
    two = LearnerGroup(build_model(spec), cfg, num_learners=2,
                       seed=RL_SEED, device=dev)
    base = host_tree(one.learner.params)
    m1, m2 = one.update(roll), two.update(roll)
    check = rl_compare("ppo_mlp dp=2", host_tree(two.learner.params),
                       one.learner.params, base,
                       {k: (m2[k], m1[k])
                        for k in ("policy_loss", "vf_loss", "entropy")},
                       RL_DP_RTOL, failures)
    ms = timed_calls(lambda: two.update(roll), RL_TIMED["ppo"])
    busy, dev_ms = profile_call(lambda: two.update(roll),
                                "rllib[ppo_mlp dp=2]")
    samples = T * B * cfg["num_epochs"]
    rl_line({"learner": "ppo_mlp LearnerGroup(num_learners=2)",
             "devices": [str(d) for d in two.learner.devices],
             "rollout": [T, B], "ms_per_update": ms,
             "samples_per_update": samples,
             "samples_per_s": samples / (ms / 1e3),
             "device_busy_share_traced": busy, "device_ms": dev_ms,
             "device_share_untraced": dev_ms / ms,
             "against": "num_learners=1",
             **check})


def rl_q_batch(n, obs_dim, action_dim, weights, seed=RL_SEED):
    """A replay sample from a seed: n-step discounts (gamma^k, k in 1..3,
    a fifth of them terminal zeros) and, for PER, importance weights."""
    import numpy as np
    rng = np.random.default_rng(seed)
    disc = (0.99 ** rng.integers(1, 4, n)).astype(np.float32)
    disc[rng.random(n) < 0.2] = 0.0
    b = {"obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
         "actions": rng.integers(0, action_dim, n).astype(np.int32),
         "rewards": rng.uniform(-1, 2, n).astype(np.float32),
         "next_obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
         "discounts": disc}
    if weights:
        w = rng.uniform(0.2, 1.0, n).astype(np.float32)
        b["weights"] = w / w.max()
    return b


def rl_sa_batch(n, obs_dim, action_dim, seed=RL_SEED):
    import numpy as np
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (n, action_dim)).astype(np.float32),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "next_obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
            "dones": (rng.random(n) < 0.05).astype(np.float32)}


def rl_on(batch, device):
    import torch
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def rl_off_policy_row(name, step, card, cpu, state_of, batch, shape, dev,
                      rtol, failures):
    """One off-policy learner: ``step(algo, batch)`` (one update, in place,
    returning name -> loss tensor) on the card and on the CPU from the same
    state, batch and draws; then the update timed and profiled."""
    base = host_tree(state_of(card))
    on_card, on_cpu = rl_on(batch, dev), rl_on(batch, "cpu")
    lc, lp = step(card, on_card), step(cpu, on_cpu)
    check = rl_compare(name, host_tree(state_of(card)), state_of(cpu), base,
                       {k: (float(lc[k].double().norm()),
                            float(lp[k].double().norm())) for k in lc},
                       rtol, failures)
    ms = timed_calls(lambda: step(card, on_card), RL_TIMED["off_policy"])
    busy, dev_ms = profile_call(lambda: step(card, on_card),
                                f"rllib[{name}]")
    n = len(batch["rewards"])
    rl_line({"learner": name, "shape": shape, "batch": n,
             "ms_per_update": ms, "samples_per_update": n,
             "samples_per_s": n / (ms / 1e3),
             "device_busy_share_traced": busy, "device_ms": dev_ms,
             "device_share_untraced": dev_ms / ms, **check})


def rl_off_policy(dev, failures):
    """DQN, Rainbow, SAC, TD3 (both do_actor variants) and DDPG, each built
    with ``learner_only`` on the card and on the CPU from seed 0."""
    import torch
    from ray_tpu_torch import rllib

    def q_step(algo, b):
        (algo.params, algo.target_params, algo.opt_state, loss,
         per_sample) = algo._update(algo.params, algo.target_params,
                                    algo.opt_state, b)
        return {"loss": loss, "per_sample_loss": per_sample}

    def q_state(algo):
        return {"params": algo.params, "target": algo.target_params}

    for name, cls, cfg, per in (
            ("dqn", rllib.DQN, rllib.DQNConfig(), False),
            ("rainbow", rllib.Rainbow, rllib.RainbowConfig(), True)):
        cfg.training(batch_size=128)
        card = cls.learner_only(cfg, 4, 2, device=None)
        cpu = cls.learner_only(cfg, 4, 2, device="cpu")
        rl_off_policy_row(
            name, q_step, card, cpu, q_state, rl_q_batch(128, 4, 2, per),
            {**card.model_spec, "per_weights": per,
             "double_q": cfg.train["double_q"]}, dev, RL_LEAF_RTOL,
            failures)

    def sac_step(algo, b):
        (algo.state, algo.opt_state, closs, aloss, alpha) = algo._update(
            algo.state, algo.opt_state, b,
            torch.Generator().manual_seed(RL_SEED))
        return {"critic_loss": closs, "actor_loss": aloss, "alpha": alpha}

    cfg = rllib.SACConfig().training(batch_size=256)
    rl_off_policy_row(
        "sac", sac_step, rllib.SAC.learner_only(cfg, 3, 1, device=None),
        rllib.SAC.learner_only(cfg, 3, 1, device="cpu"),
        lambda a: a.state, rl_sa_batch(256, 3, 1), {"obs": 3, "actions": 1,
                                                    "hidden": [256, 256]},
        dev, RL_LEAF_RTOL, failures)

    for name, cls, cfg_cls, variants in (
            ("td3", rllib.TD3, rllib.TD3Config, (False, True)),
            ("ddpg", rllib.DDPG, rllib.DDPGConfig, (True,))):
        cfg = cfg_cls().training(batch_size=256)
        for do_actor in variants:
            # each variant from seed 0's state on both devices
            card = cls.learner_only(cfg, 3, 1, device=None)
            cpu = cls.learner_only(cfg, 3, 1, device="cpu")
            def td3_step(algo, b, do_actor=do_actor):
                algo.state, algo.opt_state, closs, aloss = algo._update(
                    algo.state, algo.opt_state, b,
                    torch.Generator().manual_seed(RL_SEED), do_actor)
                out = {"critic_loss": closs}
                if do_actor:
                    out["actor_loss"] = aloss
                return out

            rl_off_policy_row(
                f"{name} do_actor={do_actor}", td3_step, card, cpu,
                lambda a: a.state, rl_sa_batch(256, 3, 1),
                {"obs": 3, "actions": 1, "hidden": [256, 256],
                 "twin_q": cfg.train["twin_q"]}, dev, RL_LEAF_RTOL,
                failures)


def rllib_learners(dev):
    """Phase rllib_learners: each learner of ray_tpu_torch/rllib built with
    ``device=None`` (the card) and fed seeded rollouts or replay samples at
    the reference's shapes (the card has no gymnasium, so no env steps):
    updates on the card against the same updates on the CPU, ms per
    update, samples/s and the device-busy share of one profiled update;
    the conv policy's runner step; LearnerGroup's dp=2 against dp=1.  Every
    learner runs before the phase fails on what disagreed.

    The Nature CNN's whole update is a reading, not a check: Adam's first
    step moves every weight by the learning rate in the sign of its
    gradient, and weights whose gradients are within rounding of zero take
    either sign, so 16 steps from one state land a few percent apart even
    on one CPU at two thread counts (printed beside it).  Its GAE and first
    minibatch's gradients, before Adam, are held to RL_CONV_RTOL."""
    import torch
    failures = []
    for name, spec, cfg, shape in RL_PPO:
        conv = "obs_shape" in spec
        card = rl_ppo(name, spec, cfg, shape, None,
                      RL_CONV_RTOL if conv else RL_LEAF_RTOL, failures,
                      held=not conv)
        if conv:
            rl_policy_path(card, spec, dev)
        del card
    rl_off_policy(dev, failures)
    name, spec, cfg, shape = RL_PPO[0]
    rl_dp(spec, cfg, shape, dev, failures)
    torch.cuda.synchronize()
    if failures:
        raise AssertionError("rllib_learners: " + "; ".join(failures))


# ---------------------------------------------------------------------------
# Phase rllib_algorithms: the rest of RLlib's algorithms on the card
# ---------------------------------------------------------------------------

def rl_rel_max(got, want) -> float:
    """max |got - want| over the largest |want| (host tensors)."""
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def rl_held(name, value, limit, failures):
    if not value <= limit:
        failures.append(f"{name}: {value} over {limit}")
    return value


def rl_impala_vtrace(lrn, roll):
    """The learner's V-trace on the fragment under its params, and the
    loss's gradients before any update: (vs, pg_adv, grads, loss, aux)."""
    import torch
    r = {k: torch.from_numpy(v).to(lrn.device) for k, v in roll.items()}
    T, B = r["rewards"].shape
    keys = sorted(lrn.params)
    p = {k: lrn.params[k].detach().requires_grad_() for k in keys}
    with torch.no_grad():
        pi, values = lrn.model.apply(p, r["obs"].reshape(
            (T * B,) + r["obs"].shape[2:]))
        tgt = lrn.model.log_prob(pi, r["actions"].reshape(-1)).reshape(T, B)
        vs, pg_adv, _ = lrn.vtrace(tgt, r["logp"], values.reshape(T, B),
                                   r["rewards"], r["dones"],
                                   r["last_values"])
    loss, aux = lrn._loss(p, r)
    grads = torch.autograd.grad(loss, [p[k] for k in keys])
    return (vs, pg_adv, dict(zip(keys, grads)), loss.item(),
            {k: v.item() for k, v in aux.items()})


def rl_impala(name, spec, appo, shape, dev, failures):
    """One ImpalaLearner on the card against the CPU from seed 0's state
    and one fragment: V-trace, the gradients before Adam, the update
    (held for the MLP; for the Nature CNN a reading, as rllib_learners
    explains); timed and one update profiled."""
    from ray_tpu_torch.rllib import build_model
    from ray_tpu_torch.rllib.impala import ImpalaLearner
    T, B = shape
    cfg = dict(RL_IMPALA_CFG, use_appo_clip=appo)
    conv = "obs_shape" in spec
    roll = rl_rollout(spec, T, B)
    card = ImpalaLearner(build_model(spec), cfg, seed=RL_SEED, device=None)
    cpu = ImpalaLearner(build_model(spec), cfg, seed=RL_SEED, device="cpu")
    (vc, ac, gc_, lc, xc), (vp, ap, gp, lp, xp) = (
        rl_impala_vtrace(card, roll), rl_impala_vtrace(cpu, roll))
    vtrace = {"vs": rl_held(f"{name} vs", rl_rel_max(vc, vp),
                            RL_VTRACE_TOL, failures),
              "pg_adv": rl_held(f"{name} pg_adv", rl_rel_max(ac, ap),
                                RL_VTRACE_TOL, failures)}
    grads = rl_compare(f"{name} gradients", host_tree(gc_), gp, None,
                       {"loss": (lc, lp), **{k: (xc[k], xp[k]) for k in xc}},
                       RL_CONV_RTOL if conv else RL_LEAF_RTOL, failures)
    base = host_tree(card.params)
    m_card, m_cpu = card.update(roll), cpu.update(roll)
    check = rl_compare(name, host_tree(card.params), cpu.params, base,
                       {k: (m_card[k], m_cpu[k]) for k in m_card},
                       None if conv else RL_LEAF_RTOL, failures)
    ms = timed_calls(lambda: card.update(roll), RL_ALGO_TIMED)
    busy, dev_ms = profile_call(lambda: card.update(roll), f"rllib[{name}]")
    rl_line({"learner": name, "model": spec, "fragment": [T, B],
             "appo_clip": appo, "ms_per_update": ms,
             "samples_per_s": T * B / (ms / 1e3),
             "device_busy_share_traced": busy, "device_ms": dev_ms,
             "device_share_untraced": dev_ms / ms,
             "vtrace_rel_max": vtrace, "first_gradients": grads,
             "update_held": not conv, **check})


def rl_impala_dp(dev, failures):
    """ImpalaLearner on a dp mesh of two, both shards on the card (the
    fragment's columns split), against one device."""
    from ray_tpu_torch.rllib import build_model
    from ray_tpu_torch.rllib.impala import ImpalaLearner
    from ray_tpu_torch.rllib.learner import dp_mesh
    name, spec, appo, (T, B) = RL_IMPALA[0]
    cfg = dict(RL_IMPALA_CFG, use_appo_clip=appo)
    roll = rl_rollout(spec, T, B, seed=RL_SEED + 1)
    one = ImpalaLearner(build_model(spec), cfg, seed=RL_SEED, device=dev)
    two = ImpalaLearner(build_model(spec), cfg, seed=RL_SEED,
                        mesh=dp_mesh(2, dev))
    base = host_tree(one.params)
    m1, m2 = one.update(roll), two.update(roll)
    check = rl_compare(f"{name} dp=2", host_tree(two.params), one.params,
                       base, {k: (m2[k], m1[k]) for k in m1}, RL_DP_RTOL,
                       failures)
    ms = timed_calls(lambda: two.update(roll), RL_ALGO_TIMED)
    rl_line({"learner": f"{name} num_devices_per_learner=2",
             "devices": [str(d) for d in two.devices], "fragment": [T, B],
             "ms_per_update": ms, "samples_per_s": T * B / (ms / 1e3),
             "against": "one device", **check})


def rl_corpus(path):
    """A CartPole-shaped corpus from seed 0 (obs 4, actions 0/1 from a
    scripted rule with a fifth flipped, reward 1 a step, episodes of 20 to
    400 steps) through ``write_episodes``, about RL_CORPUS_STEPS
    transitions."""
    import numpy as np
    from ray_tpu_torch.rllib import write_episodes
    rng = np.random.default_rng(RL_SEED)
    episodes, n = [], 0
    while n < RL_CORPUS_STEPS:
        t = int(rng.integers(20, 400))
        obs = (0.5 * rng.standard_normal((t, 4))).astype(np.float32)
        acts = (obs[:, 2] + 0.5 * obs[:, 3] > 0).astype(np.int64)
        flip = rng.random(t) < 0.2
        acts[flip] = 1 - acts[flip]
        episodes.append({"obs": obs, "actions": acts,
                         "rewards": np.ones(t, np.float32)})
        n += t
    write_episodes(path, episodes)
    return n


def rl_offline(dev, failures):
    """BC, MARWIL (beta=1) and CQL from ``learner_only`` on the corpus read
    back by ``from_jsonl``: one train() of RL_OFFLINE_UPDATES updates on
    the card against the CPU (the same numpy draws), then timed."""
    import os
    import tempfile
    from ray_tpu_torch import rllib
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "corpus.jsonl")
        n = rl_corpus(path)
        datasets = {"offline": rllib.OfflineDataset.from_jsonl(path),
                    "transitions": rllib.TransitionDataset.from_jsonl(path)}
    for name, cls, cfg_cls, beta, kind in (
            ("bc", rllib.MARWIL, rllib.BCConfig, 0.0, "offline"),
            ("marwil", rllib.MARWIL, rllib.MARWILConfig, 1.0, "offline"),
            ("cql", rllib.CQL, rllib.CQLConfig, None, "transitions")):
        cfg = cfg_cls().training(updates_per_iter=RL_OFFLINE_UPDATES)
        data = datasets[kind]

        def make(device):
            return cls.learner_only(cfg, 4, 2, device=device, data=data)

        card, cpu = make(None), make("cpu")
        base = host_tree(card.params)
        m_card, m_cpu = card.train(), cpu.train()
        metrics = [k for k in m_card if k not in ("training_iteration",
                                                  "num_transitions")]
        check = rl_compare(name, host_tree(card.params), cpu.params, base,
                           {k: (m_card[k], m_cpu[k]) for k in metrics
                            if m_cpu[k] != 0.0},
                           RL_LEAF_RTOL, failures)
        ms = timed_calls(card.train, RL_ALGO_TIMED)
        bs = min(cfg.cfg["train_batch_size"], len(data))
        rl_line({"learner": name, "corpus_transitions": n,
                 "batch": bs, "beta": beta,
                 "updates_per_train": RL_OFFLINE_UPDATES,
                 "ms_per_train": ms,
                 "ms_per_update": ms / RL_OFFLINE_UPDATES,
                 "samples_per_s": bs * RL_OFFLINE_UPDATES / (ms / 1e3),
                 **check})


def rl_apex(dev, failures):
    """Ape-X's |TD| priorities on the card against the CPU, then one
    update on a shard's sample of the gate's batch (PER weights), the
    priorities pushed back; timed."""
    import numpy as np
    from ray_tpu_torch import rllib
    cfg = rllib.APEXConfig().training(batch_size=RL_APEX_BATCH)
    card = rllib.APEX.learner_only(cfg, 4, 2, device=None)
    cpu = rllib.APEX.learner_only(cfg, 4, 2, device="cpu")
    batch = rl_q_batch(1024, 4, 2, False)
    on_card, on_cpu = card._device_batch(batch), cpu._device_batch(batch)
    tc = card._td_abs(card.params, card.target_params, on_card)
    tp = cpu._td_abs(cpu.params, cpu.target_params, on_cpu)
    td = rl_held("apex td_abs", rl_rel_max(tc, tp), RL_TD_TOL, failures)
    shards = {}
    for algo in (card, cpu):
        # both shards take the host's priorities: the check is the update
        shard = rllib.ReplayShard(4096, cfg.replay["alpha"],
                                  cfg.replay["beta"], seed=RL_SEED)
        shard.add(batch, tp.numpy() + 1e-6)
        shards[id(algo)] = shard

    def step(algo):
        shard = shards[id(algo)]
        picked = shard.sample(cfg.train["batch_size"])
        (algo.params, algo.target_params, algo.opt_state, loss,
         tde) = algo._update(algo.params, algo.target_params,
                             algo.opt_state, algo._device_batch(picked))
        shard.update_priorities(picked["_indices"],
                                tde.abs().cpu().numpy() + 1e-6)
        return loss

    base = host_tree({"params": card.params, "target": card.target_params})
    lc, lp = step(card), step(cpu)
    check = rl_compare("apex", host_tree({"params": card.params,
                                          "target": card.target_params}),
                       {"params": cpu.params, "target": cpu.target_params},
                       base, {"loss": (lc.item(), lp.item())},
                       RL_LEAF_RTOL, failures)
    ms = timed_calls(lambda: step(card), RL_ALGO_TIMED)
    td_ms = timed_calls(lambda: card._td_abs(card.params, card.target_params,
                                             on_card).cpu(), RL_ALGO_TIMED)
    rl_line({"learner": "apex", "batch": cfg.train["batch_size"],
             "double_q": cfg.train["double_q"], "td_abs_rel_max": td,
             "ms_per_update": ms,
             "samples_per_s": cfg.train["batch_size"] / (ms / 1e3),
             "td_abs_ms_1024": td_ms, **check})


def rl_es(dev, failures):
    """One ES and one ARS driver update at the defaults on the card against
    the CPU (theta rel. L2), ESPolicy's forward on a batch and its act on
    single observations; timed."""
    import numpy as np
    import torch
    from ray_tpu_torch import rllib
    for name, cls, cfg in (("es", rllib.ES, rllib.ESConfig()),
                           ("ars", rllib.ARS, rllib.ARSConfig())):
        card = cls.learner_only(cfg, 4, 2, device=None)
        cpu = cls.learner_only(cfg, 4, 2, device="cpu")
        n = cfg.cfg["num_perturbations"]
        seeds = [int(s.generate_state(1)[0])
                 for s in np.random.SeedSequence(RL_SEED).spawn(n)]
        rets = np.random.default_rng(RL_SEED).normal(
            20, 8, (n, 2)).astype(np.float32)
        theta0 = card.theta.copy()
        card.update_from_returns(seeds, rets)
        cpu.update_from_returns(seeds, rets)
        rel = float(np.linalg.norm(card.theta - cpu.theta)
                    / np.linalg.norm(cpu.theta - theta0))
        rl_held(f"{name} theta", rel, RL_ES_RTOL, failures)
        ms = timed_calls(lambda: card.update_from_returns(seeds, rets),
                         RL_ALGO_TIMED)
        obs = np.random.default_rng(RL_SEED).standard_normal(
            (64, 4)).astype(np.float32)
        pc, pp = card._policy, cpu._policy
        fwd = rl_held(f"{name} policy forward", rl_rel_max(
            pc.forward(pc.as_theta(theta0), torch.from_numpy(obs).to(
                pc.device)), pp.forward(pp.as_theta(theta0),
                                        torch.from_numpy(obs))),
            RL_ES_RTOL, failures)
        acts = [(pc.act(theta0, o), pp.act(theta0, o)) for o in obs[:16]]
        if any(a != b for a, b in acts):
            failures.append(f"{name} act: card {acts}")
        theta_card = pc.as_theta(theta0)
        act_ms = timed_calls(lambda: pc.act(theta_card, obs[0]),
                             RL_ALGO_TIMED * 4)
        rl_line({"learner": name, "perturbations": n, "dim": card.dim,
                 "theta_change_rel_l2": rel, "forward_rel_max": fwd,
                 "ms_per_driver_update": ms, "act_ms_one_observation": act_ms,
                 "acts_equal": len(acts)})


def rl_multi_agent(dev, failures):
    """MultiAgentPPO on RockPaperScissors end to end (runners CPU actors of
    the port's runtime, ``rl_runtime``; the updates on the card): three
    iterations with finite losses; the third iteration's updates against a
    CPU learner from the same state, generator and rollout."""
    import math
    import torch
    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib.learner import to_device
    algo = rllib.MultiAgentPPO(
        env_ctor=lambda: rllib.RockPaperScissors(episode_len=8),
        policy_mapping_fn=lambda aid: aid, num_runners=2, rollout_len=48,
        train_config={"lr": 3e-3}, seed=RL_SEED, device=None)
    seen, times, results = {}, [], []
    for pid, lrn in algo.learners.items():
        upd = lrn.update

        def recording(rollout, upd=upd, pid=pid):
            seen[pid] = rollout
            return upd(rollout)
        lrn.update = recording
    cpus = {}
    for it in range(3):
        if it == 2:
            for i, (pid, lrn) in enumerate(algo.learners.items()):
                c = rllib.Learner(rllib.build_model(algo.model_specs[pid]),
                                  lrn.cfg, seed=RL_SEED + i, device="cpu")
                c.params = to_device(lrn.get_weights(), "cpu")
                c.opt_state = {
                    k: [t.to("cpu", copy=True) for t in lrn.opt_state[k]]
                    for k in ("mu", "nu")}
                c.opt_state["count"] = lrn.opt_state["count"]
                c._gen.set_state(lrn._gen.get_state())
                cpus[pid] = c
            base = {pid: host_tree(lrn.params)
                    for pid, lrn in algo.learners.items()}
        t = time.perf_counter()
        results.append(algo.train())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    algo.stop()
    losses = {k: v for k, v in results[-1].items() if k.endswith("_loss")}
    if not (len(losses) == 4
            and all(math.isfinite(r[k]) for r in results for k in losses)):
        failures.append(f"multi_agent losses: {[r for r in results]}")
    checks = {}
    for pid, c in cpus.items():
        m = c.update(seen[pid])
        checks[pid] = rl_compare(
            f"multi_agent {pid}", host_tree(algo.learners[pid].params),
            c.params, base[pid],
            {k: (results[-1][f"{pid}/{k}"], m[k])
             for k in ("policy_loss", "vf_loss", "entropy")},
            RL_LEAF_RTOL, failures)
    steps = 2 * 48 * 2
    rl_line({"algorithm": "multi_agent_ppo", "env": "RockPaperScissors(8)",
             "runners": 2, "rollout_len": 48, "ms_per_iteration": times,
             "agent_steps_per_s": steps / (median(times[1:]) / 1e3),
             "losses": losses, "third_update": checks})


class RlSpace:
    """A gymnasium-free space: ``shape``, and ``n`` when discrete."""

    def __init__(self, shape, n=None):
        self.shape = shape
        if n is not None:
            self.n = n


def rl_external(dev, failures, num_learners=0):
    """PPO in external mode end to end: a numpy simulator with CartPole's
    shapes drives the policy server over localhost through PolicyClient in
    a thread; three iterations of RL_EXTERNAL_T steps.  With
    ``num_learners`` the update runs in that many learner actors on the
    card, and the server's weights must equal the group's after the
    third."""
    import math
    import threading
    import numpy as np
    from ray_tpu_torch import rllib
    config = (rllib.PPOConfig()
              .environment(observation_space=RlSpace((4,)),
                           action_space=RlSpace((), n=2))
              .external(port=0)
              .env_runners(rollout_fragment_length=RL_EXTERNAL_T)
              .learners(num_learners=num_learners)
              .training(num_epochs=2, num_minibatches=2,
                        model={"hidden": (32, 32)}))
    algo = config.build(device=None)
    stop = threading.Event()
    action_ms, errors = [], []

    def simulator():
        rng = np.random.default_rng(RL_SEED)
        client = rllib.PolicyClient(algo.policy_server.address)
        try:
            while not stop.is_set():
                eid = client.start_episode()
                obs = 0.05 * rng.standard_normal(4)
                for t in range(int(rng.integers(10, 200))):
                    if stop.is_set():
                        break
                    t0 = time.perf_counter()
                    a = client.get_action(eid, obs)
                    action_ms.append((time.perf_counter() - t0) * 1e3)
                    obs = obs + 0.1 * (a - 0.5) + 0.02 * rng.standard_normal(4)
                    client.log_returns(eid, 1.0)
                client.end_episode(eid, obs)
        except Exception as e:  # only teardown races are expected
            if not stop.is_set():
                errors.append(repr(e))

    sim = threading.Thread(target=simulator, daemon=True)
    sim.start()
    times, results = [], []
    served = group = None
    try:
        for _ in range(3):
            t = time.perf_counter()
            results.append(algo.train())
            times.append((time.perf_counter() - t) * 1e3)
        served, _ = rllib.PolicyClient(
            algo.policy_server.address).get_weights()
        group = algo.get_weights()
    finally:
        stop.set()
        algo.stop()
        sim.join(timeout=30)
    last = results[-1]
    weights_equal = (served is not None and set(served) == set(group)
                     and all(np.array_equal(served[k], group[k])
                             for k in group))
    ok = (last["training_iteration"] == 3
          and last["num_env_steps_sampled"] == 3 * RL_EXTERNAL_T
          and all(math.isfinite(last[k])
                  for k in ("policy_loss", "vf_loss", "entropy", "kl"))
          and weights_equal and not errors and not sim.is_alive())
    if not ok:
        failures.append(f"external ppo (num_learners={num_learners}): "
                        f"{last}, errors {errors}, server weights equal "
                        f"{weights_equal}, simulator alive "
                        f"{sim.is_alive()}")
    rl_line({"algorithm": "ppo external", "num_learners": num_learners,
             "server_weights_equal": weights_equal,
             "fragment": RL_EXTERNAL_T,
             "ms_per_iteration": times,
             "get_action_ms_median": median(action_ms),
             "get_action_calls": len(action_ms),
             "env_steps_per_s": RL_EXTERNAL_T / (median(times) / 1e3),
             "policy_loss": last["policy_loss"],
             "num_env_steps_sampled": last["num_env_steps_sampled"]})


def rl_warm_task(hold_s):
    """In a worker of the runtime: import torch and ray_tpu_torch.rllib (no
    CUDA), then hold the worker until ``hold_s`` after the start, so that
    the warm-up tasks in flight each take a worker of their own.  -> the
    import's seconds (0 in a worker that had them)."""
    t0 = time.perf_counter()
    import ray_tpu_torch.rllib  # noqa: F401
    took = time.perf_counter() - t0
    time.sleep(max(0.0, hold_s - (time.perf_counter() - t0)))
    return took


_RL_WARM = []


def rl_warm(n):
    """Warm ``n`` of the runtime's workers in the background: a worker
    process can spend 7-13 s importing torch on an H100's machine (the
    ``warm_import_s`` readings), and an actor lease takes an idle worker
    before it spawns one, so an actor placed on a warm worker starts
    without that import.  The pool keeps as many idle workers as the
    runtime has CPUs."""
    import ray_tpu_torch
    task = ray_tpu_torch.remote(rl_warm_task).options(num_cpus=1)
    _RL_WARM.extend(task.remote(RL_WARM_HOLD_S) for _ in range(n))


def rl_warm_wait():
    """Wait for the warm-up tasks in flight and for their workers to be
    back in the pool (a finished task's lease returns after 2 s); -> the
    import seconds each task took."""
    import ray_tpu_torch
    took = ray_tpu_torch.get(list(_RL_WARM), timeout=RUNTIME_WAIT_S)
    _RL_WARM.clear()
    cpus = ray_tpu_torch.cluster_resources().get("CPU", 0)
    deadline = time.monotonic() + 10
    while (ray_tpu_torch.available_resources().get("CPU", 0) < cpus
           and time.monotonic() < deadline):
        time.sleep(0.1)
    return took


def rl_runtime():
    """The port's runtime for the RL phases, started once (the card
    counted as a ``GPU``), its whole pool warmed at once; -> the seconds
    ``init`` took (0 when it was up)."""
    import ray_tpu_torch
    if ray_tpu_torch.is_initialized():
        return 0.0
    t = time.perf_counter()
    ray_tpu_torch.init(num_cpus=RL_RUNTIME_CPUS,
                       object_store_memory=RL_RUNTIME_STORE)
    init_s = time.perf_counter() - t
    rl_warm(RL_RUNTIME_CPUS)
    return init_s


def rllib_algorithms(dev):
    """Phase rllib_algorithms: the rest of ray_tpu_torch/rllib built with
    ``device=None`` (the card), f32 with TF32 off, inputs from seed 0 at
    the reference's shapes (the card has no gymnasium): IMPALA and APPO
    (one update card against CPU, V-trace, dp=2), BC / MARWIL / CQL (one
    train() from a corpus through write_episodes and from_jsonl), Ape-X
    (|TD| and one update), ES and ARS (one driver update, the policy),
    multi-agent PPO and PPO's external mode end to end.  Every part runs
    before the phase fails on what disagreed.  It starts the RL phases'
    runtime (``rl_runtime``), whose workers warm while the card works, and
    leaves it up for ``rllib_learner_actors``."""
    import torch
    failures = []
    log(f"rllib_algorithms card: {card_line()}")
    init_s = rl_runtime()
    for name, spec, appo, shape in RL_IMPALA:
        rl_impala(name, spec, appo, shape, dev, failures)
    rl_impala_dp(dev, failures)
    rl_offline(dev, failures)
    rl_apex(dev, failures)
    rl_es(dev, failures)
    rl_line({"runtime_init_s": init_s, "warm_import_s": rl_warm_wait()})
    rl_multi_agent(dev, failures)
    rl_warm(2)   # for the next phase, while external PPO runs
    rl_external(dev, failures)
    torch.cuda.synchronize()
    if failures:
        raise AssertionError("rllib_algorithms: " + "; ".join(failures))


# ---------------------------------------------------------------------------
# Phase rllib_learner_actors: RLlib's learner and replay actors on the runtime
# ---------------------------------------------------------------------------

def rl_group_update(name, spec, cfg, roll, learner_cls, failures):
    """One ``DistributedLearnerGroup(num_learners=1, device=None)`` update
    against the same update of the in-process learner on the card from
    the same seed, held to RL_LEAF_RTOL; the worker's lease, backend and
    ready time.  -> the group (still up) and its row."""
    import numpy as np
    import torch
    from ray_tpu_torch.rllib import DistributedLearnerGroup, build_model
    t = time.perf_counter()
    group = DistributedLearnerGroup(spec, cfg, num_learners=1, seed=RL_SEED,
                                    learner_cls=learner_cls, device=None)
    ready_s = time.perf_counter() - t
    info = group.info
    if not (info["backend"] == "nccl" and info["num_processes"] == 1
            and info["gpus"] == 1 and info["devices"] == ["cuda:0"]):
        failures.append(f"{name}: the learner actor is {info}, not one "
                        f"NCCL rank on a GPU lease")
    local = learner_cls(build_model(spec), cfg, seed=RL_SEED, device=None)
    base = host_tree(local.params)
    m_local = local.update(roll)
    m_group = group.update(roll)
    got = {k: torch.tensor(v) for k, v in group.get_weights().items()}
    # PPO's kl is near 0, so its relative difference is no measure
    check = rl_compare(f"{name} learner actor", got, local.params, base,
                       {k: (m_group[k], m_local[k]) for k in m_local
                        if k != "kl"}, RL_LEAF_RTOL, failures)
    want = host_tree(local.params)
    check["max_leaf_abs_diff"] = max(
        (got[k] - want[k]).abs().max().item() for k in want)
    row = {"learner_actor": name, "model": spec,
           "rollout": list(np.asarray(roll["rewards"]).shape),
           "ready_s": ready_s, "info": info,
           "against": "the in-process learner on the card", **check}
    return group, local, row


def rl_replay_shard_actors(failures):
    """Ape-X's ReplayShard as 2 actors against 2 in-process shards of the
    same seeds: the same transitions with the same |TD| priorities, then
    ``sample``, ``update_priorities`` and ``sample`` again; the sampled
    indices and weights equal."""
    import numpy as np
    import ray_tpu_torch
    from ray_tpu_torch import rllib
    cfg = rllib.APEXConfig().replay
    shard_cls = ray_tpu_torch.remote(rllib.ReplayShard)
    actors = [shard_cls.options(num_cpus=0.5).remote(
        RL_SHARD_CAPACITY, cfg["alpha"], cfg["beta"], seed=RL_SEED + i)
        for i in range(2)]
    local = [rllib.ReplayShard(RL_SHARD_CAPACITY, cfg["alpha"], cfg["beta"],
                               seed=RL_SEED + i) for i in range(2)]
    rng = np.random.default_rng(RL_SEED)
    equal = []
    try:
        for i, (a, s) in enumerate(zip(actors, local)):
            batch = rl_q_batch(1024, 4, 2, False, seed=RL_SEED + i)
            prios = rng.uniform(0.01, 2.0, 1024).astype(np.float32)
            sizes = (ray_tpu_torch.get(a.add.remote(batch, prios),
                                       timeout=60), s.add(batch, prios))
            first = (ray_tpu_torch.get(a.sample.remote(RL_APEX_BATCH),
                                       timeout=60),
                     s.sample(RL_APEX_BATCH))
            td = rng.uniform(0.01, 2.0, RL_APEX_BATCH).astype(np.float32)
            ray_tpu_torch.get(a.update_priorities.remote(
                first[1]["_indices"], td), timeout=60)
            s.update_priorities(first[1]["_indices"], td)
            second = (ray_tpu_torch.get(a.sample.remote(RL_APEX_BATCH),
                                        timeout=60),
                      s.sample(RL_APEX_BATCH))
            equal.append(sizes[0] == sizes[1] and all(
                np.array_equal(got[k], want[k])
                for got, want in (first, second)
                for k in ("_indices", "_weights")))
    finally:
        for a in actors:
            ray_tpu_torch.kill(a)
    if not all(equal):
        failures.append(f"replay shard actors against in-process: {equal}")
    return {"replay_shards": 2, "equal": equal}


def rllib_learner_actors(dev):
    """Phase rllib_learner_actors: RLlib on the port's runtime with the
    card auto-detected (see the module docstring, 12.), the runtime
    ``rllib_algorithms`` left up (or a new one).  Each actor starts on a
    worker warmed in the background (``rl_warm``), so the ready times
    exclude the worker's torch import, printed apart.  Every part runs
    before the phase fails on what disagreed; then ``shutdown()``."""
    import numpy as np
    import torch
    import ray_tpu_torch
    from ray_tpu_torch.rllib import (DistributedLearnerGroup, LearnerGroup,
                                     build_model)
    from ray_tpu_torch.rllib.impala import ImpalaLearner
    from ray_tpu_torch.rllib.learner import Learner
    failures = []
    log(f"rllib_learner_actors card: {card_line()}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    free_before, _ = torch.cuda.mem_get_info()
    init_s = rl_runtime()
    try:
        warm_s = rl_warm_wait()
        gpus = ray_tpu_torch.cluster_resources().get("GPU")
        if gpus != torch.cuda.device_count():
            failures.append(f"the runtime counts {gpus} GPUs")
        # (a) PPO's MLP, (b) IMPALA's MLP: the actor against in-process
        name, spec, cfg, (T, B) = RL_PPO[0]
        group, _, row = rl_group_update(name, spec, cfg,
                                        rl_rollout(spec, T, B), Learner,
                                        failures)
        group.shutdown()
        rl_line({**row, "init_s": init_s, "warm_import_s": warm_s})
        name, spec, appo, (T, B) = RL_IMPALA[0]
        group, _, row = rl_group_update(
            name, spec, dict(RL_IMPALA_CFG, use_appo_clip=appo),
            rl_rollout(spec, T, B), ImpalaLearner, failures)
        group.shutdown()
        rl_line(row)
        # (c) the Nature CNN through the actor: a reading beside the
        # in-process update on the card (both under torch's default
        # precision flags, which the actor's process keeps)
        name, spec, cfg, (T, B) = RL_PPO[1]
        roll = rl_rollout(spec, T, B)
        roll["obs"] = roll["obs"].astype(np.float32)   # a runner's layout
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            t = time.perf_counter()
            group = DistributedLearnerGroup(spec, cfg, num_learners=1,
                                            seed=RL_SEED, device=None)
            ready_s = time.perf_counter() - t
            # warm three workers for (d) and (e) meanwhile
            rl_warm(RL_RUNTIME_CPUS - 1)
            local = LearnerGroup(build_model(spec), cfg, seed=RL_SEED,
                                 device=None)
            group.update(roll)
            local.update(roll)
            actor_ms = timed_calls(lambda: group.update(roll),
                                   RL_TIMED["ppo"])
            local_ms = timed_calls(lambda: local.update(roll),
                                   RL_TIMED["ppo"])
            group.shutdown()
            del local
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        rl_line({"learner_actor": name, "model": spec, "rollout": [T, B],
                 "rollout_bytes": int(sum(v.nbytes for v in roll.values())),
                 "ready_s": ready_s, "ms_per_update_actor": actor_ms,
                 "ms_per_update_in_process": local_ms,
                 "actor_over_in_process": actor_ms / local_ms,
                 "calls_timed": RL_TIMED["ppo"]})
        del roll
        warm_s = rl_warm_wait()
        # (d) PPO's external mode with its update in a learner actor
        rl_external(dev, failures, num_learners=1)
        # (e) Ape-X's replay shards as actors
        rl_line({**rl_replay_shard_actors(failures), "warm_import_s": warm_s})
    finally:
        ray_tpu_torch.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    free_after = wait_free_memory(free_before - RUNTIME_FREE_SLACK,
                                  RL_FREE_WAIT_S)
    rl_line({"learner_actors_memory": {"free_gb_before": free_before / 1e9,
                                       "free_gb_after": free_after / 1e9}})
    if free_after < free_before - RUNTIME_FREE_SLACK:
        failures.append(f"the card's free memory {free_after / 1e9:.2f} GB "
                        f"after shutdown(), {free_before / 1e9:.2f} before")
    if failures:
        raise AssertionError("rllib_learner_actors: " + "; ".join(failures))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    if not (ROOT / "ray_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the ray_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    card = card_line()
    clock_hz = max_sm_clock_hz()
    log(f"card: {card}; max SM clock {clock_hz / 1e6:.0f} MHz")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: off for float32 matmuls and cuDNN convolutions")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    from ray_tpu_torch.ops import _build
    # the deployment phase's runtime: its workers import torch while nvcc
    # builds
    serve_runtime = start_serve_runtime()
    with phase("build"):
        built = _build.build()
        log(f"build: {json.dumps(built)}")
        for name, text in _build.build_logs.items():
            for line in text.splitlines():
                if ("registers" in line or "spill" in line or "error" in line
                        or "entry function" in line or "(C75" in line):
                    log(f"  nvcc[{name}] {line.strip()}")
        # every kernel's warp specialisation rests on setmaxnreg, which
        # ptxas drops with warning C7508 when the roles reconverge
        dropped = [name for name, text in _build.build_logs.items()
                   if "C7508" in text]
        if dropped:
            raise AssertionError(f"ptxas ignored setmaxnreg in {dropped} "
                                 f"(C7508)")
    # the imports end before any kernel is timed: a build already in
    # _build/ takes no time, and the imports would then slow the timed
    # kernel rows
    with phase("serve_runtime_warm"):
        serve_runtime += (rl_warm_wait(),)

    with phase("flash_forward_kernel"):
        flash_rows = check_flash(dev)
    with phase("flash_backward_kernels"):
        bwd_rows = check_flash_bwd(dev)
    from ray_tpu_torch.models import config as mcfg
    serve_cfg = mcfg.llama3_8b()
    serve_params = serving_params("llama3_8b", serve_cfg, dev)
    with phase("serve_llama3_8b"):
        serve_stats, serve_launches, serve_outs = serve_llama(
            dev, serve_cfg, serve_params)
    with phase("serve_llama3_8b_deployment"):
        deploy_row = serve_llama_deployment(dev, serve_cfg,
                                            serving_prompts(serve_cfg),
                                            serve_stats, serve_outs,
                                            serve_runtime)
    with phase("serve_llama3_8b_paged"):
        serve_llama_paged(dev, serve_cfg, serve_params)
    with phase("serve_llama3_8b_paged_prefix"):
        serve_llama_paged_prefix(dev, serve_cfg, serve_params)
    with phase("serve_llama3_8b_paged_spec"):
        _, spec_launches = serve_llama_paged_spec(dev, serve_cfg,
                                                  serve_params)
    tp_devices = tp_placement()
    tp_cfg, tp_params = layer_cut(serve_cfg, serve_params, TP_SERVE_LAYERS)
    with phase("serve_llama3_8b_tp2"):
        _, tp_launches = serve_llama_tp(dev, tp_cfg, tp_params, tp_devices)
    del serve_params, tp_params
    gc.collect()
    torch.cuda.empty_cache()
    with phase("serve_f32_spec_exactness"):
        spec_exact_f32(dev)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("serve_f32_tp_exactness"):
        tp_exact_f32(dev, tp_devices)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("moe_layer"):
        check_moe(dev)
    gc.collect()
    torch.cuda.empty_cache()
    mixtral_cfg = dataclasses.replace(mcfg.mixtral_8x7b(),
                                      num_layers=MIXTRAL_SERVE_LAYERS)
    mixtral_params = serving_params(
        f"mixtral_8x7b ({MIXTRAL_SERVE_LAYERS} of 32 layers)", mixtral_cfg,
        dev)
    with phase("serve_mixtral_8x7b"):
        mixtral_serve, _ = serve_mixtral(dev, mixtral_cfg, mixtral_params)
    del mixtral_params
    gc.collect()
    torch.cuda.empty_cache()
    mixtral_tp_cfg = dataclasses.replace(mcfg.mixtral_8x7b(),
                                         num_layers=MIXTRAL_TP_LAYERS)
    mixtral_tp_params = serving_params(
        f"mixtral_8x7b ({MIXTRAL_TP_LAYERS} of 32 layers)", mixtral_tp_cfg,
        dev)
    with phase("serve_mixtral_8x7b_tp2"):
        mixtral_tp = serve_mixtral_tp(dev, mixtral_tp_cfg, mixtral_tp_params,
                                      tp_devices)
    del mixtral_tp_params
    gc.collect()
    torch.cuda.empty_cache()
    with phase("train_mixtral_8x7b"):
        _, mixtral_train = train_mixtral(dev)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("train_llama_1b"):
        train_stats, train_launches = train_llama(dev)
    with phase("splash_kernels"):
        splash_rows = check_splash(dev, clock_hz)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("train_llama_1b_splash"):
        _, splash_launches = train_llama(dev, splash=True)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("train_llama_1b_mesh"):
        llama_mesh = train_llama_mesh(dev)
    gc.collect()
    torch.cuda.empty_cache()
    # the tuner phase's runtime: its workers import torch while the f32
    # exactness phase runs, which times no kernel
    tuner_runtime = start_tuner_runtime()
    with phase("train_f32_mesh_exactness"):
        mesh_f32_exactness(dev)
    with phase("tuner_runtime_warm"):
        tuner_runtime = (tuner_runtime, rl_warm_wait())
    with phase("train_llama_1b_tuner"):
        tuner_launches, tuner_free = train_llama_tuner(train_stats,
                                                       tuner_runtime)
    with phase("darray_collective"):
        darray_collective(dev)
    with phase("job_submit"):
        job_row = job_submit(tuner_free)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("train_mixtral_mesh"):
        _, mixtral_mesh = train_mixtral_mesh(dev)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("checkpoint_roundtrip"):
        checkpoint_roundtrip(dev)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("train_llama_1b_dp"):
        llama_dp = train_llama_dp(dev)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("train_llama_1b_sp_pp"):
        sp_pp = train_llama_sp_pp(dev)
    free_cards()
    with phase("rllib_learners"):
        rllib_learners(dev)
    with phase("rllib_algorithms"):
        rllib_algorithms(dev)
    with phase("rllib_learner_actors"):
        rllib_learner_actors(dev)
    mesh_launches = {f"train_mesh[{label}]": launches
                     for label, (_, launches) in llama_mesh.items()}
    mesh_launches[f"train_mixtral_mesh[{mesh_label(MIXTRAL_MESH)}]"] = (
        mixtral_mesh)
    mesh_launches.update({f"train_dp[{name}]": launches
                          for name, (_, launches) in llama_dp.items()})
    mesh_launches.update({f"train_sp_pp[{label}]": launches
                          for label, (_, launches) in sp_pp.items()})

    main_row, bwd_row = flash_rows[0], bwd_rows[0]
    shard_row = next(r for r in flash_rows
                     if r["shape"] == [8, 2048, 16, 4, 128])
    sdpa_covers = "dq, dk and dv in one call: B2 + B3 together"

    def shard_rows(rows, keys):
        """The mesh shard shapes' rows of a kernel phase, by mesh."""
        at = {(tuple(r["shape"]), r["causal"]): r for r in rows}
        return {label: {"shape": list(c[:5]), "causal": c[5],
                        **{k: at[tuple(c[:5]), c[5]][key] for k, key in keys}}
                for label, c in zip(MESH_SHARD_LABELS, MESH_SHARD_CASES)}

    def bwd_keys(name):
        return [(k, f"{name}_{k}") for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by")] + [
            ("library_ms", "sdpa_bwd_ms"),
            ("max_abs_err", f"{name}_max_abs_err")]
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:42",
        "design": HOPPER_DESIGN,
        "launches": (serve_launches + deploy_row["flash_launches"]
                     + spec_launches + tp_launches
                     + train_launches["flash_attention_fwd"]
                     + tuner_launches["flash_attention_fwd"]
                     + job_row["launches"]
                     + mixtral_serve["flash_launches"]
                     + mixtral_tp["flash_launches"]
                     + mixtral_train["flash_attention_fwd"]
                     + sum(m["flash_attention_fwd"]
                           for m in mesh_launches.values())),
        "launches_by_path": {
            "serve": serve_launches,
            "serve_deployment": deploy_row["flash_launches"],
            "serve_paged_spec": spec_launches,
            "serve_tp2": tp_launches,
            "train": train_launches["flash_attention_fwd"],
            "train_tuner": tuner_launches["flash_attention_fwd"],
            "job_submit": job_row["launches"],
            "serve_mixtral": mixtral_serve["flash_launches"],
            "serve_mixtral_tp2": mixtral_tp["flash_launches"],
            "train_mixtral": mixtral_train["flash_attention_fwd"],
            **{k: m["flash_attention_fwd"]
               for k, m in mesh_launches.items()}},
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "tp2_shard_shape": {k: shard_row[k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "mesh_shard_shapes": shard_rows(flash_rows, [
            (k, k) for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "max_abs_err")]),
    }, {
        "name": "flash_attention_bwd_dq",
        "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:201",
        "design": HOPPER_DESIGN,
        "launches": (train_launches["flash_attention_bwd_dq"]
                     + tuner_launches["flash_attention_bwd_dq"]
                     + mixtral_train["flash_attention_bwd_dq"]
                     + sum(m["flash_attention_bwd_dq"] for m in mesh_launches.values())),
        "launches_by_path": {
            "train": train_launches["flash_attention_bwd_dq"],
            "train_tuner": tuner_launches["flash_attention_bwd_dq"],
            "train_mixtral": mixtral_train["flash_attention_bwd_dq"],
            **{k: m["flash_attention_bwd_dq"] for k, m in mesh_launches.items()}},
        "max_abs_err": max(r["dq_max_abs_err"] for r in bwd_rows),
        "ms": bwd_row["dq_ms"],
        "plain_ms": bwd_row["dq_plain_ms"],
        "bound_ms": bwd_row["dq_bound_ms"],
        "bound_by": bwd_row["dq_bound_by"],
        "library_ms": bwd_row["sdpa_bwd_ms"],
        "library_covers": sdpa_covers,
        "mesh_shard_shapes": shard_rows(bwd_rows, bwd_keys("dq")),
    }, {
        "name": "flash_attention_bwd_dkv",
        "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_attention_bwd_dkv.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:248",
        "design": HOPPER_DESIGN,
        "launches": (train_launches["flash_attention_bwd_dkv"]
                     + tuner_launches["flash_attention_bwd_dkv"]
                     + mixtral_train["flash_attention_bwd_dkv"]
                     + sum(m["flash_attention_bwd_dkv"] for m in mesh_launches.values())),
        "launches_by_path": {
            "train": train_launches["flash_attention_bwd_dkv"],
            "train_tuner": tuner_launches["flash_attention_bwd_dkv"],
            "train_mixtral": mixtral_train["flash_attention_bwd_dkv"],
            **{k: m["flash_attention_bwd_dkv"] for k, m in mesh_launches.items()}},
        "max_abs_err": max(r["dkv_max_abs_err"] for r in bwd_rows),
        "ms": bwd_row["dkv_ms"],
        "plain_ms": bwd_row["dkv_plain_ms"],
        "bound_ms": bwd_row["dkv_bound_ms"],
        "bound_by": bwd_row["dkv_bound_by"],
        "library_ms": bwd_row["sdpa_bwd_ms"],
        "library_covers": sdpa_covers,
        "mesh_shard_shapes": shard_rows(bwd_rows, bwd_keys("dkv")),
    }]
    # B4 on the splash training path (softcap 0, as llama_1b has none);
    # the capped kernel's numbers beside them, where no library call
    # computes the same function
    plain_row, cap_row = splash_rows[0], splash_rows[1]
    for name, key, errs, source in (
            ("fwd", "fwd", ("max_abs_err",), "fwd"),
            ("bwd_dq", "dq", ("dq_max_abs_err",), "bwd"),
            ("bwd_dkv", "dkv", ("dk_max_abs_err", "dv_max_abs_err"),
             "bwd_dkv")):
        library = "sdpa_fwd_ms" if key == "fwd" else "sdpa_bwd_ms"
        kernels.append({
            "name": f"splash_attention_{name}",
            "route": "cuda",
            "source": f"ray_tpu_torch/csrc/flash_attention_{source}.cu",
            "replaces": "ray_tpu/ops/splash_attention.py:87",
            "design": HOPPER_DESIGN,
            "launches": splash_launches[f"splash_attention_{name}"],
            "max_abs_err": max(r[e] for r in splash_rows for e in errs),
            "ms": plain_row[f"{key}_ms"],
            "plain_ms": plain_row[f"{key}_plain_ms"],
            "bound_ms": plain_row[f"{key}_bound_ms"],
            "bound_by": plain_row[f"{key}_bound_by"],
            "library_ms": plain_row[library],
            **({"library_covers": sdpa_covers} if key != "fwd" else {}),
            "softcap_50": {"ms": cap_row[f"{key}_ms"],
                           "plain_ms": cap_row[f"{key}_plain_ms"],
                           "bound_ms": cap_row[f"{key}_bound_ms"],
                           "bound_by": cap_row[f"{key}_bound_by"],
                           "library_ms": None},
        })
    log(f"card: {card}")
    log("phases " + json.dumps({"seconds": PHASE_S,
                                "total_s": time.perf_counter() - T_START}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
