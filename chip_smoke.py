#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and the CUDA toolkit (nvcc); it builds the kernels
from ``ray_tpu_torch/ops/csrc`` and then runs, failing on the first phase
that fails:

1. device: the card's name and power limit from nvidia-smi; TF32 off;
2. build: both kernel sources (fused_norm.cu, flash_attention.cu), one nvcc
   each, started together, timed; ptxas's registers, spills, shared memory
   and performance notes of every kernel of both;
3. kernel vs plain version: each kernel against its plain PyTorch version
   on the same inputs, and the device time of the kernel, the plain
   version and one PyTorch call for the same function (the yardstick,
   never called by the port):
   - the LayerNorm and GELU kernels at the GPT-2-small shapes (R = 8 x 1024
     rows, D = 768, GELU width 3072) in bf16 and fp32 (``ln_bwd``'s dscale
     and dbias come from its partial rows through ``ln_bwd_sum``, which
     the check and the time include; the LayerNorm backward's yardstick is
     autograd through ``F.layer_norm``, timed also with the dres add);
   - the RMSNorm kernels at the Llama-small shape (R = 4 x 2048 rows,
     D = 1024) in bf16 and fp32; yardstick ``F.rms_norm`` and its autograd
     backward;
   - all six norm kernels at odd widths that exercise the masked tails,
     the RMSNorm kernels at the widths around their one-warp limit (768
     and 1024 at 37 and 45 rows, not a multiple of ``rms_bwd``'s row
     block; 1025 and 1032: just past it, unaligned and aligned), at D = 1
     and 31 and on views one element past a 16-byte boundary, and the
     LayerNorm and GELU kernels around the LayerNorm kernels' one-warp
     rows (768 and 1024 at 37, 45 and 64 rows; 769 and 1025 past them);
     ``ln_bwd`` and ``rms_bwd`` are also called twice on the same inputs
     and must give the same bits; the GELU kernels alone at lengths that
     are not a multiple of a 16-byte pack, shorter than one CTA's span,
     and on views one element past a 16-byte boundary;
   - the flash kernels at the GPT-2-small shape (B=8, T=1024, H=12, D=64,
     bf16, causal, q/k/v strided views of one [B, T, 3*768] tensor, as the
     model passes them), at the Llama-small shape (B=4, T=2048, H=16,
     D=64, contiguous q/k/v, as the GQA repeat leaves them) and at odd
     shapes (T = 77 and 1000, D = 128, causal=False, B=1, H=2); yardstick
     ``scaled_dot_product_attention`` forward, and its backward for the
     dK/dV + dQ pair;
   - dense against flash attention, forward plus backward, at T = 512,
     1024 and 2048 (B*H = 96, D = 64), timed only;
3b. ring attention on the flash kernels, in one process (``FoldedRing``:
   all sp positions of a ring on the card, the rank axis folded into the
   batch), at GPT-2 small's attention shape (B=8, T=1024, H=12, D=64, q/k/v
   strided views of one qkv tensor) and Llama small's (B=4, T=2048, H=16,
   D=64), each at sp = 2 and 4, bf16, with every kernel counter set to 0
   just before and read just after: flash_fwd (once causal, sp - 1 times
   full), flash_dkv and flash_dq (with the masking lse +1e30 on the
   blocks ahead) launched sp times each; out, dq, dk, dv and the lse
   against the same ring on the plain versions (phase 3's rules) and the
   loss (``mean(out ** 2)``) and gradient against one
   ``flash_causal_attention`` over the whole T (rtol 1e-2, cosine >
   0.999); the ring's forward plus backward device ms printed beside the
   one flash call's (a flash call of the folded ring holds sp times a
   rank's batch, so these are not per-rank times);
4. the train steps, each with every kernel counter set to 0 just before
   it and its launches read just after: the loss finite and falling, and
   every kernel launched exactly the expected number of times per step:
   - GPT-2 small (124M, seq 1024, batch 8) through ``measure_gpt2``, in
     ``bench.py``'s ``fused`` config with flash attention (the GPT-2 main
     path: 2 warmup and 4 timed steps), then with dense attention (1
     warmup and 3 timed steps);
   - Llama small (246M, 16 layers, d 1024, 16 query and 4 KV heads, seq
     2048, batch 4) through ``measure_llama`` with ``LLAMA_FLAGS`` (flash
     attention, RMSNorm kernels, dots remat; the Llama main path: 2 warmup
     and 4 timed steps);
   - the MoE model (``MoEConfig.small()``: Llama small's attention with
     each MLP a top-2 mixture of 8 SiLU experts, capacity factor 1.25;
     846M parameters, 292M active a token; seq 2048, batch 4) through
     ``measure_moe`` with ``MOE_FLAGS`` (flash attention, dots remat, the
     plain RMSNorm chain as in the JAX module; the MoE main path: 2 warmup
     and 4 timed steps): the three flash kernels only;
   six steps, because the GPT-2 run (AdamW at 3e-4 with no warmup, one
   batch repeated) turns unstable at the seventh on every path, the
   fully plain one included: its seventh loss lands anywhere from 9.9 to
   11.8, above the first, depending on bf16 rounding alone;
4b. the trainer: ``measure_trainer_gpt2`` runs phase 4's GPT-2 flash run
   (same config, init and batch, six steps) through
   ``CudaTrainer(...).fit()`` with ``ScalingConfig(num_workers=1)`` on the
   local backend, with every kernel counter set to 0 just before it and
   read just after: the loop attaches ``step_cost`` (FlopCounterMode over
   one call of the step, on copies of the state), runs each step through
   ``session.timed_step`` and reports its loss with a checkpoint
   (``save_sharded`` of the state) every second step. Held: each of the seven kernels
   launched exactly as in phase 4, per call of the step (the six steps and
   step_cost's call); the losses equal phase 4's within rtol 1e-5; the
   session's MFU gauge within 5% of step_cost's FLOPs over the trainer's
   own ms/step (the interval between its reports) against the card's
   peak, and each step's gauge equal to step_cost's FLOPs over the step's
   host and compute phases against that peak (the ratio of step_cost's
   FLOPs to the analytic count, and phase 4's MFU on either count,
   printed, not held: the trainer's step is not phase 4's);
   step_cost of the kernel path within 1% of the plain path's (dense
   attention, plain norms) on the same state and batch;
   ``device_telemetry.snapshot()`` naming the card; and a run that raises
   before step 3 restarting once from its step-2 checkpoint and giving
   phase 4's six losses within rtol 1e-5. The trainer's ms/step, tok/s
   and peak memory are printed beside phase 4's, with the card's name and
   power limit;
4c. the pipeline in one process: GPT-2 small's 12 blocks (``FUSED_FLAGS``)
   as 2 stages of 6 through ``pipeline_value_and_grad`` with ``mesh=None``
   (``FoldedPipe``: every stage in this process), 1F1B and GPipe; the
   input the embedded hidden state of phase 4's batch ([8, 1024, 768]
   bf16) in 8 microbatches, the loss an fp32 MSE to a target from seed 2;
   each style against one ``value_and_grad`` of the 12 blocks in sequence
   (loss rtol 1e-2, each stage's gradient cosine > 0.999), with every
   kernel counter set to 0 just before three calls (one warmup, two
   timed) and each kernel launched ``pipeline_launches`` times a call (a
   microbatch's blocks run forward three times on the first stage: the
   forward slot, the backward slot's recomputation, the dots remat's
   recompute; twice on the last, which keeps no forward slot); ms a call,
   ticks, bubble and peak memory printed;
5. the mesh of 1: a one-rank NCCL group (``parallel.distributed.
   initialize``) and ``build_mesh(MeshConfig(fsdp=-1))``; the GPT-2, Llama
   and MoE main-path steps of phase 4 again, sharded over that mesh through
   ``measure_gpt2`` / ``measure_llama`` / ``measure_moe(mesh=...)`` (the
   MoE with ``expert_parallel``: its experts exchanged by all_to_all over
   the one-rank ``ep`` group; DTensor parameters and
   moments, gathered to plain tensors for the model), each with every
   kernel counter set to 0 just before it and read just after: the losses
   against phase 4's (same init and batch; the first within rtol 1e-5,
   all six within 1e-4; the largest relative gap printed) and the same
   launches of every kernel; ms/step, tok/s and peak memory beside phase
   4's; then ``save_sharded`` of the GPT-2 state after one step and
   ``load_sharded`` onto the same mesh, every leaf bit for bit (bytes and
   seconds printed); the GPT-2 and Llama main-path steps again with
   ``attention_impl="ring"`` over the mesh of 1 (a ring of one is the
   causal flash call): losses and launches equal to phase 4's exactly;
   then, where there are two CUDA devices, 2 NCCL ranks
   of GPT-2 small at fsdp=2 and 2 of the MoE at ep=2 (each rank the whole
   batch, its 4 experts, the tokens exchanged by all_to_all; this script
   with ``--mesh-rank``): the first loss within rtol 1e-4 of the mesh of 1
   and the rest within 1e-2; and 2 NCCL ranks at sp=2 (each rank the
   whole batch and half the positions) of GPT-2 small with ring
   attention, Llama small with ring attention and Llama small with
   Ulysses (dense attention over all_to_all): the same tolerances against
   phase 4's unsharded losses, and each rank's launches a step
   (``TWO_RANK_LAUNCHES``); 2 NCCL ranks at tp=2 (each rank the whole
   batch, its 6 / 8 heads, its MLP columns and vocabulary rows) of GPT-2
   small and Llama small: the first loss within rtol 2e-3 of phase 4's
   (the row-parallel partial sums all-reduced in bf16), all within 1e-2,
   phase 4's launches a step on each rank; and phase 4c's pipeline over
   2 NCCL ranks (``--pp-rank``, ``GroupPipe``), 1F1B and GPipe, each rank
   holding its stage against the sequential blocks it computes itself
   (phase 4c's tolerances and launches, per stage); ms/step (ms a call),
   tok/s, peak memory and the card's name and power limit printed per
   rank -- with one device a line says each 2-rank run did not run;
5b. the cluster trainer: a ``Cluster`` of one node advertising the
   cards (``num_gpus`` = the device count), with the card's caching
   allocator emptied first (the free memory printed), and
   ``measure_trainer_gpt2(address=cluster.address, num_workers=1)``:
   phase 4b's run with its rank in a worker process on ``cuda:0``, which
   builds (or finds built) the kernels itself and counts their launches
   from 0 at the start of its loop. Held: the seven kernels launched in
   the worker exactly as in phase 4, per call of the step (the six steps
   and step_cost's call); the losses equal to phase 4's to the bit, else
   within rtol 2e-3 (the largest gap printed); no error in the
   ``Result``; the step-2 checkpoint (``save_sharded`` from the worker)
   reloads with ``load_sharded`` here and one step from it gives phase
   4's third loss within the same tolerance. Printed: ms/step beside
   phase 4b's local trainer and phase 4's ``measure_gpt2`` from this
   call. Where there are two or more cards, 2 workers at fsdp=2 on the
   same node (local ranks 0 and 1 on ``cuda:0`` and ``cuda:1``, one NCCL
   group formed through the cluster KV): losses held against phase 5's
   2-rank GPT-2 within that phase's tolerance; with one card a line says
   the 2-worker run did not run;
6. kernel path vs plain path, same weights and batch: GPT-2 (batch 4)
   flash + fused norms, and dense + fused norms, each against fully plain
   (dense attention, ``fused_norm=False``); Llama (batch 2) flash + RMSNorm
   kernels, and dense + RMSNorm kernels, each against fully plain; the MoE
   (batch 2) with flash against dense attention, the dense path's top-k
   choices replayed in the flash path (``compare_moe_paths``: routing is
   discontinuous, so the free-running flash path is held on its loss
   alone, its gradient cosine and the token-layers it routes otherwise
   printed);
7. serving: two ``LLMEngine``s at full width through ``measure_serve``
   (every kernel counter set to 0 just before each and read just after:
   the serving path reaches no kernel, as in the reference), each serving
   64 requests (prompts of 16-128 / 16-256 random tokens from seed 3, 64
   new tokens each, no eos), with its decode step and prefill lane as CUDA
   graphs:
   - GPT-2 small (bf16 activations), 32 slots, cache 1024, prefill lane
     4 x 128;
   - Llama small (bf16 activations), 32 slots, cache 2048, prefill lane
     4 x 256;
   each must return exactly 64 tokens a request, count ``{decode: 1,
   prefill: 1}`` compiles, and give the same tokens from one decode step
   replayed from its graph and called eagerly (same cache snapshot and
   input; the logits' max abs diff printed); a fresh engine of the same
   config (bf16) and its fp32 copy, same weights, must give logits whose
   cosine is above 0.999 for each of 4 prompts after the prefill lane and
   after one decode step fed the same tokens, and a K/V cache over those
   prompts' slots within 3% (relative, Frobenius); then an fp32 copy of each
   config must give, for 4 prompts x 8 tokens, the tokens of the model's
   naive full-forward loop up to the first step where that loop's top-2
   logit gap is under 1e-4 * max(1, |top logit|) (the smallest gap
   printed). The engines' numbers (decode tok/s at full occupancy, step
   ms graph and eager, prefill ms, TTFT p50/p99, peak memory) are
   printed beside the card's name and power limit;
8. the data library, run right after phase 4b (the order of the calls;
   the number keeps the earlier phases' numbers):
   8a. ingest: ``measure_trainer_gpt2(dataset=ds)``, phase 4b's run with
   each step's batch read through
   ``session.get_dataset_shard("train").iter_device_batches(batch_size=8)``
   (pinned host memory, a copy stream of its own, the consumer's stream
   waiting on an event), ``ds`` phase 4b's seed-1 token batch moved to the
   host once, one copy a step (6 x 8 rows of 1025 tokens over 6 blocks),
   through ``map_batches(as_tokens)``, every kernel counter set to 0 just
   before and read just after. Held: the losses within rtol 1e-5 of phase
   4b's; the seven kernels launched exactly as in phase 4b (the same calls
   of the step); every batch int64 on cuda:0, one transfer recorded a
   batch; the client's stall fraction (time inside ``next()`` over the
   loop's wall) within 0.10 of the one ``ray_tpu_data_iter_seconds``
   gives, and that histogram's wait seconds (one sample a batch) within
   20% + 0.3 ms of the client's. Printed: ms/step beside phase 4b's,
   data_wait a step from the session's anatomy, wait and transfer seconds
   a batch from the metrics, peak memory;
   8b. batch inference: ``measure_batch_predict_gpt2``, i.e.
   ``BatchPredictor.from_checkpoint(Checkpoint.from_dict({"params": 8a's
   trained parameters as numpy}), CudaPredictor, apply_fn=gpt2_score)``
   scoring 256 rows of 1025 seed-2 tokens with an ``id`` column at batch 8
   on one actor, every kernel counter set to 0 just before ``predict`` and
   read just after. Held: every id back once; each row's NLL bit for bit
   equal to a direct ``gpt2_score`` call on the same 8 rows; within rtol
   1e-3 of the plain path (dense attention, plain norms), and every
   batch's logits, each token's centred on its mean, within 0.05
   relative error and cosine > 0.999 of the plain path's (a row's NLL is
   a mean over 1024 tokens that a wrong kernel barely moves); ``ln_fwd``,
   ``gelu_fwd`` and ``flash_fwd`` launched 25, 12 and 12 times a batch
   (one forward) over the 32 batches, no other kernel. Printed: rows/s,
   tokens/s, ms a batch end to end beside the direct call's and
   ``CudaPredictor.predict``'s on the same numpy batches out of the pool,
   the predictor's build seconds, peak memory;
9. the trainer through the loss of a node, run right after phase 5b (the
   number keeps the earlier phases' numbers):
   9a. a preemption notice: ``measure_trainer_gpt2(preempt_at=2)`` --
   phase 5b's run, its failure budget 0 -- on a ``Cluster`` of a driver
   node with no GPU and two nodes A and B of one GPU each (on one card
   both stand for cuda:0; one trains at a time), ``preemption_signal_file``
   under ``chip_smoke_out/`` polled every 0.1 s. The rank on A writes
   A's id into the file right after step 2's checkpoint and trains on;
   A self-drains, the trainer's drain watcher sees DRAINING and restarts
   from step 2 on B. Held: no error; steps 1-6 each reported, steps 3-6
   from B; every loss within rtol 2e-3 of phase 4's; A DEAD with
   ``preemption`` in its death cause, its drain seen by the watcher; one
   restart, exempt, ``preemption``, through the drain watcher
   (``TrainingWorkerPreempted``: the watcher saw DRAINING before the
   trainer saw A's rank die); the downtime all planned (drain, preemption
   or reschedule) and its causes summing to it; the seven kernels
   launched in B's worker exactly (B's 4 steps + 1 step_cost call) x
   phase 4's count a step. Printed: seconds from the notice to DRAINING
   seen by the trainer, to the restart and to B's first step, B's start
   by stage (process, actor, group, loop, CUDA context, checkpoint load,
   step_cost, first step) beside A's, the drain's duration and
   ``forced``, ms/step on B beside phase 5b's, downtime by cause, B's
   peak memory;
   9b. with two or more cards, the elastic gang: 2 workers at fsdp=2
   (SPREAD, NCCL) on nodes standing for cards 0 and 1
   (``add_node(cuda_device=i)``), ``min_workers=1``, 14 steps;
   ``kill_node`` of card 0's node after step 2's checkpoint; after the
   first step at world 1 (on card 1, from the fsdp=2 checkpoint), a
   replacement node on card 0, and the gang regrows to 2. Held within a
   wall limit: no error; worlds 1 and 2 reported; steps 1-6 within 1e-2
   of phase 4's, every loss finite; ``reschedule`` among the downtime's
   causes, all planned; the final group ``CREATED`` with a reschedule and
   no bundle on the killed node. Printed: the shrink and regrow seconds,
   ms/step at each world size. With one card a line says it did not run;
10. the head's fault tolerance and the object plane between nodes, run
   right after phase 9:
   10a. the trainer through a head restart: phase 5b's run on a
   ``Cluster(persist_path=chip_smoke_out/head.db)`` of a driver node with
   no GPU and one GPU node, its failure budget 0; a thread watching
   ``progress_path`` writes a key into the KV after step 1 and, once step
   2 is reported, calls ``kill_head()``, keeps the head down HEAD_DOWN_S
   and calls ``restart_head(address)``. Held: no error; steps 1-6 each
   reported once, from one worker process; no restart; the losses equal
   to phase 5b's to the bit; the seven kernels launched exactly (6 steps
   + 1 ``step_cost`` call) x phase 4's count a step; on the restarted
   head both nodes ALIVE from heartbeats it received itself, the
   trainer's placement group ``CREATED``, and every KV key and value of
   before the crash (the trainer's coordinator key is deleted once its
   group forms, so the script's key stands in for it). Printed: the
   seconds the head was down, from the restart to the first heartbeat
   and to the next step report, the driver's and the agents' reconnect
   attempts, the store's persist stats, ms/step before, across and after
   the crash beside phase 5b's;
   10b. scoring through spilled, restored and chunk-pulled objects:
   phase 8b's job through ``measure_batch_predict_gpt2(address=...)`` on
   a ``Cluster`` whose driver node has no GPU and a store whose arena
   holds the serialized checkpoint and SPILL_MARGIN bytes, less than the
   job puts there (the checkpoint goes in first, so the blocks' puts
   spill it); the scoring actor on the GPU node, whose fetch of the
   checkpoint restores it. Held: every id back once; each row's NLL bit
   for bit phase 8b's; the checkpoint spilled and read back whole on the
   driver's node; the checkpoint pulled by the parallel chunk path, its
   chunks read from the spill file, and the blocks inline (the driver
   node's agent's transfer counters); ``ln_fwd``, ``gelu_fwd`` and
   ``flash_fwd`` launched 25, 12 and 12 times a batch, no other kernel.
   Printed: rows/s beside 8b's, the checkpoint pull's GB/s, the spill and
   restore seconds and bytes, the scoring worker's peak device memory;
11. the cluster observed (``--observe`` runs it alone, ~150 s):
   11a. spillback over the gossiped view: a ``Cluster`` of node A (the
   driver's) and node B, each ``num_gpus=1`` on card 0, A's GPU held by a
   long-lived actor; once every agent's ``peer_view`` names every peer,
   4 default-strategy tasks of ``num_gpus=0.25``, each scoring one
   8-row batch of 8b's rows with GPT-2 small's forward from the seed-0
   parameters. Held: every task ran on B, the head's ``schedule_batch``
   count rose by at most 1, the NLL bit for bit 8b's direct call on those
   rows, one forward's launches a task. Printed: the time to a full view
   and each task's node;
   11b. phase 5b's run again with tracing on in the driver and the
   worker, under one driver span, with the state API read on its own
   connection while the fit runs. Held: 5b's loss bits and launches; one
   trace from both processes whose ``train.step`` spans carry the
   driver's trace id and lie inside their parents after clock alignment,
   its critical path covering the root interval exactly; the trainer's
   worker ALIVE on the GPU node, every live object attributed, the
   worker's device snapshot naming the card with at least the parameters
   and AdamW's moments in fp32 in use and no device on the driver node;
   ``list_tasks`` / ``summarize_tasks`` counting the run's calls,
   ``memory_summary`` equal to the agents' store bytes; phase 7's GPT-2
   engine answering one traced request whose ``decompose`` sums to its
   TTFT exactly. Printed: spans a step, the clock offset and RTT, ms/step
   with tracing on beside 5b's;
12. the cluster operated (``--operate`` runs it alone, its 5b reference a
   run on its cluster first): phase 5b's run, ``OPERATE_STEPS`` steps, on
   a ``Cluster(metrics_port=0)`` of a GPU-less driver node and a GPU node,
   log capture on, the signal and SLO loops every 0.5 s, the loop printing
   each step's loss and saving no checkpoint (5b's saves every second
   step would write 1.39 GiB each). While the fit runs, through ``ray_tpu_torch.state``:
   ``dump_stack`` of the trainer's worker; ``capture_profile(duration_s=
   1.0)`` of it, downloaded through the head; a 20 ms delay rule on the
   ``worker_events`` upload armed in every process, listed and cleared;
   ``/metrics/cluster`` over HTTP beside ``device_stats``; the SLOs
   ``step_p99 < 60s over 30s`` and ``mfu > 99% over 30s``. Held: 5b's loss
   bits over the first six steps and its launches a call; the stack names
   the loop; a ``torch_profiler`` capture whose device events name the
   seven kernels by their ``__global__`` names; ``get_log``, ``follow_log``
   and the driver's ``LOGS`` lines equal to the reported losses; the
   worker's device bytes in use at least the fp32 parameters and AdamW
   moments and equal to a ``device_stats`` snapshot; both nodes' store
   gauges; the federated step histogram counting each report once and a
   windowed rate of them; the first SLO ``ok``, the second ``burning``
   with one event; then ``set_failpoints`` at ``worker.execute.before``
   listed in head, both agents and the GPU node's workers, failing a
   ``num_gpus`` task with ``FailpointError``, and disarmed. Printed:
   ms/step beside 5b's, the capture window's steps apart, the trace's
   size and each kernel's events, the scrape's ms and the ring's series,
   the seconds to ``burning``;
15. streams (after phase 7; ``--streams`` runs it alone, ~35 s):
   15b. phase 8a's ingest with ``target_block_size_bytes`` at 16 KiB,
   below one 8-row block (65,600 B): each block splits in 5, and the
   stage runs as streaming tasks. Held: 8a's losses to the bit, its
   launches, the stage's ``splits`` equal to ``block.split_cuts``'s
   count;
   15a. on a ``Cluster`` of one node with the card, a ``num_gpus=1,
   num_returns="streaming"`` task scores 8b's 256 rows at batch 8 with
   ``gpt2_score`` on 8a's parameters (put in the store, passed as a ref)
   and yields each batch's NLL. Held: every item bit for bit 8b's; the
   driver read item 0 before the worker's last yield stamp; 25 / 12 / 12
   ``ln_fwd`` / ``gelu_fwd`` / ``flash_fwd`` launches a batch in the
   worker, no other kernel. The same task dropped after 2 items: its
   record ends short of 32 yields and, within 10 s, the head lists none
   of its tail (read through ``ray_tpu_torch.state``);
   15d. a ``num_gpus=1`` task raising on the node: its task id, name and
   error text on the driver's ``ERRORS`` subscription within 10 s;
   15c. an async actor (``num_gpus=1``) building phase 7's GPT-2 engine
   in its constructor, phase 7's 64 prompts sent to its ``async def
   generate`` at once. Held: phase 7's greedy tokens; the calls
   overlapped (peak active slots >= 2). Printed: tok/s and latency a
   request beside phase 7's in-process engine;
16. runtime envs and the ray:// client (after phase 15; ``--envs`` runs it
   alone), on a ``Cluster`` of one node with the card, GPT-2 small at
   full width with 8a's parameters and 8b's rows. The script writes a
   module into a temporary directory that only this process has on its
   path (the in-process agents are kept from handing it to their
   workers, through ``worker_pythonpath_exclude``); its ``score`` scores
   8b's 256 rows at batch 8 with ``measure.gpt2_score_counted``.
   16a. ``score`` as a ``num_gpus=1`` task with no ``runtime_env``. Held:
   it fails with an import error. With ``runtime_env={"working_dir":
   ..., "env_vars": ...}``. Held: 8b's NLLs bit for bit; the task's cwd
   under the node's env cache; the env var; 25 / 12 / 12 ``ln_fwd`` /
   ``gelu_fwd`` / ``flash_fwd`` launches a batch, no other kernel. A
   second task of the env: the same pid, and one ``rtenv:pkg:`` key in
   the head's KV. A plain ``num_gpus=1`` task: another pid. Printed: the
   seconds to the first result with the env beside a plain task's and
   the second task's;
   16b. two ``num_gpus=0.5`` tasks, each with its own ``py_modules``
   version of one module, at once. Held: each imports its own version,
   on its own pid, and the two ran at the same time;
   16c. a ``ClientProxyServer`` on the cluster, and a remote driver in a
   subprocess (``--client-driver``): it loads 8a's parameters from a
   file and puts them through the proxy, runs 16a's task with the same
   ``working_dir``, creates a ``num_gpus=1`` actor of the module and
   calls it (it returns a CUDA tensor), waits on both, cancels a slow
   task and drops its ref. Held: 8b's NLLs bit for bit and 16a's
   launches a batch; the actor's tensor on the client's CPU; the client
   never initialised CUDA and mapped no ``rtorch_*`` segment; within
   10 s of its disconnect the proxy holds no session of it and its actor
   is dead. Printed: a ``get`` through the proxy beside a direct
   driver's;
17. Serve (after phase 16; ``--serve`` runs it alone), on a ``Cluster`` of
   one node with the card, the controller, replicas and HTTP proxy in its
   worker processes:
   17a. ``LLMEngine`` as deployment ``llm``: phase 7's GPT-2 small engine
   (seed 0, bf16, 32 slots, ring cache 1024, prefill lane 4 x 128),
   ``ray_actor_options={"num_gpus": 0.5}``, route prefix "/llm"; phase 7's
   64 prompts, 64 new tokens each, at once through ``handle.stream()``,
   then over HTTP (chunked ndjson) through the node's proxy. Held: phase
   7's greedy tokens on both lanes; each lane's mean active slots over its
   decode steps above 1; ``/metrics/cluster`` carrying each of ``llm``'s
   serve series once, those the phase moved under the node's id, the
   replica gauge under one replica label. Printed: tok/s, TTFT p50/p99 (the client's first chunk)
   and latency a request per lane beside phase 7's and 15c's, and
   ``serve.stats()``'s phases and decode rollup for ``llm``;
   17b. ``measure.GPT2Scorer`` as deployment ``score``
   (``@serve.batch(max_batch_size=8)``, 8a's parameters through the store,
   ``num_gpus=0.5``, "/score"): 8b's 256 rows POSTed one a request, 32 in
   flight. Held: each NLL within 1e-3 of 8b's direct call; 25 / 12 / 12
   ``ln_fwd`` / ``gelu_fwd`` / ``flash_fwd`` launches per formed batch in
   the replica's worker, no other kernel; the federated
   ``ray_tpu_serve_batch_size`` counting 256 rows over the batches that
   formed. Printed: rows/s beside 8b's, the batch sizes, the worker's
   peak device memory;
   17c. a ``ClientProxyServer`` and a remote driver in a subprocess
   (``--serve-client-driver``) streaming 8 of the prompts at once from
   ``llm`` through ``ClientBackend.serve_stream``. Held: phase 7's tokens;
   no CUDA context and no store segment in the client. Printed: its TTFT
   beside 17a's handle lane;
   then ``serve.shutdown()``. Held: within 10 s the head lists no live
   ``Replica``, ``HTTPProxy`` or ``ServeController``;
18. Tune (after phase 17; ``--tune`` runs it alone), GPT-2 small trials of
   phase 4's config, init (seed 0) and batch (seed 1), held against phase
   4's GPT-2 flash run:
   18a. ``measure_tune_gpt2``: ``tune.with_resources(
   measure.tune_gpt2_trial, {"GPU": 0.5})`` over the learning rates
   ``TUNE_ASHA_LRS`` (3e-4 among them) on the local backend, two trials
   on the card at once, each from its own actor thread,
   ``ASHAScheduler(max_t=6, grace_period=2, reduction_factor=2)``, metric
   ``loss``, mode ``min``, every kernel counter set to 0 just before and
   read once every started step has finished. Held: no trial error; the
   3e-4 trial's losses phase 4's over the steps it ran (rtol 1e-5); a
   trial stopped before max_t; each decision that of a fresh
   ``ASHAScheduler`` replayed on the recorded order of arrival; each of
   the seven kernels launched phase 4's per-step count times the steps
   the trials started, no other kernel; ``get_best_result()`` the lowest
   final loss among the trials that reached max_t. Printed: the wall
   time, each trial's time to its first report and ms/step beside phase
   4's, the process's peak memory (both trials' together: they share
   one process and its allocator), the runner's time from a report to
   its decision;
   18b. ``measure_tune_gpt2(scheduler="pbt")``: two trials (3e-4 and
   1e-6), ``perturbation_interval=2``, a ``save_sharded`` checkpoint
   directory every second step, 6 steps, lr mutations a list. Held: no
   error; an exploit; each exploiting attempt's first two losses equal
   to two steps computed in the phase from the donor's checkpoint at the
   exploit's lr (rtol 1e-5); the checkpoints' directory gone at the end.
   Printed: the exploits, the restart time (the stop to the new
   attempt's first report), the checkpoints' bytes and save/load
   seconds;
   18c. ``measure_tune_trainer_gpt2`` on a ``Cluster`` of one node with
   the card: two trials (3e-4, 1e-3) of ``tune_trainer_gpt2_trial``,
   each in a gang ``[{"CPU": 1}, {"CPU": 1, "GPU": 1}]`` (PACK) running
   ``CudaTrainer(trainer_gpt2_loop, 3 steps, no checkpoint)`` whose
   worker takes the gang's second bundle. Held: both finish, one after
   the other; the 3e-4 trial's losses phase 4's first three within 2e-3;
   each worker's launches phase 4's per-step count times 4 (3 steps and
   ``step_cost``'s call); within 10 s of ``fit`` no live placement group
   and the GPU free. Printed: each trial's start to its first report,
   its wall time, and its start by stage from ``fit``'s (the trial's
   process, its entry, the worker's process, actor, group, loop, device,
   state, ``step_cost``, first step);
13. one JSON line of every TPU kernel of the JAX package, all ported, with
   its launches on its main path, over the mesh of 1, with the ring of
   one, through the trainer, through the cluster trainer's worker
   process, in B's worker through phase 9a's preemption restart, through
   phase 10a's head restart, in a call of phase 4c's pipeline, fed by the
   Dataset (8a), a batch of phase 8b's and phase 10b's scoring and, with
   two cards, a step a rank at tp=2, a task of 11a's and 11b's traced
   run, a call of phase 12's operated run, a batch of phase 15a's stream,
   a call of phase 15b's streamed split, a batch of phase 16a's task, of
   16c's task through ``ray://`` and 16b's tasks, a batch that phase 17b's
   ``@serve.batch`` formed, phase 18a's trials (with the steps they
   started) and 18c's trainer workers (the flash kernels: GPT-2's,
   with Llama's and the MoE's beside them, and their launches and ms in
   phase 3b's rings);
14. the last line, ``{"ok": true, "device": {...}}``.

Tolerances: fused-norm (LayerNorm, RMSNorm, GELU) fp32 outputs within
1e-5 (forward) and 1e-4 (gradients) of the plain version, relative to the
larger of 1 and the output's largest magnitude (the column sums
dscale/dbias reach ~100 at R = 8192, where fp32 sums taken in another order
differ by more than 1e-4 absolute); bf16 outputs within one bf16 ulp plus
1e-5 absolute (values near zero carry the fp32 rounding from before the
cast); bf16 dscale/dbias by cosine > 0.9999. Flash: lse within 1e-4 * max(1, |lse|) (fp32 sums taken
tile by tile, in another order than the dense plain version); out, dq, dk
and dv by cosine > 0.9999 with the max abs error printed (the kernels round
P and dS to bf16 against the running max of each tile, the plain version
against the row's final max, so single elements move by a bf16 ulp of
their magnitude; the JAX package's own bf16 criterion is 0.999). Paths:
loss within rtol 1e-2 and whole-tree gradient cosine > 0.999.
Kernel times are CUDA-event medians of 30 launches, after the clocks are
warmed up, with the 50 MB L2 flushed (by a read) before each, queued
behind a device sleep so that host launch overhead is not timed. Details
go to ``chip_smoke_out/chip_smoke.json``.

``python3 chip_smoke.py --two-workers`` runs phase 5b's two-worker run
alone, with what it is held against (phase 4's GPT-2 run, the mesh of 1,
phase 5's 2 ranks), on a machine with two or more cards.
``python3 chip_smoke.py --drain`` runs phase 9 alone (9b with two or more
cards) after phase 4's GPT-2 run it is held against.
``python3 chip_smoke.py --head-ft`` runs phase 10 alone, after phase 4's
GPT-2 run (10a is held against its losses: phase 5b's run gives phase 4's
bits) and phase 8b's scoring on the seed-0 parameters (10b's reference).
``python3 chip_smoke.py --observe`` runs phase 11 alone (11b's phase 5b
reference an untraced run on its cluster).
``python3 chip_smoke.py --operate`` runs phase 12 alone (its phase 5b
reference a run on its cluster).
``python3 chip_smoke.py --streams`` runs phase 15 alone, after phase 4's
GPT-2 run, 4b, 8a, 8b and phase 7's GPT-2 engine it is held against.
``python3 chip_smoke.py --envs`` runs phase 16 alone, after phase 4's
GPT-2 run, 4b, 8a and 8b it is held against.
``python3 chip_smoke.py --serve`` runs phase 17 alone, after phase 4's
GPT-2 run, 4b, 8a, 8b and phase 7's GPT-2 engine it is held against.
``python3 chip_smoke.py --tune`` runs phase 18 alone, after phase 4's
GPT-2 run it is held against.
``python3 chip_smoke.py --sp-ranks`` runs phase 5's three sp=2 two-rank
runs alone, with phase 4's GPT-2 and Llama runs they are held against,
on a machine with two or more cards; ``--tp-ranks`` the two tp=2 runs
the same way, and ``--pp-ranks`` the pipeline over two ranks.

After each phase of the whole run, a line gives the seconds it took.

Exits non-zero, printing no result, when CUDA is not available or when the
``ray_tpu_torch`` package is not beside this file.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

from ray_tpu_torch.scripts.flash_bench import (bf16_within_ulp, cosine,
                                               device_ms, flash_inputs,
                                               host_us, plain_flash,
                                               ptxas_report, warm_clocks)

OUT = Path(__file__).resolve().parent / "chip_smoke_out"
SOURCES = {"fused_norm": "ray_tpu_torch/ops/csrc/fused_norm.cu",
           "flash_attention": "ray_tpu_torch/ops/csrc/flash_attention.cu"}

# Every function of the JAX package that reaches pl.pallas_call.
TPU_KERNELS = [
    ("ln_fwd", "ray_tpu/ops/fused_norm.py:121", "_ln_fwd_kernel"),
    ("ln_bwd", "ray_tpu/ops/fused_norm.py:184", "_norm_bwd_kernel, LayerNorm"),
    ("gelu_fwd", "ray_tpu/ops/fused_norm.py:278", "_gelu_fwd_kernel"),
    ("gelu_bwd", "ray_tpu/ops/fused_norm.py:284", "_gelu_bwd_kernel"),
    ("rms_fwd", "ray_tpu/ops/fused_norm.py:137", "_rms_fwd_kernel"),
    ("rms_bwd", "ray_tpu/ops/fused_norm.py:184", "_norm_bwd_kernel, RMSNorm"),
    ("flash_fwd", "ray_tpu/ops/flash_attention.py:84", "_fwd_kernel"),
    ("flash_dkv", "ray_tpu/ops/flash_attention.py:211", "_dkv_kernel"),
    ("flash_dq", "ray_tpu/ops/flash_attention.py:269", "_dq_kernel"),
]
NORM_KERNELS = ("ln_fwd", "ln_bwd", "gelu_fwd", "gelu_bwd")
RMS_KERNELS = ("rms_fwd", "rms_bwd")
FLASH_KERNELS = ("flash_fwd", "flash_dkv", "flash_dq")
PORTED = NORM_KERNELS + RMS_KERNELS + FLASH_KERNELS

BATCH, SEQ, D_MODEL, N_HEAD = 8, 1024, 768, 12
ROWS = BATCH * SEQ
# Llama small (LlamaConfig.small()) at batch 4: 8192 tokens a step.
L_BATCH, L_SEQ, L_D_MODEL, L_N_HEAD = 4, 2048, 1024, 16
L_ROWS = L_BATCH * L_SEQ
WARMUP, STEPS = 2, 4
DENSE_WARMUP, DENSE_STEPS = 1, 3
# Launches per train step of the fused config with remat="dots": two norms
# per block plus the final one, one attention per block; the forward ones
# run again when backward recomputes each block (the checkpoint policy
# saves matrix products only, so the flash forward is recomputed too).
EXPECTED_PER_STEP = {"ln_fwd": 2 * 25 - 1, "ln_bwd": 25, "gelu_fwd": 24,
                     "gelu_bwd": 12, "rms_fwd": 0, "rms_bwd": 0,
                     "flash_fwd": 24, "flash_dkv": 12, "flash_dq": 12}
EXPECTED_DENSE = dict(EXPECTED_PER_STEP, flash_fwd=0, flash_dkv=0, flash_dq=0)
# The Llama step, by the same rule over 16 blocks: rms_fwd 2*2*16 + 1,
# rms_bwd 2*16 + 1, flash 2*16 / 16 / 16.
EXPECTED_LLAMA = {"ln_fwd": 0, "ln_bwd": 0, "gelu_fwd": 0, "gelu_bwd": 0,
                  "rms_fwd": 65, "rms_bwd": 33, "flash_fwd": 32,
                  "flash_dkv": 16, "flash_dq": 16}
# The MoE step: Llama's attention over 16 blocks, its norms the plain chain.
EXPECTED_MOE = dict(EXPECTED_LLAMA, rms_fwd=0, rms_bwd=0)
# Flash check shapes (b, t, h, d, causal): the GPT-2-small one first.
# Then the tile edges of the warp-specialised kernels (128-row fixed tiles;
# swept tiles of 128 or 64 keys in flash_fwd, 64 or 16 q rows in flash_dkv,
# 64 keys in flash_dq), at B*H = 3.
FLASH_EDGE_SEQS = (1, 63, 64, 65, 127, 128, 129, 2049)
FLASH_CASES = [(BATCH, SEQ, N_HEAD, 64, True), (1, 77, 2, 64, True),
               (1, 1000, 2, 64, True), (1, 1000, 2, 128, True),
               (1, 77, 2, 128, False), (1, 1000, 2, 64, False)] + [
    (1, t, 3, d, causal) for t in FLASH_EDGE_SEQS for d in (64, 128)
    for causal in (True, False)]
FLASH_LLAMA_CASE = (L_BATCH, L_SEQ, L_N_HEAD, 64, True)
# (rows, d) of the norm checks at odd widths, all six kernels; then the
# RMSNorm kernels alone around their one-warp rows (up to 1024 wide and
# read 16 bytes at a time), with 37 and 45 rows, not a multiple of
# rms_fwd's 8-row CTA or of rms_bwd's row block; then views one element
# past a 16-byte boundary (the multi-warp rows, an element at a time).
NORM_ODD_WIDTHS = ((37, 100), (64, 8192), (37, 2050))
RMS_WARP_WIDTHS = ((37, 1), (37, 31), (37, 1024), (45, 1024), (37, 768),
                   (45, 768), (37, 1025), (37, 1032))
RMS_UNALIGNED_WIDTHS = ((21, 96), (21, 1024))
# GELU lengths: shorter than one CTA's span of 16-byte packs (100),
# not a multiple of a pack (1001), whole CTAs plus a tail of elements
# (8199, 98309); each also on a view one element past a 16-byte boundary.
GELU_ODD_LENGTHS = (100, 1001, 8199, 3 * 8192 * 4 + 5)
# The LayerNorm kernels around their one-warp rows (up to 1024 wide and
# read 16 bytes at a time): 37 and 45 rows are not a multiple of ln_bwd's
# 32-row block; 769 is not readable 16 bytes at a time, 1025 too wide.
LN_WARP_WIDTHS = ((37, 768), (45, 768), (37, 769), (64, 1024), (64, 1025))
CROSSOVER_SEQS = (512, 1024, 2048)
# Phase 3b, the single-process ring at the main paths' attention shapes:
# (label, B, T, H, q/k/v strided views of one qkv tensor), at each sp. A
# ring call launches flash_fwd sp times (once causal), flash_dkv and
# flash_dq sp times each.
RING_CASES = (("GPT-2", BATCH, SEQ, N_HEAD, True),
              ("Llama", L_BATCH, L_SEQ, L_N_HEAD, False))
RING_SPS = (2, 4)
# Phase 4c and the pp=2 ranks: GPT-2 small's 12 blocks as PIPE_PP stages of
# 6, phase 4's batch embedded ([8, 1024, 768] bf16) in PIPE_MICRO
# microbatches of one sequence, an fp32 MSE to a target from seed 2.
PIPE_PP, PIPE_MICRO = 2, 8
# Launches of one GPT-2 forward (fused config, no gradient): two norms per
# block plus the final one, one GELU and one flash forward per block.
FORWARD_LAUNCHES = {"ln_fwd": 2 * 12 + 1, "gelu_fwd": 12, "flash_fwd": 12}
# Phase 8b: rows scored and the batch size.
PREDICT_ROWS, PREDICT_BATCH = 256, 8
# Phase 15: 15b's target block size, below one 8-row block of 1025 int64
# tokens (65,600 B), so each block splits in 5; the items 15a's second
# stream is dropped after; the GPU node's store (8a's parameters, 498 MB in
# fp32, go through it).
STREAM_TARGET_BYTES, STREAM_DROP_AFTER = 16 << 10, 2
STREAM_STORE_BYTES = 2 << 30
# Phase 16: the user module only a runtime env brings to a worker, the
# env var it is given, the py_modules module of 16b and how long each 16b
# task holds its half of the card, and the subprocess driver's limit.
ENV_MODULE, ENV_VAR_VALUE = "chip16_app", "chip-smoke-16"
ENV_VERSION_MODULE, ENV_HOLD_S = "chip16_ver", 2.0
ENV_CLIENT_LIMIT_S = 600
ENV_MODULE_SOURCE = '''"""chip_smoke.py phase 16's user code: it reaches a worker only
through a runtime env (its working_dir)."""

import os


def score(params, tokens, batch_size):
    import time

    t_call = time.time()
    from ray_tpu_torch.scripts.measure import score_rows_counted

    out = score_rows_counted(params, tokens, batch_size)
    out.update(cwd=os.getcwd(), var=os.environ.get("CHIP16_VAR"),
               t_call=t_call)
    return out


def slow(seconds):
    import time

    time.sleep(seconds)
    return seconds


def version_of(module, hold_s):
    """Import ``module`` (a py_modules entry of the task's env) and hold
    the task's share of the card ``hold_s`` seconds. Returns its VERSION,
    this process's pid, the wall times the call started and ended, and
    the kernels this process launched (it imports none)."""
    import importlib
    import sys
    import time

    t0 = time.time()
    version = importlib.import_module(module).VERSION
    time.sleep(hold_s)
    launches = {k: n for name in ("ray_tpu_torch.ops.fused_norm",
                                  "ray_tpu_torch.ops.flash_attention")
                if name in sys.modules
                for k, n in sys.modules[name].KERNEL_INVOCATIONS.items()
                if n}
    return {"version": version, "pid": os.getpid(), "t0": t0,
            "t1": time.time(), "launches": launches}


class EnvProbe:
    def probe(self):
        import torch

        dev = torch.cuda.current_device()
        return {"pid": os.getpid(), "cwd": os.getcwd(),
                "var": os.environ.get("CHIP16_VAR"),
                "device": torch.cuda.get_device_name(dev),
                "tensor": torch.arange(4, device=dev)}
'''
# Phase 11a: tasks spilled to the peer, the GPU share each asks for.
OBSERVE_TASKS, OBSERVE_GPUS = 4, 0.25
# Phase 10a: the seconds the head stays down, and the KV key the script
# writes before the crash. Phase 10b: the driver node's arena beyond the
# checkpoint. It is less than the eight blocks of rows (~2.1 MB), which are
# put after the checkpoint, so their puts spill it; and once they are in,
# the checkpoint cannot be restored beside them, so its chunks are read
# from the spill file.
HEAD_DOWN_S, HEAD_FT_KEY = 2.0, "chip-smoke/head-ft"
SPILL_MARGIN = 1 << 20
# Phase 9b: the elastic gang's steps (enough that the shrunk world is
# still training when the replacement node lands), and its wall limit.
ELASTIC_STEPS, ELASTIC_LIMIT_S = 14, 420
# The serving phase: requests per engine and new tokens a request; the
# fp32 check's prompts and tokens.
SERVE_REQUESTS, SERVE_NEW_TOKENS = 64, 64
# Phase 17: the prompts 17c streams through ray://, the scoring requests
# 17b keeps in flight, 17b's largest batch, the NLL tolerance to 8b's
# direct call, Serve's actor classes (none may outlive serve.shutdown),
# and the ray:// driver's limit.
SERVE_CLIENT_PROMPTS, SERVE_SCORE_IN_FLIGHT, SERVE_SCORE_BATCH = 8, 32, 8
SERVE_NLL_TOL = 1e-3
SERVE_ACTORS = ("Replica", "HTTPProxy", "ServeController")
SERVE_CLIENT_LIMIT_S = 300
NAIVE_PROMPTS, NAIVE_TOKENS = 4, 8
# The served (bf16) engine against its fp32 copy: the smallest per-prompt
# cosine of the prefill and decode logits, and the largest relative error
# of the K/V cache over the prompts' slots. bf16 rounding alone gave
# cosines of 0.99986-0.99994 and cache errors of 0.009 (GPT-2 small) and
# 0.012 (Llama small) on an H100 80GB HBM3 at 700 W; a cache write 10% off
# gives 0.097 at tiny width.
SERVED_COSINE, SERVED_CACHE_REL = 0.999, 0.03


class PhaseError(RuntimeError):
    pass


class PhaseClock:
    """The seconds each phase of ``main``'s run took, from the end of the
    one before: ``lap`` prints them on a line of their own and keeps them
    in ``seconds``."""

    def __init__(self, smi: str):
        self.smi = smi
        self.seconds: dict = {}
        self._t = time.perf_counter()

    def lap(self, phase: str) -> None:
        now = time.perf_counter()
        self.seconds[phase] = now - self._t
        self._t = now
        print(f"phase {phase}: {self.seconds[phase]:.1f} s [{self.smi}]")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# -- measurement helpers -------------------------------------------------------


def compare(torch, name, got, want, fp32_tol, failures) -> float:
    """Check one output against the plain version; returns max abs error."""
    err = float((got.float() - want.float()).abs().max())
    if got.dtype == torch.bfloat16:
        ok = bf16_within_ulp(got, want)
    else:
        ok = err <= fp32_tol * max(1.0, float(want.abs().max()))
    if not ok:
        failures.append(f"{name}: max abs err {err:.3e} ({got.dtype})")
    return err


# -- phase 3 -------------------------------------------------------------------


def check_kernels(torch, fn, rows, d, dtype, failures, seed):
    """Run each kernel and its plain version on the same inputs; return
    (errors by kernel, inputs) for timing."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    scale = 1 + 0.1 * torch.randn(d, device="cuda", generator=g)
    bias = 0.1 * torch.randn(d, device="cuda", generator=g)
    dy = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    dres = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    xg = (2 * torch.randn(rows, 4 * d, device="cuda", generator=g)).to(dtype)
    gg = torch.randn(rows, 4 * d, device="cuda", generator=g).to(dtype)
    tag = f"[{rows}x{d} {str(dtype).split('.')[-1]}]"
    errs = {}

    y, mu, rstd = fn.ln_fwd(x, scale, bias)
    y_r, mu_r, rstd_r = fn.ref_ln_fwd(x, scale, bias)
    errs["ln_fwd"] = max(compare(torch, f"ln_fwd y {tag}", y, y_r, 1e-5, failures),
                         compare(torch, f"ln_fwd mu {tag}", mu, mu_r, 1e-5, failures),
                         compare(torch, f"ln_fwd rstd {tag}", rstd, rstd_r, 1e-5,
                                 failures))
    errs["ln_bwd"] = 0.0
    for res in (None, dres):
        got = fn.ln_bwd(x, mu_r, rstd_r, scale, dy, res)
        want = fn.ref_ln_bwd(x, mu_r, rstd_r, scale, dy, res)
        case = f"{tag}{' +dres' if res is not None else ''}"
        e = [compare(torch, f"ln_bwd dx {case}", got[0], want[0], 1e-4, failures)]
        for part, a, b in zip(("dscale", "dbias"), got[1:], want[1:]):
            if dtype == torch.float32:
                e.append(compare(torch, f"ln_bwd {part} {case}", a, b, 1e-4,
                                 failures))
            else:
                e.append(float((a - b).abs().max()))
                c = cosine(a, b)
                if not c > 0.9999:
                    failures.append(f"ln_bwd {part} {case}: cosine {c}")
        errs["ln_bwd"] = max(errs["ln_bwd"], *e)
        again = fn.ln_bwd(x, mu_r, rstd_r, scale, dy, res)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            failures.append(f"ln_bwd {case}: two calls differ")
    errs["gelu_fwd"] = compare(torch, f"gelu_fwd {tag}", fn.gelu_fwd(xg),
                               fn.ref_gelu(xg), 1e-5, failures)
    errs["gelu_bwd"] = compare(torch, f"gelu_bwd {tag}", fn.gelu_bwd(xg, gg),
                               fn.ref_gelu_bwd(xg, gg), 1e-4, failures)
    torch.cuda.synchronize()
    return errs, dict(x=x, scale=scale, bias=bias, dy=dy, dres=dres, mu=mu_r,
                      rstd=rstd_r, xg=xg, gg=gg)


def time_kernels(torch, fn, inp, spec, flush):
    """{kernel: {ms, plain_ms, library_ms, bound_ms, bound_by, ...}}."""
    F = torch.nn.functional
    x, scale, bias, dy, dres = (inp[k] for k in ("x", "scale", "bias", "dy",
                                                 "dres"))
    mu, rstd, xg, gg = inp["mu"], inp["rstd"], inp["xg"], inp["gg"]
    rows, d = x.shape
    n = xg.numel()
    es = x.element_size()
    w_l, b_l = scale.to(x.dtype), bias.to(x.dtype)
    x_l = x.detach().requires_grad_(True)
    w_g, b_g = (t.detach().requires_grad_(True) for t in (w_l, b_l))
    y_l = F.layer_norm(x_l, (d,), w_g, b_g, 1e-5)

    # (kernel, plain, library, bytes moved, fp32 operations)
    cases = {
        "ln_fwd": (lambda: fn.ln_fwd(x, scale, bias),
                   lambda: fn.ref_ln_fwd(x, scale, bias),
                   lambda: F.layer_norm(x, (d,), w_l, b_l, 1e-5),
                   2 * rows * d * es + 2 * rows * 4 + 2 * d * 4,
                   8 * rows * d),
        "ln_bwd": (lambda: fn.ln_bwd(x, mu, rstd, scale, dy, dres),
                   lambda: fn.ref_ln_bwd(x, mu, rstd, scale, dy, dres),
                   lambda: torch.autograd.grad(y_l, (x_l, w_g, b_g), dy,
                                               retain_graph=True),
                   4 * rows * d * es + 2 * rows * 4 + 3 * d * 4,
                   14 * rows * d),
        "gelu_fwd": (lambda: fn.gelu_fwd(xg), lambda: fn.ref_gelu(xg),
                     lambda: F.gelu(xg, approximate="tanh"),
                     2 * n * es, 12 * n),
        "gelu_bwd": (lambda: fn.gelu_bwd(xg, gg),
                     lambda: fn.ref_gelu_bwd(xg, gg),
                     lambda: torch.ops.aten.gelu_backward(gg, xg,
                                                          approximate="tanh"),
                     3 * n * es, 20 * n),
    }
    times = {name: {"ms": device_ms(kern, flush),
                    "plain_ms": device_ms(plain, flush),
                    "library_ms": device_ms(lib, flush),
                    **bound(nbytes, ops, spec, "fp32_flops")}
             for name, (kern, plain, lib, nbytes, ops) in cases.items()}
    # The library's backward has no dres add; with it, it does ln_bwd's work.
    times["ln_bwd"]["library_dres_ms"] = device_ms(
        lambda: cases["ln_bwd"][2]()[0] + dres, flush)
    return times


def _shifted(torch, t):
    """A copy of ``t`` one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    flat[1:] = t.flatten()
    return flat[1:].view(t.shape)


def check_rms(torch, fn, rows, d, dtype, failures, seed, shift=False):
    """rms_fwd and rms_bwd (with and without dres) against their plain
    versions, rms_bwd twice for the same bits; with ``shift`` every input
    one element past a 16-byte boundary. Returns (errors by kernel,
    inputs) for timing."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    scale = 1 + 0.1 * torch.randn(d, device="cuda", generator=g)
    dy = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    dres = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    if shift:
        x, scale, dy, dres = (_shifted(torch, t) for t in (x, scale, dy, dres))
    tag = (f"[{rows}x{d} {str(dtype).split('.')[-1]}"
           f"{' unaligned' if shift else ''}]")
    y, rstd = fn.rms_fwd(x, scale)
    y_r, rstd_r = fn.ref_rms_fwd(x, scale)
    errs = {"rms_fwd": max(
        compare(torch, f"rms_fwd y {tag}", y, y_r, 1e-5, failures),
        compare(torch, f"rms_fwd rstd {tag}", rstd, rstd_r, 1e-5, failures))}
    errs["rms_bwd"] = 0.0
    for res in (None, dres):
        dx, dscale = fn.rms_bwd(x, rstd_r, scale, dy, res)
        dx_r, dscale_r = fn.ref_rms_bwd(x, rstd_r, scale, dy, res)
        case = f"{tag}{' +dres' if res is not None else ''}"
        e = [compare(torch, f"rms_bwd dx {case}", dx, dx_r, 1e-4, failures)]
        if dtype == torch.float32:
            e.append(compare(torch, f"rms_bwd dscale {case}", dscale,
                             dscale_r, 1e-4, failures))
        else:
            e.append(float((dscale - dscale_r).abs().max()))
            c = cosine(dscale, dscale_r)
            if not c > 0.9999:
                failures.append(f"rms_bwd dscale {case}: cosine {c}")
        errs["rms_bwd"] = max(errs["rms_bwd"], *e)
        again = fn.rms_bwd(x, rstd_r, scale, dy, res)
        if not (torch.equal(dx, again[0]) and torch.equal(dscale, again[1])):
            failures.append(f"rms_bwd {case}: two calls differ")
    torch.cuda.synchronize()
    return errs, dict(x=x, scale=scale, dy=dy, dres=dres, rstd=rstd_r)


def check_gelu(torch, fn, n, dtype, failures, seed):
    """gelu_fwd and gelu_bwd alone against their plain versions on n
    elements, aligned and on views one element past a 16-byte boundary."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (2 * torch.randn(n + 1, device="cuda", generator=g)).to(dtype)
    dy = torch.randn(n + 1, device="cuda", generator=g).to(dtype)
    for shift in (0, 1):
        xs, gs = x[shift:shift + n], dy[shift:shift + n]
        tag = f"[n={n} {str(dtype).split('.')[-1]} shift {shift}]"
        compare(torch, f"gelu_fwd {tag}", fn.gelu_fwd(xs), fn.ref_gelu(xs),
                1e-5, failures)
        compare(torch, f"gelu_bwd {tag}", fn.gelu_bwd(xs, gs),
                fn.ref_gelu_bwd(xs, gs), 1e-4, failures)
    torch.cuda.synchronize()


def time_rms(torch, fn, inp, spec, flush):
    """{rms_fwd, rms_bwd: {ms, plain_ms, library_ms, bound_ms, ...}}. The
    yardstick is ``F.rms_norm`` (weight in the input's dtype) and its
    autograd backward for (x, weight), which has no dres add. The bound
    counts each input read once and each output written once: rms_bwd's
    dscale is [D]; the partial rows it writes, one per block of
    ``rt_rms_bwd_rows_per_block()`` = 64 rows, and reads back to sum them
    are not counted."""
    F = torch.nn.functional
    x, scale, dy, dres, rstd = (inp[k] for k in ("x", "scale", "dy", "dres",
                                                 "rstd"))
    rows, d = x.shape
    es = x.element_size()
    w_l = scale.to(x.dtype)
    x_l = x.detach().requires_grad_(True)
    w_g = w_l.detach().requires_grad_(True)
    y_l = F.rms_norm(x_l, (d,), w_g, fn.RMS_EPS)
    cases = {
        "rms_fwd": (lambda: fn.rms_fwd(x, scale),
                    lambda: fn.ref_rms_fwd(x, scale),
                    lambda: F.rms_norm(x, (d,), w_l, fn.RMS_EPS),
                    2 * rows * d * es + rows * 4 + d * 4, 4 * rows * d),
        "rms_bwd": (lambda: fn.rms_bwd(x, rstd, scale, dy, dres),
                    lambda: fn.ref_rms_bwd(x, rstd, scale, dy, dres),
                    lambda: torch.autograd.grad(y_l, (x_l, w_g), dy,
                                                retain_graph=True),
                    4 * rows * d * es + rows * 4 + 2 * d * 4, 10 * rows * d),
    }
    return {name: {"ms": device_ms(kern, flush),
                   "plain_ms": device_ms(plain, flush),
                   "library_ms": device_ms(lib, flush),
                   **bound(nbytes, ops, spec, "fp32_flops")}
            for name, (kern, plain, lib, nbytes, ops) in cases.items()}


def bound(nbytes, ops, spec, rate):
    """The least time for ``nbytes`` of device-memory traffic and ``ops``
    operations at the ``rate`` peak: the larger of the two, and which."""
    t_bytes = nbytes / spec["hbm_bytes_s"] * 1e3
    t_ops = ops / spec[rate] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops}


def check_flash(torch, fa, case, failures, seed, packed=True):
    """Each flash kernel against its plain version at one shape; returns
    (max abs error by kernel, inputs) for timing."""
    b, t, h, d, causal = case
    q, k, v, do = flash_inputs(b, t, h, d, seed, packed)
    kw = dict(softmax_scale=d ** -0.5, causal=causal)
    tag = f"[B={b} T={t} H={h} D={d} {'causal' if causal else 'full'}]"
    out, lse = fa.flash_fwd(q, k, v, **kw)
    out_r, lse_r = fa.ref_flash_fwd(q, k, v, **kw)
    delta = fa.flash_delta(out_r, do)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_r, delta, **kw)
    dq = fa.flash_dq(q, k, v, do, lse_r, delta, **kw)
    dq_r, dk_r, dv_r = fa.ref_flash_bwd(q, k, v, out_r, lse_r, do, **kw)
    torch.cuda.synchronize()
    lse_err = float((lse - lse_r).abs().max())
    lse_tol = 1e-4 * max(1.0, float(lse_r.abs().max()))
    if not lse_err <= lse_tol:
        failures.append(f"flash_fwd lse {tag}: max abs err {lse_err:.3e} > "
                        f"{lse_tol:.3e}")
    errs = {}
    for kname, pairs in (("flash_fwd", (("out", out, out_r),)),
                         ("flash_dkv", (("dk", dk, dk_r), ("dv", dv, dv_r))),
                         ("flash_dq", (("dq", dq, dq_r),))):
        errs[kname] = lse_err if kname == "flash_fwd" else 0.0
        for oname, got, want in pairs:
            err = float((got.float() - want.float()).abs().max())
            errs[kname] = max(errs[kname], err)
            if t == 1 and oname in ("dq", "dk"):
                # One key: dS is 0 up to the rounding of dO.V - delta, so
                # both versions are that noise; no cosine is defined.
                if not err <= 2e-3:
                    failures.append(f"{kname} {oname} {tag}: max abs err "
                                    f"{err:.3e} > 2e-3")
                continue
            cos = cosine(got, want)
            if not cos > 0.9999:
                failures.append(f"{kname} {oname} {tag}: cosine {cos:.6f}, "
                                f"max abs err {err:.3e}")
    print(f"flash check {tag}: lse err {lse_err:.2e}, max abs err "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    return errs, dict(q=q, k=k, v=v, do=do, lse=lse_r, delta=delta,
                      out=out_r, kw=kw)


def time_flash(torch, fa, inp, spec, flush):
    """{kernel: {ms, host_us, plain_ms, library_ms, bound_ms, bound_by,
    ...}} at the inputs' shape; host_us is the wrapper's host cost per call
    (``host_us``). The yardstick is ``scaled_dot_product_attention``:
    its forward for flash_fwd, its backward (dq, dk, dv and its own delta)
    for both flash_dkv and flash_dq."""
    F = torch.nn.functional
    q, k, v, do, lse, delta, kw = (inp[x] for x in ("q", "k", "v", "do",
                                                    "lse", "delta", "kw"))
    b, t, h, d = q.shape
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    leaves = [x.detach().requires_grad_(True) for x in (qh, kh, vh)]
    o_l = F.scaled_dot_product_attention(*leaves, is_causal=kw["causal"])
    do_h = do.transpose(1, 2)
    sdpa_bwd = device_ms(lambda: torch.autograd.grad(
        o_l, leaves, do_h, retain_graph=True), flush)
    # The (q, k) pairs the causal mask keeps, or all of them.
    pairs = t * (t + 1) // 2 if kw["causal"] else t * t
    bh, act, stat = b * h, b * t * h * d * 2, b * h * t * 4
    cases = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                      lambda: fa.ref_flash_fwd(q, k, v, **kw),
                      lambda: F.scaled_dot_product_attention(
                          qh, kh, vh, is_causal=kw["causal"]),
                      4 * act + stat, 4 * bh * pairs * d),
        "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, **kw),
                      lambda: fa.ref_flash_dkv(q, k, v, do, lse, delta, **kw),
                      None, 6 * act + 2 * stat, 8 * bh * pairs * d),
        "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, **kw),
                     lambda: fa.ref_flash_dq(q, k, v, do, lse, delta, **kw),
                     None, 5 * act + 2 * stat, 6 * bh * pairs * d),
    }
    return {name: {
        "ms": device_ms(kern, flush),
        "host_us": host_us(kern),
        "plain_ms": device_ms(plain, flush),
        "library_ms": device_ms(lib, flush) if lib else sdpa_bwd,
        "library": ("scaled_dot_product_attention forward" if lib else
                    "scaled_dot_product_attention backward (dq, dk, dv)"),
        **bound(nbytes, ops, spec, "bf16_flops")}
        for name, (kern, plain, lib, nbytes, ops) in cases.items()}


def time_crossover(torch, fa, dense, flush):
    """Forward plus backward device ms of dense and flash causal attention
    at each of CROSSOVER_SEQS (B=8, H=12, D=64, bf16). Timing only."""
    rows = []
    for t in CROSSOVER_SEQS:
        q, k, v, do = flash_inputs(BATCH, t, N_HEAD, 64, t)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        row = {"seq": t}
        for name, fn in (("dense_ms", dense), ("flash_ms",
                                                fa.flash_causal_attention)):
            row[name] = device_ms(lambda: torch.autograd.grad(
                fn(*leaves), leaves, do), flush, n=10)
        rows.append(row)
        print(f"attention fwd+bwd at T={t} (B*H=96, D=64, bf16): dense "
              f"{row['dense_ms']:.3f} ms, flash {row['flash_ms']:.3f} ms")
    return rows


# -- phase 3b ------------------------------------------------------------------


def _fold(torch, ra, xs, sp, packed):
    """q, k, v in the folded ring's layout; packed inputs stay strided
    views of one [sp * B, C, 3 * H * D] tensor, as each rank's qkv."""
    b, t, h, d = xs[0].shape
    if not packed:
        return [ra.fold_sequence(x, sp) for x in xs]
    qkv = ra.fold_sequence(torch.cat([x.reshape(b, t, h * d) for x in xs],
                                     -1), sp)
    return [x.reshape(sp * b, t // sp, h, d) for x in qkv.split(h * d, -1)]


def ring_phase(torch, fa, ra, counters, flush, smi):
    """Phase 3b: the single-process ring (``FoldedRing``, all ``sp``
    positions of a ring on one card) on the flash kernels at each of
    ``RING_CASES`` and ``RING_SPS``, bf16. The loss is ``mean(out ** 2)``
    and the gradients are of it. Held, with every kernel counter set to 0
    just before the ring's forward and backward and read just after:
    ``flash_fwd``, ``flash_dkv`` and ``flash_dq`` launched sp times each
    (``RING_LAUNCHES``); out, dq, dk and dv by cosine > 0.9999 and the
    global lse within 1e-4 * max(1, |lse|) of the same ring on the plain
    versions (phase 3's rules); and against one ``flash_causal_attention``
    over the whole T: the loss within rtol 1e-2, the whole gradient by
    cosine > 0.999. Prints the fwd+bwd device ms of the ring beside the
    one flash call's."""
    out = []
    for label, b, t, h, packed in RING_CASES:
        q, k, v, do = flash_inputs(b, t, h, 64, t + h, packed)
        for sp in RING_SPS:
            ring = ra.FoldedRing(sp)
            leaves = [x.detach().requires_grad_(True)
                      for x in _fold(torch, ra, (q, k, v), sp, packed)]
            do_f = ra.fold_sequence(do, sp)

            def ring_grads():
                o = ra.ring_flash_attention_local(*leaves, ring=ring)
                loss = o.float().pow(2).mean()
                return [loss.detach(), o.detach(),
                        *torch.autograd.grad(loss, leaves)]

            for c in counters:
                c.clear()
            got = ring_grads()
            torch.cuda.synchronize()
            launches = {k: sum(c[k] for c in counters) for k in FLASH_KERNELS}
            with plain_flash(fa):
                want = ring_grads()
                with torch.no_grad():
                    _, lse_p = ra._ring_flash_fwd(*leaves, ring, 64 ** -0.5)
            with torch.no_grad():
                _, lse_k = ra._ring_flash_fwd(*leaves, ring, 64 ** -0.5)
            full = [x.detach().requires_grad_(True) for x in (q, k, v)]
            o_full = fa.flash_causal_attention(*full)
            loss_full = o_full.float().pow(2).mean()
            g_full = torch.autograd.grad(loss_full, full)
            g_ring = [ra.unfold_sequence(g, sp) for g in got[2:]]
            torch.cuda.synchronize()
            tag = f"{label} [B={b} T={t} H={h} D=64] sp={sp}"
            cos = {n: cosine(a, w) for n, a, w in zip(
                ("out", "dq", "dk", "dv"), got[1:], want[1:])}
            lse_err = float((lse_k - lse_p).abs().max())
            lse_tol = 1e-4 * max(1.0, float(lse_p.abs().max()))
            loss_rel = abs(float(got[0]) - float(loss_full)) / float(loss_full)
            cos_full = cosine(torch.cat([g.flatten() for g in g_ring]),
                              torch.cat([g.flatten() for g in g_full]))
            ms = device_ms(lambda: torch.autograd.grad(
                ra.ring_flash_attention_local(*leaves, ring=ring), leaves,
                do_f), flush, n=10)
            ms_full = device_ms(lambda: torch.autograd.grad(
                fa.flash_causal_attention(*full), full, do), flush, n=10)
            row = {"case": label, "b": b, "t": t, "h": h, "sp": sp,
                   "launches": launches, "cosine_vs_plain": cos,
                   "lse_err": lse_err, "loss": float(got[0]),
                   "loss_flash_over_t": float(loss_full),
                   "loss_rel_diff": loss_rel, "grad_cosine_vs_flash": cos_full,
                   "ring_ms": ms, "flash_over_t_ms": ms_full}
            out.append(row)
            print(f"ring {tag} [{smi}]: launches {launches}; vs the plain "
                  f"ring: cosine {', '.join(f'{n} {c:.6f}' for n, c in cos.items())}"
                  f", lse err {lse_err:.2e}; vs one flash call over T: loss "
                  f"{float(got[0]):.6f} vs {float(loss_full):.6f} (rel "
                  f"{loss_rel:.2e}), gradient cosine {cos_full:.6f}; fwd+bwd "
                  f"ring {ms:.3f} ms (one process, sp x the batch a flash "
                  f"call), one flash call over T {ms_full:.3f} ms")
            require(launches == {k: sp for k in FLASH_KERNELS},
                    f"ring {tag}: launches {launches}, expected {sp} each")
            require(all(bool(torch.isfinite(x).all()) for x in got[1:]),
                    f"ring {tag}: non-finite output or gradient")
            require(all(c > 0.9999 for c in cos.values()),
                    f"ring {tag}: cosine to the plain ring {cos}")
            require(lse_err <= lse_tol, f"ring {tag}: lse err {lse_err:.3e} > "
                    f"{lse_tol:.3e}")
            require(loss_rel <= 1e-2, f"ring {tag}: loss off one flash call "
                    f"over T by {loss_rel:.3e}")
            require(cos_full > 0.999, f"ring {tag}: gradient cosine to one "
                    f"flash call over T {cos_full:.6f}")
            del leaves, full, got, want
    return out


# -- phase 4c and the pp=2 ranks ----------------------------------------------


def pipeline_launches(passes, layers: int, n_micro: int) -> dict:
    """Launches of one pipeline call of GPT-2's blocks on stages that each
    run a microbatch's blocks forward ``passes[i]`` times (the forward
    slot, the backward slot's recomputation, the dots remat's recompute
    inside its backward: 3; the last stage keeps no forward slot: 2) and
    backward once, ``layers`` blocks a stage."""
    fwd = n_micro * layers * sum(passes)
    bwd = n_micro * layers * len(passes)
    return {"ln_fwd": 2 * fwd, "ln_bwd": 2 * bwd, "gelu_fwd": fwd,
            "gelu_bwd": bwd, "rms_fwd": 0, "rms_bwd": 0, "flash_fwd": fwd,
            "flash_dkv": bwd, "flash_dq": bwd}


def _stage_passes(stages, pp: int) -> list:
    return [2 if s == pp - 1 else 3 for s in stages]


def _pipe_mse(o, y):
    return ((o.float() - y) ** 2).mean()


def pipeline_reference(torch, cfg):
    """GPT-2 small's blocks (``gpt2_init`` from seed 0), phase 4's batch
    (seed 1) embedded as the model embeds it, a target from seed 2, the
    stage function, and one ``value_and_grad`` of the 12 blocks in
    sequence on the whole batch (the mean of the microbatches' MSEs is the
    MSE over the batch)."""
    from ray_tpu_torch.models.gpt2 import gpt2_init, gpt2_stage_fn
    from ray_tpu_torch.train.train_step import value_and_grad

    dev = torch.device("cuda", torch.cuda.current_device())
    params = gpt2_init(torch.Generator(device=dev).manual_seed(0), cfg,
                       device=dev)
    gen = torch.Generator(device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, cfg.seq_len + 1),
                           device=dev, generator=gen.manual_seed(1))
    dt = cfg.dtype
    x = params["wte"].to(dt)[tokens[:, :-1]] + params["wpe"].to(dt)
    y = torch.randn(x.shape, device=dev, generator=gen.manual_seed(2))
    stage = gpt2_stage_fn(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = value_and_grad(lambda p, b: _pipe_mse(stage(p, b), y),
                                 params["blocks"], x)
    float(loss)
    ms = (time.perf_counter() - t0) * 1e3
    return params["blocks"], x, y, stage, float(loss), grads, ms


def _stage_flat(torch, grads, pp: int, s: int):
    """Stage ``s``'s part of [n_layer, ...] (or [pp, n_layer / pp, ...])
    gradient leaves, flattened in leaf order."""
    from ray_tpu_torch._tree import tree_leaves

    return torch.cat([g.reshape(pp, -1)[s] for g in tree_leaves(grads)])


def pipeline_phase(torch, counters, smi):
    """Phase 4c: GPT-2 small's 12 blocks (``FUSED_FLAGS``) as a 2-stage
    pipeline in one process (``pipeline_value_and_grad`` with
    ``mesh=None``: ``FoldedPipe``), 1F1B and GPipe, each against one
    ``value_and_grad`` of the blocks in sequence (loss rtol 1e-2, each
    stage's gradient cosine > 0.999), with every kernel counter set to 0
    just before and read just after (three calls: one warmup, two timed),
    each kernel launched ``pipeline_launches`` times a call."""
    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_stage_params
    from ray_tpu_torch.scripts.measure import FUSED_FLAGS, measure_pipeline

    cfg = GPT2Config(**FUSED_FLAGS)
    blocks, x, y, stage, ref_loss, ref_grads, ref_ms = pipeline_reference(
        torch, cfg)
    ref = [_stage_flat(torch, ref_grads, PIPE_PP, s) for s in range(PIPE_PP)]
    del ref_grads
    layers = cfg.n_layer // PIPE_PP
    expected = pipeline_launches(_stage_passes(range(PIPE_PP), PIPE_PP),
                                 layers, PIPE_MICRO)
    out = {"ref_loss": ref_loss, "ref_ms": ref_ms, "expected": expected}
    for style in ("1f1b", "gpipe"):
        for c in counters:
            c.clear()
        r = measure_pipeline(gpt2_stage_params(blocks, PIPE_PP), x, y, None,
                             stage_fn=stage, loss_fn=_pipe_mse,
                             n_micro=PIPE_MICRO, style=style, steps=2,
                             warmup=1, device="cuda")
        launches = {k: sum(c[k] for c in counters) / 3 for k in PORTED}
        grads = r.pop("grads")
        cos = [cosine(_stage_flat(torch, grads, PIPE_PP, s), ref[s])
               for s in range(PIPE_PP)]
        rel = abs(r["loss"] - ref_loss) / abs(ref_loss)
        r.update(launches=launches, stage_cosines=cos, loss_rel=rel)
        print(f"pipeline in one process ({style}, pp={PIPE_PP}, "
              f"{PIPE_MICRO} microbatches of [1, {cfg.seq_len}, "
              f"{cfg.d_model}] bf16, GPT-2 small's {cfg.n_layer} blocks) "
              f"[{smi}]: {r['ms']:.2f} ms a call ({r['ticks']} ticks, bubble "
              f"{r['bubble_frac']:.3f}), peak memory "
              f"{r['peak_memory_bytes'] / 2**30:.3f} GiB; the blocks in "
              f"sequence {ref_ms:.2f} ms; loss {r['loss']:.6f} vs "
              f"{ref_loss:.6f} (rel {rel:.2e}), stage gradient cosines "
              f"{[round(c, 6) for c in cos]}; launches a call {launches}")
        require(rel <= 1e-2, f"pipeline {style}: loss off by {rel:.3e}")
        require(all(c > 0.999 for c in cos),
                f"pipeline {style}: stage gradient cosines {cos}")
        require(launches == expected, f"pipeline {style}: launches a call "
                f"{launches}, expected {expected}")
        out[style] = r
        del grads
    return out


def two_rank_pipeline(torch, smi):
    """The pipeline of phase 4c over 2 NCCL ranks (this script with
    ``--pp-rank``; ``GroupPipe``, one stage a rank), 1F1B and GPipe, where
    there are two cards: each rank holds its stage's gradient against its
    part of the sequential blocks' (cosine > 0.999) and the loss against
    theirs (rtol 1e-2), and launches ``pipeline_launches`` for its stage.
    Otherwise one line saying why it did not run."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"pipeline over 2 ranks (pp=2, GPT-2 small's blocks): not run: "
              f"{n} CUDA device (needs 2)")
        return {"ran": False, "devices": n}
    from ray_tpu_torch.parallel.distributed import free_port

    result = OUT / "pipeline2.json"
    for r in range(2):
        result.with_suffix(f".rank{r}.json").unlink(missing_ok=True)
    address = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen([sys.executable, __file__, "--pp-rank", str(r),
                               "2", address, str(result)]) for r in range(2)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    require(rcs == [0, 0], f"pipeline over 2 ranks: ranks exited {rcs}")
    ranks = [json.loads(result.with_suffix(f".rank{r}.json").read_text())
             for r in range(2)]
    for i, rank in enumerate(ranks):
        for style in ("1f1b", "gpipe"):
            r = rank[style]
            print(f"pipeline over 2 ranks ({style}), rank {i} (stage {i}) "
                  f"[{rank['smi']}]: {r['ms']:.2f} ms a call, peak memory "
                  f"{r['peak_memory_bytes'] / 2**30:.3f} GiB; loss rel "
                  f"{r['loss_rel']:.2e}, stage gradient cosine "
                  f"{r['cosine']:.6f}; launches a call {r['launches']}")
            require(r["loss_rel"] <= 1e-2, f"pipeline over 2 ranks {style}: "
                    f"rank {i} loss off by {r['loss_rel']:.3e}")
            require(r["cosine"] > 0.999, f"pipeline over 2 ranks {style}: "
                    f"rank {i} gradient cosine {r['cosine']}")
            require(r["launches"] == rank["expected"],
                    f"pipeline over 2 ranks {style}: rank {i} launches "
                    f"{r['launches']}, expected {rank['expected']}")
    return {"ran": True, "ranks": ranks}


def pp_rank_main(rank: int, world: int, address: str, result: str) -> int:
    """One NCCL rank of ``two_rank_pipeline``: the sequential reference on
    this card, then both styles over the ``pp`` group, the counters zeroed
    just before each; writes this rank's result beside ``result``."""
    import torch

    from ray_tpu_torch._tree import tree_map
    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_stage_params
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import fused_norm as fn
    from ray_tpu_torch.parallel import distributed
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.parallel.sharding import NamedSharding, shard_pytree
    from ray_tpu_torch.scripts.measure import FUSED_FLAGS, measure_pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize("chip-smoke-pp", rank, world,
                           coordinator_address=address)
    try:
        mesh = build_mesh(MeshConfig(pp=world, fsdp=1))
        cfg = GPT2Config(**FUSED_FLAGS)
        blocks, x, y, stage, ref_loss, ref_grads, _ = pipeline_reference(
            torch, cfg)
        ref = _stage_flat(torch, ref_grads, world, rank)
        del ref_grads
        staged = gpt2_stage_params(blocks, world)
        params = shard_pytree(staged, tree_map(
            lambda v: NamedSharding(mesh, ("pp",) + (None,) * (v.dim() - 1)),
            staged), mesh)
        del blocks, staged
        torch.cuda.empty_cache()
        counters = (fn.KERNEL_INVOCATIONS, fa.KERNEL_INVOCATIONS)
        out = {"expected": pipeline_launches(
            _stage_passes([rank], world), cfg.n_layer // world, PIPE_MICRO)}
        for style in ("1f1b", "gpipe"):
            for c in counters:
                c.clear()
            r = measure_pipeline(params, x, y, mesh, stage_fn=stage,
                                 loss_fn=_pipe_mse, n_micro=PIPE_MICRO,
                                 style=style, steps=2, warmup=1,
                                 device="cuda")
            grads = r.pop("grads")
            mine = _stage_flat(torch, tree_map(lambda g: g.to_local(), grads),
                               1, 0)
            r.update(launches={k: sum(c[k] for c in counters) / 3
                               for k in PORTED},
                     cosine=cosine(mine, ref),
                     loss_rel=abs(r["loss"] - ref_loss) / abs(ref_loss))
            out[style] = r
            del grads, mine
    finally:
        distributed.shutdown()
    out["smi"] = subprocess.run(
        ["nvidia-smi", "-i", str(torch.cuda.current_device()),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    Path(result).with_suffix(f".rank{rank}.json").write_text(json.dumps(out))
    return 0


def run_step(torch, counters, label, measure, cfg, batch, warmup, steps,
             expected):
    """One measured train-step run with every kernel counter set to 0 just
    before it; returns the step dict with launches and launches per step,
    after checking the loss and the per-step launch counts."""
    for c in counters:
        c.clear()
    step = measure(cfg, batch, steps=steps, warmup=warmup, device="cuda")
    launches = {k: sum(c[k] for c in counters) for k in PORTED}
    step["max_memory_allocated"] = step["peak_memory_bytes"]
    step["launches"] = launches
    n_steps = step["warmup"] + steps
    step["launches_per_step"] = {k: launches[k] / n_steps for k in PORTED}
    losses = step["losses"]
    print(f"train step ({'flash' if cfg.use_flash else 'dense'} attention): "
          f"{label} {cfg.n_params / 1e6:.0f}M batch {batch} seq {cfg.seq_len}: "
          f"{step['tok_s']:.1f} tok/s, {step['ms_step']:.2f} ms/step, MFU "
          f"{step['mfu']:.2f}%, max_memory_allocated "
          f"{step['max_memory_allocated'] / 2**30:.2f} GiB, losses "
          f"{[round(x, 4) for x in losses]}, launches/step "
          f"{step['launches_per_step']}")
    require(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for k, want in expected.items():
        got = step["launches_per_step"][k]
        require(got == want, f"{k}: {got} launches per step, expected {want}")
    return step


def compare_paths(torch, loss_fn, params, tokens, paths, contexts=None,
                  loss_only=()):
    """Loss and whole-tree gradient of every path in ``paths`` (name ->
    config, run in that order, each inside ``contexts[name]()`` where
    given) on the same weights and batch; each path other than "plain"
    against "plain": loss within rtol 1e-2, and, unless the path is in
    ``loss_only``, gradient cosine > 0.999."""
    from ray_tpu_torch._tree import tree_leaves
    from ray_tpu_torch.train.train_step import value_and_grad

    contexts = contexts or {}
    out = {}
    for pname, c in paths.items():
        with contexts.get(pname, contextlib.nullcontext)():
            loss, grads = value_and_grad(lambda p, b: loss_fn(p, b, c),
                                         params, {"tokens": tokens})
        leaves = tree_leaves(grads)
        require(all(a.shape == p.shape for a, p in zip(leaves,
                                                       tree_leaves(params))),
                f"{pname}: gradient shapes differ from the parameters'")
        require(all(bool(torch.isfinite(a).all()) for a in leaves),
                f"{pname}: non-finite gradients")
        out[pname] = (float(loss), torch.cat([a.flatten() for a in leaves]))
        del grads, leaves
    loss_p, flat_p = out.pop("plain")
    report = {}
    for pname, (loss_k, flat_k) in out.items():
        cos = cosine(flat_k, flat_p)
        rel = abs(loss_k - loss_p) / abs(loss_p)
        report[pname] = {"loss_kernel": loss_k, "loss_plain": loss_p,
                         "loss_rel_diff": rel, "grad_cosine": cos}
        print(f"{pname} vs plain path: loss {loss_k:.6f} vs {loss_p:.6f} "
              f"(rel {rel:.2e}), gradient cosine {cos:.6f}"
              f"{' (printed, not held)' if pname in loss_only else ''}")
        require(rel <= 1e-2, f"{pname}: losses differ by {rel:.3e} (rtol 1e-2)")
        if pname not in loss_only:
            require(cos > 0.999, f"{pname}: gradient cosine {cos} <= 0.999")
    return report


def compare_moe_paths(torch, loss_fn, params, tokens, cfg):
    """The MoE on flash against dense attention (phase 6). Its router's
    top-k is a discrete choice: a bf16 rounding difference in attention
    moves a token whose k-th and (k+1)-th probabilities nearly tie to
    another expert, and shifts the buffer slots (so the drops) of the
    tokens after it. So the whole-tree gradient is held (cosine > 0.999)
    with the plain path's choices replayed in the flash path -- the gates
    still the flash path's own probabilities of those experts -- and the
    free-running flash path is held on its loss alone, its gradient cosine
    and the token-layers it routes differently printed."""
    from ray_tpu_torch.ops import moe as moe_ops

    top_k = moe_ops._top_k
    routes = {"plain": [], "moe flash": []}

    @contextlib.contextmanager
    def patched(fn):
        moe_ops._top_k = fn
        try:
            yield
        finally:
            moe_ops._top_k = top_k

    def recording(name):
        def rec(probs, k):
            values, idx = top_k(probs, k)
            routes[name].append(idx)
            return values, idx
        return patched(rec)

    def replaying():
        recorded = iter(routes["plain"])

        def rep(probs, k):
            idx = next(recorded)
            return probs.gather(1, idx), idx
        return patched(rep)

    report = compare_paths(
        torch, loss_fn, params, tokens,
        {"plain": dataclasses.replace(cfg, use_flash=False),
         "moe flash": cfg, "moe flash, plain routes": cfg},
        contexts={"plain": lambda: recording("plain"),
                  "moe flash": lambda: recording("moe flash"),
                  "moe flash, plain routes": replaying},
        loss_only=("moe flash",))
    # The forward's choices: the first n_layer calls (the recompute's
    # repeat them).
    pairs = list(zip(routes["plain"], routes["moe flash"]))[:cfg.n_layer]
    moved = sum(int((a.sort(dim=1).values != b.sort(dim=1).values)
                    .any(dim=1).sum()) for a, b in pairs)
    rows = sum(a.shape[0] for a, _ in pairs)
    report["moe flash"]["token_layers_routed_differently"] = moved
    report["moe flash"]["token_layers"] = rows
    print(f"moe flash vs plain path: {moved} of {rows} token-layers choose "
          f"other experts ({moved / rows:.3%})")
    return report


def serve_phase(torch, counters, smi, models=("gpt2", "llama")):
    """Phase 7: both serving engines at full width (or those of
    ``models``), each with the kernel counters zeroed just before it and
    read just after, then the fp32 copies against the naive loop. Returns
    the report entries."""
    import gc

    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.scripts.measure import (SERVE_ENGINES, measure_serve,
                                               serve_prompts, serve_vs_naive,
                                               served_vs_fp32)

    out = {}
    for model, cfg in (("gpt2", GPT2Config.small()),
                       ("llama", LlamaConfig.small())):
        if model not in models:
            continue
        for c in counters:
            c.clear()
        r = measure_serve(model, "small", requests=SERVE_REQUESTS,
                          max_new_tokens=SERVE_NEW_TOKENS, device="cuda")
        r["kernel_launches"] = {k: sum(c[k] for c in counters)
                                for k in PORTED}
        gve = r["graph_vs_eager"]
        require(r["decode_tok_s_full"] is not None,
                f"serving {model}: no sample saw every slot busy")
        print(f"serving {model} {cfg.n_params / 1e6:.0f}M {r['dtype']}, "
              f"{r['max_batch']} slots, cache {r['cache_len']}, prefill "
              f"{r['prefill_rows']}x{r['max_prompt_len']}, "
              f"{SERVE_REQUESTS} requests x {SERVE_NEW_TOKENS} tokens "
              f"[{smi}]: decode {r['decode_tok_s_full']:.1f} tok/s at full "
              f"occupancy ({r['full_window_steps']} steps), "
              f"{r['serve_tok_s']:.1f} tok/s over the run "
              f"({r['wall_s']:.2f} s); decode step {r['step_ms_graph']:.3f} "
              f"ms graph / {r['step_ms_eager']:.3f} ms eager; prefill lane "
              f"{r['prefill_ms_graph']:.3f} / {r['prefill_ms_eager']:.3f} ms; "
              f"TTFT p50 {r['ttft_ms_p50']:.1f} ms p99 "
              f"{r['ttft_ms_p99']:.1f} ms; peak memory "
              f"{r['peak_memory_bytes'] / 2**30:.2f} GiB; build "
              f"{r['build_s']:.1f} s")
        print(f"serving {model} [{smi}]: compiles {r['compiles']}, "
              f"tokens/request "
              f"{sorted(set(r['tokens_per_request']))}, graph vs eager step: "
              f"tokens equal {gve['tokens_equal']}, logits max abs diff "
              f"{gve['logits_max_abs_diff']:.3e}, kernel launches "
              f"{sum(r['kernel_launches'].values())}")
        require(not r["errors"] and all(
            n == SERVE_NEW_TOKENS for n in r["tokens_per_request"]),
            f"serving {model}: tokens per request {r['tokens_per_request']}, "
            f"errors {r['errors']}")
        require(r["compiles"] == {"decode": 1, "prefill": 1},
                f"serving {model}: compiles {r['compiles']}")
        require(gve["tokens_equal"],
                f"serving {model}: graph and eager decode tokens differ")
        require(not any(r["kernel_launches"].values()),
                f"serving {model} launched kernels: {r['kernel_launches']}")
        gc.collect()
        torch.cuda.empty_cache()
        prompts = serve_prompts(NAIVE_PROMPTS, cfg.vocab_size,
                                SERVE_ENGINES[model]["max_prompt_len"])
        served = served_vs_fp32(model, cfg, prompts=prompts, device="cuda")
        print(f"serving {model} {r['dtype']} vs its fp32 copy [{smi}]: "
              f"logits cosine prefill {served['prefill_cosine']:.6f}, "
              f"decode {served['decode_cosine']:.6f}; K/V cache relative "
              f"error {served['cache_rel_err']:.3e}; first tokens agree "
              f"{served['first_agree']}/{served['n']}, next "
              f"{served['next_agree']}/{served['n']}")
        require(min(served["prefill_cosine"], served["decode_cosine"])
                > SERVED_COSINE, f"serving {model}: {r['dtype']} logits "
                f"cosine to fp32 <= {SERVED_COSINE}: {served}")
        require(served["cache_rel_err"] < SERVED_CACHE_REL,
                f"serving {model}: {r['dtype']} K/V cache relative error "
                f"to fp32 >= {SERVED_CACHE_REL}: {served}")
        r["vs_fp32"] = served
        naive = serve_vs_naive(
            model, dataclasses.replace(cfg, dtype=torch.float32),
            prompts=prompts, n_tokens=NAIVE_TOKENS, device="cuda")
        print(f"serving {model} fp32 vs naive loop [{smi}]: match "
              f"{naive['match']}, "
              f"{naive['compared']} of {NAIVE_PROMPTS * NAIVE_TOKENS} tokens "
              f"compared, smallest top-2 logit gap {naive['min_gap']:.3e}")
        require(naive["match"], f"serving {model}: engine tokens differ "
                f"from the naive loop: {naive['prompts']}")
        r["vs_naive_fp32"] = naive
        out[model] = r
        gc.collect()
        torch.cuda.empty_cache()
    return out


def trainer_phase(torch, counters, cfg, ref, smi):
    """Phase 4b: ``measure_trainer_gpt2`` -- phase 4's GPT-2 flash run
    (``ref``: same config, init and batch) through ``CudaTrainer(...).fit()``
    with every kernel counter set to 0 just before it and read just after.
    Holds: each kernel's launches, those of phase 4's steps plus one step
    for ``step_cost``'s counted call; the losses; the session's MFU gauge
    against ``step_cost``'s FLOPs over the trainer's own ms/step (the
    interval between its reports) within 5%, and each step's gauge
    against those FLOPs over its host and compute phases (phase 4's MFU,
    on the analytic count and on ``step_cost``'s, is printed beside
    them, not held: the trainer's step is not phase 4's); the FLOP
    count of the kernel path against the plain path's (dense attention,
    plain norms) on the same state and batch; ``device_telemetry``
    naming the card; and a run that raises before step 3, restarts from
    its step-2 checkpoint and gives phase 4's losses. Returns the
    report entry."""
    from ray_tpu_torch.models.gpt2 import gpt2_init, gpt2_loss
    from ray_tpu_torch._device import peak_flops_per_chip
    from ray_tpu_torch.scripts.measure import measure_trainer_gpt2
    from ray_tpu_torch.train.train_step import make_init_fn, make_train_step
    from ray_tpu_torch.util import device_telemetry
    from ray_tpu_torch.util.xla_cost import step_cost

    n_steps = WARMUP + STEPS
    for c in counters:
        c.clear()
    run = measure_trainer_gpt2(cfg, BATCH, steps=n_steps, warmup=WARMUP,
                               device="cuda")
    launches = {k: sum(c[k] for c in counters) for k in PORTED}
    run["launches"] = launches
    calls = n_steps + 1  # the steps, and step_cost's call of the step
    gaps = [abs(a - b) / abs(b) for a, b in zip(run["losses"], ref["losses"])]
    same_flops_mfu = ref["mfu"] * run["flops_ratio"]
    peak = peak_flops_per_chip(torch.cuda.get_device_name(0))
    own_clock_mfu = (run["step_cost"]["flops"] / (run["ms_step"] / 1e3)
                     / peak * 100)
    run["own_clock_mfu"] = own_clock_mfu
    mem = run["peak_memory_bytes"] / 2**30
    print(f"trainer: CudaTrainer(...).fit(), GPT-2 {cfg.n_params / 1e6:.0f}M "
          f"batch {BATCH} seq {cfg.seq_len}, 1 worker [{smi}]: "
          f"{run['ms_step']:.2f} ms/step ({run['tok_s']:.1f} tok/s), peak "
          f"memory {mem:.2f} GiB; measure_gpt2 {ref['ms_step']:.2f} ms/step "
          f"({ref['tok_s']:.1f} tok/s), peak memory "
          f"{ref['peak_memory_bytes'] / 2**30:.2f} GiB; gap "
          f"{run['ms_step'] / ref['ms_step'] - 1:+.2%}; fit {run['wall_s']:.2f}"
          f" s; losses {[round(x, 4) for x in run['losses']]}, largest "
          f"relative gap to phase 4 {max(gaps):.3e}")
    print(f"trainer: step_cost {run['step_cost']['flops'] / 1e12:.4f} TFLOP "
          f"a step ({run['step_cost']['flops_by_op']}), analytic "
          f"{run['analytic_flops'] / 1e12:.4f}, ratio {run['flops_ratio']:.4f};"
          f" MFU gauge {run['mfu_gauge']:.3f}%, step_cost's FLOPs over the "
          f"trainer's ms/step {own_clock_mfu:.3f}% (ratio "
          f"{run['mfu_gauge'] / own_clock_mfu:.4f}); measure_gpt2's MFU "
          f"{ref['mfu']:.3f}% (analytic FLOPs), {same_flops_mfu:.3f}% on "
          f"step_cost's FLOPs; per step (host, compute, sync s): "
          f"{[(round(a['host'], 4), round(a['compute'], 4), round(a['sync'], 4)) for a in run['anatomy']]}")
    print(f"trainer: launches through the trainer {launches} over {calls} "
          f"calls of the step ({n_steps} steps, 1 in step_cost)")
    require(all(math.isfinite(x) for x in run["losses"]),
            f"trainer: non-finite loss {run['losses']}")
    require(run["steps_run"] == list(range(1, n_steps + 1)),
            f"trainer: reported steps {run['steps_run']}")
    require(max(gaps) <= 1e-5, f"trainer: losses off phase 4's by "
            f"{max(gaps):.3e} (rtol 1e-5)")
    for k in PORTED:
        want = ref["launches_per_step"][k] * calls
        require(launches[k] == want,
                f"trainer: {k} launched {launches[k]} times, expected {want}")
    require(abs(run["mfu_gauge"] / own_clock_mfu - 1) <= 0.05,
            f"trainer: MFU gauge {run['mfu_gauge']:.3f}% vs "
            f"{own_clock_mfu:.3f}% from step_cost's FLOPs over the "
            f"trainer's {run['ms_step']:.2f} ms/step (> 5%)")
    # The gauge's own arithmetic: step_cost's FLOPs over each step's host +
    # compute phases, against the card's peak.
    for a in run["anatomy"]:
        want = run["step_cost"]["flops"] / (a["host"] + a["compute"]) / peak
        require(abs(a["mfu"] - want * 100) <= 1e-6 * a["mfu"],
                f"trainer: step {a['step']} MFU gauge {a['mfu']} vs "
                f"{want * 100} from its phases")

    # The FLOP count of the kernel path against the plain path's.
    gen = torch.Generator(device="cuda")
    state = make_init_fn(lambda g: gpt2_init(g, cfg, device="cuda"))(
        gen.manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, cfg.seq_len + 1),
                           device="cuda", generator=gen.manual_seed(1))
    plain = dataclasses.replace(cfg, use_flash=False, fused_norm=False)
    counts = {}
    for name, c in (("kernel", cfg), ("plain", plain)):
        step_fn = make_train_step(lambda p, b, c=c: gpt2_loss(p, b, c))
        counts[name] = step_cost(step_fn, state, {"tokens": tokens})["flops"]
    del state
    rel = abs(counts["kernel"] / counts["plain"] - 1)
    run["flops_kernel_vs_plain"] = {**counts, "rel": rel}
    print(f"trainer: step_cost of the kernel path {counts['kernel']:.6e} "
          f"FLOP, of the plain path {counts['plain']:.6e} (rel {rel:.2e})")
    require(rel <= 0.01, f"trainer: kernel path counts {counts['kernel']} "
            f"FLOP, plain path {counts['plain']} (> 1%)")

    snap = device_telemetry.snapshot()
    run["telemetry"] = snap
    name = torch.cuda.get_device_name(0)
    print(f"trainer: device_telemetry.snapshot(): "
          f"{[(d['device_kind'], d.get('bytes_in_use')) for d in snap['devices']]}")
    require(snap["available"] and snap["devices"]
            and snap["devices"][0]["device_kind"] == name,
            f"trainer: device_telemetry names {snap['devices']}, not {name}")

    rerun = measure_trainer_gpt2(cfg, BATCH, steps=n_steps, warmup=WARMUP,
                                 fail_at=3, device="cuda")
    rgaps = [abs(a - b) / abs(b)
             for a, b in zip(rerun["losses"], ref["losses"])]
    print(f"trainer: raised before step 3, restarted {rerun['restarts']} "
          f"time(s) from the step-2 checkpoint: steps {rerun['steps_run']}, "
          f"losses {[round(x, 4) for x in rerun['losses']]}, largest "
          f"relative gap to phase 4 {max(rgaps):.3e}; downtime "
          f"{rerun['goodput']['downtime_s']} s")
    require(rerun["restarts"] == 1
            and rerun["steps_run"] == list(range(1, n_steps + 1)),
            f"trainer restart: {rerun['restarts']} restarts, steps "
            f"{rerun['steps_run']}")
    require(max(rgaps) <= 1e-5, f"trainer restart: losses off phase 4's by "
            f"{max(rgaps):.3e} (rtol 1e-5)")
    run["restart"] = {k: rerun[k] for k in ("losses", "steps_run",
                                            "restarts", "goodput")}
    return run


def ingest_dataset(torch, cfg, n_steps: int):
    """Phase 8a's Dataset: phase 4b's seed-1 token batch, moved to the host
    once, one copy a step over ``n_steps`` blocks, through
    ``map_batches(as_tokens)``. Returns (the dataset, the batch)."""
    import numpy as np

    from ray_tpu_torch import data
    from ray_tpu_torch.scripts.measure import as_tokens

    tokens = torch.randint(
        0, cfg.vocab_size, (BATCH, cfg.seq_len + 1), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(1)).cpu().numpy()
    ds = data.from_numpy(np.tile(tokens, (n_steps, 1)),
                         parallelism=n_steps).map_batches(as_tokens)
    return ds, tokens


def ingest_phase(torch, counters, cfg, trainer, smi):
    """Phase 8a: ``measure_trainer_gpt2(dataset=ds)`` -- phase 4b's run
    (``trainer``) with each step's batch read from a Dataset through
    ``session.get_dataset_shard("train").iter_device_batches(batch_size=8)``,
    with every kernel counter set to 0 just before it and read just after.
    ``ds`` holds phase 4b's seed-1 token batch, moved to the host once, one
    copy a step (6 x 8 rows of 1025 tokens over 6 blocks), through
    ``map_batches(as_tokens)``. Holds: the losses against phase 4b's
    (rtol 1e-5), the seven kernels' launches equal to phase 4b's (the same
    calls of the step), every batch int64 on cuda:0, and the client's
    stall fraction (time inside ``next()`` over the loop's wall) within
    0.10 of the one ``ray_tpu_data_iter_seconds`` gives, and that
    histogram's wait seconds (one sample a batch) within 20% + 0.3 ms of
    the client's (the stall fractions are near 0 here, where 0.10 would
    pass a wait never recorded). The step's
    trained parameters are kept (the step-6 checkpoint) for phase 8b.
    Returns the report entry and the parameters as numpy arrays."""
    from ray_tpu_torch.models.convert import params_to_numpy
    from ray_tpu_torch.scripts.measure import measure_trainer_gpt2
    from ray_tpu_torch.train.checkpoint import load_sharded

    n_steps = WARMUP + STEPS
    ds, _ = ingest_dataset(torch, cfg, n_steps)
    ckpt_dir = OUT / "ingest_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    for c in counters:
        c.clear()
    run = measure_trainer_gpt2(cfg, BATCH, steps=n_steps, warmup=WARMUP,
                               device="cuda", dataset=ds,
                               ckpt_dir=str(ckpt_dir))
    launches = {k: sum(c[k] for c in counters) for k in PORTED}
    run["launches"] = launches
    state = load_sharded(str(ckpt_dir / f"step{n_steps}"))
    params = params_to_numpy(state["params"])
    del state
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    feed = run["data"]
    gaps = [abs(a - b) / abs(b)
            for a, b in zip(run["losses"], trainer["losses"])]
    data_wait = [a["data_wait"] for a in run["anatomy"]]
    xfer = feed["iter"]["transfer"]
    stall_gap = abs(feed["client_stall"] - feed["server_stall"])
    wait_tol = 0.2 * feed["client_wait_s"] + 3e-4
    wait_gap = abs(feed["iter"]["wait"]["sum_s"] - feed["client_wait_s"])
    mem = run["peak_memory_bytes"] / 2**30
    print(f"ingest: Dataset -> iter_device_batches -> CudaTrainer, GPT-2 "
          f"{cfg.n_params / 1e6:.0f}M batch {BATCH} seq {cfg.seq_len}, "
          f"{feed['batches']} batches over {ds.num_blocks} blocks "
          f"[{smi}]: {run['ms_step']:.2f} ms/step ({run['tok_s']:.1f} tok/s)"
          f" vs phase 4b's fixed batch {trainer['ms_step']:.2f} ms/step (gap "
          f"{run['ms_step'] / trainer['ms_step'] - 1:+.2%}); peak memory "
          f"{mem:.2f} GiB (phase 4b {trainer['peak_memory_bytes'] / 2**30:.2f}"
          f" GiB); losses {[round(x, 4) for x in run['losses']]}, largest "
          f"relative gap to phase 4b {max(gaps):.3e}; batches {feed['devices']}")
    print(f"ingest: data_wait per step from the session's anatomy (s) "
          f"{[round(w, 6) for w in data_wait]}; ray_tpu_data_iter_seconds "
          f"wait {feed['iter']['wait']['sum_s'] / max(1, feed['batches']):.6f}"
          f" s, transfer {xfer['sum_s'] / max(1, xfer['count']):.6f} s a "
          f"batch over {xfer['count']} copies; stall fraction client "
          f"{feed['client_stall']:.6f} (wait {feed['client_wait_s']:.6f} s of "
          f"{feed['loop_wall_s']:.4f} s), metrics {feed['server_stall']:.6f}, "
          f"gap {stall_gap:.6f}; wait seconds client "
          f"{feed['client_wait_s']:.6f}, metrics "
          f"{feed['iter']['wait']['sum_s']:.6f} over "
          f"{feed['iter']['wait']['count']} samples, gap {wait_gap:.6f} "
          f"(limit {wait_tol:.6f})")
    print(f"ingest: launches {launches} over {n_steps + 1} calls of the step")
    require(run["steps_run"] == list(range(1, n_steps + 1)),
            f"ingest: reported steps {run['steps_run']}")
    require(max(gaps) <= 1e-5, f"ingest: losses off phase 4b's by "
            f"{max(gaps):.3e} (rtol 1e-5)")
    for k in PORTED:
        require(launches[k] == trainer["launches"][k],
                f"ingest: {k} launched {launches[k]} times, phase 4b "
                f"{trainer['launches'][k]}")
    require([tuple(d) for d in feed["devices"]] == [("cuda:0", "torch.int64")]
            and feed["batches"] == n_steps,
            f"ingest: {feed['batches']} batches as {feed['devices']}")
    require(xfer["count"] == n_steps,
            f"ingest: {xfer['count']} transfers recorded for {n_steps} batches")
    require(feed["server_stall"] is not None and stall_gap <= 0.10,
            f"ingest: stall fraction client {feed['client_stall']} vs metrics "
            f"{feed['server_stall']} (> 0.10 apart)")
    require(feed["iter"]["wait"]["count"] == n_steps and wait_gap <= wait_tol,
            f"ingest: the metrics' wait {feed['iter']['wait']['sum_s']} s over "
            f"{feed['iter']['wait']['count']} samples vs the client's "
            f"{feed['client_wait_s']} s over {n_steps} batches (limit "
            f"{wait_tol:.6f} s apart)")
    return run, params


def predict_tokens(torch, cfg):
    """Phase 8b's rows: PREDICT_ROWS rows of ``seq_len + 1`` seed-2 tokens,
    drawn on the card (numpy)."""
    return torch.randint(
        0, cfg.vocab_size, (PREDICT_ROWS, cfg.seq_len + 1), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(2)).cpu().numpy()


def batch_predict_phase(torch, counters, cfg, params, smi, forward=None):
    """Phase 8b: ``BatchPredictor.from_checkpoint(Checkpoint.from_dict(
    {"params": params}), CudaPredictor, apply_fn=gpt2_score)`` scoring
    PREDICT_ROWS rows of 1025 seed-2 tokens with an ``id`` column at
    ``batch_size=PREDICT_BATCH`` on one actor (``measure_batch_predict_gpt2``),
    with every kernel counter set to 0 just before ``predict`` and read just
    after. Holds: every id back once; each row's NLL bit for bit equal to a
    direct ``gpt2_score`` call on the same rows and parameters; within rtol
    1e-3 of the plain path (dense attention, plain norms); every batch's
    logits (``gpt2_forward``), each token's centred on its mean over the
    vocabulary, within 0.05 relative error (Frobenius) and cosine > 0.999
    of the plain path's -- the mean NLL of a row hardly moves under a
    wrong kernel (a non-causal attention), its logits do; ``ln_fwd``,
    ``gelu_fwd`` and ``flash_fwd`` launched one forward's count a batch
    and no other kernel. Printed beside the end-to-end numbers: the
    predictor's build and its ``predict`` on the same numpy batches, out
    of the pool. Returns the report entry."""
    import functools

    import numpy as np

    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.models.gpt2 import gpt2_forward
    from ray_tpu_torch.scripts.measure import (gpt2_score,
                                               measure_batch_predict_gpt2)
    from ray_tpu_torch.train.batch_predictor import CudaPredictor
    from ray_tpu_torch.train.checkpoint import Checkpoint

    tokens = predict_tokens(torch, cfg)
    for c in counters:
        c.clear()
    res = measure_batch_predict_gpt2(cfg, params=params, tokens=tokens,
                                     batch_size=PREDICT_BATCH, device="cuda")
    launches = {k: sum(c[k] for c in counters) for k in PORTED}
    res["launches"] = launches
    n_batches = res["batches"]

    # What the layers under BatchPredictor cost, in the same call: the
    # predictor's build (the parameters' upload), its predict() on numpy
    # batches (the host conversions and the sync), the model alone.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predictor = CudaPredictor.from_checkpoint(
        Checkpoint.from_dict({"params": params}), apply_fn=functools.partial(
            gpt2_score, cfg=cfg), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    dev_params = params_from_numpy(params, "cuda")
    plain = dataclasses.replace(cfg, use_flash=False, fused_norm=False)
    direct, plain_nll, direct_s, predict_s = [], [], [], []
    logit_err, logit_cos = [], []

    def centred_logits(tokens, c):
        """Each token's fp64 logits less their mean over the vocabulary."""
        lg = gpt2_forward(dev_params, tokens[:, :-1], c).double()
        return lg - lg.mean(-1, keepdim=True)

    with torch.inference_mode():
        for i in range(0, PREDICT_ROWS, PREDICT_BATCH):
            rows = {"id": np.arange(i, i + PREDICT_BATCH),
                    "tokens": tokens[i:i + PREDICT_BATCH]}
            t0 = time.perf_counter()
            predictor.predict(rows)
            predict_s.append(time.perf_counter() - t0)
            batch = {"id": torch.arange(i, i + PREDICT_BATCH, device="cuda"),
                     "tokens": torch.from_numpy(
                         tokens[i:i + PREDICT_BATCH]).to("cuda")}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nll = gpt2_score(dev_params, batch, cfg)["nll"].cpu().numpy()
            direct_s.append(time.perf_counter() - t0)
            direct.append(nll)
            plain_nll.append(gpt2_score(dev_params, batch, plain)["nll"]
                             .float().cpu().numpy())
            got = centred_logits(batch["tokens"], cfg)
            want = centred_logits(batch["tokens"], plain)
            logit_err.append(float((got - want).norm() / want.norm()))
            logit_cos.append(cosine(got, want))
            del got, want
    del dev_params, predictor
    direct, plain_nll = np.concatenate(direct), np.concatenate(plain_nll)
    bits = bool(np.array_equal(res["nll"], direct))
    rel = float(np.max(np.abs(res["nll"] - plain_nll) / np.abs(plain_nll)))
    logit_err, logit_cos = max(logit_err), min(logit_cos)
    direct_ms = float(np.median(direct_s) * 1e3)
    predict_ms = float(np.median(predict_s) * 1e3)
    res.update(bits_equal_direct=bits, rel_vs_plain=rel,
               logits_rel_err_vs_plain=logit_err,
               logits_cosine_vs_plain=logit_cos,
               direct_ms_batch=direct_ms, predict_ms_batch=predict_ms,
               predictor_build_s=build_s)
    mem = res["peak_memory_bytes"] / 2**30
    print(f"batch predict: BatchPredictor + CudaPredictor(gpt2_score), GPT-2 "
          f"{cfg.n_params / 1e6:.0f}M, {res['rows']} rows x {cfg.seq_len} "
          f"tokens, batch {PREDICT_BATCH}, 1 actor [{smi}]: "
          f"{res['rows_s']:.1f} rows/s, {res['tokens_s']:.1f} tokens/s, "
          f"{res['ms_batch']:.2f} ms a batch end to end over {n_batches} "
          f"batches ({res['wall_s']:.3f} s) vs the direct gpt2_score call's "
          f"median {direct_ms:.2f} ms a batch and CudaPredictor.predict's "
          f"{predict_ms:.2f} (its build {build_s:.3f} s); peak memory "
          f"{mem:.2f} GiB; "
          f"mean NLL {float(res['nll'].mean()):.4f}; bits equal to the direct "
          f"call {bits}; largest relative gap to the plain path {rel:.3e}; "
          f"centred logits against the plain path's: largest relative "
          f"error {logit_err:.3e}, smallest cosine {logit_cos:.6f} over "
          f"{n_batches} batches")
    print(f"batch predict: launches {launches} over {n_batches} batches")
    require(res["rows"] == PREDICT_ROWS and np.array_equal(
        res["ids"], np.arange(PREDICT_ROWS)),
        f"batch predict: ids {res['ids'][:8]}... ({len(res['ids'])} rows)")
    require(bool(np.all(np.isfinite(res["nll"]))),
            "batch predict: non-finite NLL")
    require(bits, "batch predict: NLL differs from the direct gpt2_score call")
    require(rel <= 1e-3, f"batch predict: NLL off the plain path by {rel:.3e}"
            f" (rtol 1e-3)")
    require(logit_err <= 0.05 and logit_cos > 0.999,
            f"batch predict: centred logits off the plain path's by "
            f"{logit_err:.3e} (limit 0.05), cosine {logit_cos:.6f} (limit "
            f"0.999)")
    forward = FORWARD_LAUNCHES if forward is None else forward
    for k in PORTED:
        want = forward.get(k, 0) * n_batches
        require(launches[k] == want, f"batch predict: {k} launched "
                f"{launches[k]} times, expected {want}")
    res["ids"], res["nll"] = res["ids"].tolist(), res["nll"].tolist()
    return res


def cluster_trainer_phase(torch, cfg, ref, local, two_ranks, smi):
    """Phase 5b: ``measure_trainer_gpt2`` on a ``Cluster`` -- phase 4's
    GPT-2 flash run (``ref``) with its rank in a worker process; then, with
    two or more cards, 2 workers at fsdp=2 held against phase 5's 2-rank
    run (``two_ranks``). ``local`` is phase 4b's run (same call), printed
    beside. Returns the report entry."""
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.models.gpt2 import gpt2_loss
    from ray_tpu_torch.scripts.measure import measure_trainer_gpt2
    from ray_tpu_torch.train.checkpoint import load_sharded
    from ray_tpu_torch.train.train_step import make_train_step

    n_steps = WARMUP + STEPS
    calls = n_steps + 1  # the steps, and step_cost's call of the step
    n_cards = torch.cuda.device_count()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(0)
    print(f"cluster trainer: cuda:0 free {free / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB at the start (caching allocator emptied)")
    ckpt = OUT / "cluster_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    cluster = Cluster()
    out = {"free_bytes_at_start": free, "cards": n_cards}
    try:
        t0 = time.perf_counter()
        cluster.add_node(num_gpus=n_cards)
        cluster.wait_for_nodes()
        out["cluster_up_s"] = time.perf_counter() - t0
        run = measure_trainer_gpt2(cfg, BATCH, steps=n_steps, warmup=WARMUP,
                                   device="cuda", address=cluster.address,
                                   ckpt_dir=str(ckpt))
        out.update(run)
        gaps = [abs(a - b) / abs(b)
                for a, b in zip(run["losses"], ref["losses"])]
        same = run["losses"] == ref["losses"]
        print(f"cluster trainer: CudaTrainer(...).fit() on a Cluster of one "
              f"node ({n_cards} GPU), 1 worker process on cuda:0, GPT-2 "
              f"{cfg.n_params / 1e6:.0f}M batch {BATCH} seq {cfg.seq_len} "
              f"[{smi}]: {run['ms_step']:.2f} ms/step ({run['tok_s']:.1f} "
              f"tok/s); local trainer (phase 4b) {local['ms_step']:.2f} "
              f"ms/step, gap {run['ms_step'] / local['ms_step'] - 1:+.2%}; "
              f"measure_gpt2 {ref['ms_step']:.2f} ms/step, gap "
              f"{run['ms_step'] / ref['ms_step'] - 1:+.2%}; worker peak "
              f"memory {run['peak_memory_bytes'] / 2**30:.2f} GiB; cluster "
              f"up {out['cluster_up_s']:.2f} s, fit {run['wall_s']:.2f} s; "
              f"checkpoint saves {[round(x, 3) for x in run['save_s']]} s")
        print(f"cluster trainer: losses {[round(x, 4) for x in run['losses']]}"
              f", {'the same bits as' if same else 'largest relative gap to'}"
              f" phase 4's{'' if same else f' {max(gaps):.3e}'}; launches in "
              f"the worker {run['launches']} over {calls} calls of the step")
        require(run["steps_run"] == list(range(1, n_steps + 1)),
                f"cluster trainer: reported steps {run['steps_run']}")
        require(max(gaps) <= 2e-3, f"cluster trainer: losses off phase 4's "
                f"by {max(gaps):.3e} (rtol 2e-3)")
        for k in PORTED:
            want = ref["launches_per_step"][k] * calls
            got = run["launches"].get(k, 0)
            require(got == want, f"cluster trainer: {k} launched {got} "
                    f"times in the worker, expected {want}")

        # The step-2 checkpoint, written by the worker, reloads here: one
        # step from it gives phase 4's third loss.
        state = _to_cuda(torch, load_sharded(str(ckpt / "step2")))
        tokens = torch.randint(0, cfg.vocab_size, (BATCH, cfg.seq_len + 1),
                               device="cuda", generator=torch.Generator(
                                   device="cuda").manual_seed(1))
        _, m = make_train_step(lambda p, b: gpt2_loss(p, b, cfg))(
            state, {"tokens": tokens})
        loss3 = float(m["loss"])
        gap3 = abs(loss3 - ref["losses"][2]) / abs(ref["losses"][2])
        del state
        print(f"cluster trainer: the step-2 checkpoint reloaded here, one "
              f"step from it: loss {loss3:.6f} vs phase 4's third "
              f"{ref['losses'][2]:.6f} (relative gap {gap3:.3e})")
        require(gap3 <= 2e-3, f"cluster trainer: a step from the step-2 "
                f"checkpoint gives {loss3}, phase 4's third loss "
                f"{ref['losses'][2]}")
        out["reload_loss"] = loss3

        if n_cards < 2:
            print(f"cluster trainer, 2 workers (fsdp=2): not run: {n_cards} "
                  "CUDA device (needs 2)")
            out["two_workers"] = {"ran": False, "devices": n_cards}
        else:
            two = measure_trainer_gpt2(cfg, BATCH, steps=n_steps,
                                       warmup=WARMUP, device="cuda",
                                       address=cluster.address,
                                       num_workers=2)
            want = two_ranks["losses"]
            g2 = [abs(a - b) / abs(b) for a, b in zip(two["losses"], want)]
            print(f"cluster trainer, 2 workers at fsdp=2 on cuda:0 and "
                  f"cuda:1 [{smi}]: {two['ms_step']:.2f} ms/step "
                  f"({two['tok_s']:.1f} tok/s); phase 5's 2 ranks "
                  f"{two_ranks['ms_step']:.2f} ms/step; losses "
                  f"{[round(x, 4) for x in two['losses']]}, relative gaps "
                  f"to phase 5's 2 ranks {[f'{g:.2e}' for g in g2]}")
            require(g2[0] <= 1e-4, f"cluster trainer, 2 workers: first "
                    f"loss off by {g2[0]:.3e}")
            require(max(g2) <= 1e-2, f"cluster trainer, 2 workers: losses "
                    f"off by {max(g2):.3e}")
            out["two_workers"] = {"ran": True, **two, "loss_rel_gaps": g2}
    finally:
        cluster.shutdown()
        shutil.rmtree(ckpt, ignore_errors=True)
    return out


def _progress(path: Path) -> list:
    """The JSON lines ``trainer_gpt2_loop`` appends to ``progress_path``."""
    try:
        text = path.read_text()
    except OSError:
        return []
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def _wait_until(cond, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _startup_s(report: dict, since: float) -> dict:
    """A worker's start, from ``since`` (a wall time) to its first step's
    report, in seconds a stage: to the process's start, the worker actor
    constructed (its placement and imports, torch's among them), its
    group joined (CUDA's context, NCCL), its loop called and entered,
    CUDA's context (if not yet), the state built or loaded, step_cost's
    call and the first step (``trainer_gpt2_loop``'s ``startup`` marks;
    None for a mark not taken). A process that was running before
    ``since`` shows a negative first stage, and the next stage counts
    from ``since``."""
    marks = report["startup"]
    stages = [(k, marks.get(k)) for k in (
        "process", "actor", "group", "run", "loop", "device", "state",
        "step_cost")] + [("first_step", report["wall"])]
    out, prev = {}, since
    for name, wall in stages:
        out[name] = None if wall is None else round(wall - prev, 3)
        prev = prev if wall is None else max(prev, wall)
    return out


def drain_phase(torch, cfg, ref, cluster_run, smi):
    """Phase 9: the trainer through a node's loss. 9a, on one card: a
    preemption notice under ``measure_trainer_gpt2(preempt_at=2)`` (its
    failure budget 0) on a ``Cluster`` of a GPU-less driver node and two
    GPU nodes (both stand for cuda:0; one trains at a time). 9b, on two
    or more cards: the elastic gang (2 workers at fsdp=2 on nodes of
    cards 0 and 1, ``min_workers=1``) through ``kill_node`` of card 0's
    node after step 2's checkpoint, a shrunk world on card 1, and a
    replacement node on card 0 it regrows onto. ``ref`` is phase 4's
    GPT-2 run, ``cluster_run`` phase 5b's. Returns the report entry."""
    import threading

    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.scripts.measure import (measure_trainer_gpt2,
                                               ms_per_step)
    from ray_tpu_torch.util.goodput import attribution_ok

    n_steps = WARMUP + STEPS
    n_cards = torch.cuda.device_count()
    torch.cuda.empty_cache()
    out = {"cards": n_cards}

    # 9a: a preemption notice under training.
    notice = OUT / "preempt_notice"
    notice.unlink(missing_ok=True)
    ckpt = OUT / "preempt_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    config.override("preemption_signal_file", str(notice))
    config.override("preemption_poll_interval_s", 0.1)
    cluster = Cluster()
    try:
        cluster.add_node(num_gpus=0)  # the driver's node: its store, queue
        cluster.add_node(num_gpus=1)
        cluster.add_node(num_gpus=1)
        cluster.wait_for_nodes()
        run = measure_trainer_gpt2(
            cfg, BATCH, steps=n_steps, warmup=WARMUP, device="cuda",
            address=cluster.address, ckpt_dir=str(ckpt), preempt_at=2)
        nodes = {n["NodeID"]: n for n in cluster.head.rpc_nodes()}
        drains = {nid: (n.drain_forced, n.drain_duration)
                  for nid, n in cluster.head._nodes.items()}
    finally:
        config.reset("preemption_signal_file")
        config.reset("preemption_poll_interval_s")
        cluster.shutdown()
        shutil.rmtree(ckpt, ignore_errors=True)
    reports = run["reports"]
    a_id = reports[0]["node"]
    b_reports = [r for r in reports if r["node"] != a_id]
    b_steps = [r["step"] for r in b_reports]
    gaps = [abs(r["loss"] - ref["losses"][r["step"] - 1])
            / abs(ref["losses"][r["step"] - 1]) for r in reports]
    forced, drain_s = drains[a_id]
    seen_s = run["drains_seen"].get(a_id, float("nan")) - run["notice_wall"]
    first_b_s = b_reports[0]["wall"] - run["notice_wall"] if b_reports \
        else float("nan")
    ms_b = ms_per_step(b_reports)
    calls = len(b_reports) + 1  # B's steps and its step_cost call
    planned, sums = attribution_ok(run["goodput"])
    restarts = run["restart_history"]
    decided_s = restarts[0]["wall"] - run["notice_wall"] if restarts \
        else float("nan")
    start_a = _startup_s(reports[0], reports[0]["startup"]["actor"])
    start_b = _startup_s(b_reports[0], restarts[0]["wall"]) \
        if b_reports and restarts else None
    print(f"preemption: CudaTrainer GPT-2 {cfg.n_params / 1e6:.0f}M batch "
          f"{BATCH} on a Cluster of a driver node and two GPU nodes [{smi}]: "
          f"the notice written after step 2's checkpoint by node "
          f"{a_id[-8:]}; DRAINING seen by the trainer {seen_s:.3f} s after "
          f"it, B's first step (step {b_steps[0] if b_steps else None}) "
          f"{first_b_s:.3f} s after it; the drain took {drain_s} s, forced "
          f"{forced}; restarts {restarts}, the first decided "
          f"{decided_s:.3f} s after the notice; B's start from that "
          f"decision, s a stage: {start_b} (A's from its actor's "
          f"construction: {start_a}); steps in report order "
          f"{run['steps_run']}, from B "
          f"{b_steps}; ms/step on B {ms_b:.2f} (phase 5b "
          f"{cluster_run['ms_step']:.2f}); downtime "
          f"{run['goodput']['downtime_s']} s by cause "
          f"{run['goodput']['by_cause']}; B's peak memory "
          f"{run['peak_memory_bytes'] / 2**30:.2f} GiB; largest loss gap "
          f"to phase 4 {max(gaps):.3e}; launches in B's worker "
          f"{run['launches']} over {calls} calls of the step")
    require(sorted(set(run["steps_run"])) == list(range(1, n_steps + 1)),
            f"preemption: reported steps {run['steps_run']}")
    require(b_steps == list(range(3, n_steps + 1)),
            f"preemption: steps from B {b_steps}, expected 3..{n_steps}")
    require(max(gaps) <= 2e-3, f"preemption: losses off phase 4's by "
            f"{max(gaps):.3e} (rtol 2e-3)")
    require(nodes[a_id]["State"] == "DEAD"
            and "preemption" in (nodes[a_id]["DeathCause"] or ""),
            f"preemption: node A is {nodes[a_id]['State']} "
            f"({nodes[a_id]['DeathCause']})")
    require(a_id in run["drains_seen"], "preemption: the trainer's drain "
            "watcher never saw A DRAINING")
    # A drain never waits on actor workers, so A dies milliseconds after
    # DRAINING whatever the trainer does: the restart must come from the
    # watcher (TrainingWorkerPreempted, seen before a rank's death), not
    # from the actor's drain death cause.
    require([(r["via"], r["cause"], r["exempt"]) for r in restarts]
            == [("drain_watcher", "preemption", True)],
            f"preemption: restarts {restarts}, expected one exempt restart "
            f"through the drain watcher")
    require(planned and sums, f"preemption: downtime not all planned or "
            f"not summing: {run['goodput']}")
    for k in PORTED:
        want = ref["launches_per_step"][k] * calls
        got = run["launches"].get(k, 0)
        require(got == want, f"preemption: {k} launched {got} times in B's "
                f"worker, expected {want}")
    out["preempt"] = {
        "error": None, "steps_run": run["steps_run"], "b_steps": b_steps,
        "losses": run["losses"], "loss_rel_gaps": gaps,
        "notice_to_draining_s": seen_s, "notice_to_b_first_step_s":
        first_b_s, "drain_s": drain_s, "drain_forced": forced,
        "restarts": restarts, "restart_decided_s": decided_s,
        "startup_b_s": start_b, "startup_a_s": start_a,
        "ms_step_b": ms_b, "ms_step_cluster_5b": cluster_run["ms_step"],
        "goodput": run["goodput"], "peak_memory_bytes":
        run["peak_memory_bytes"], "launches": run["launches"],
        "calls": calls}

    # 9b: the elastic gang shrinks and regrows.
    if n_cards < 2:
        print(f"elastic gang (9b): not run: {n_cards} CUDA device (needs 2)")
        out["elastic"] = {"ran": False, "devices": n_cards}
        return out
    progress = OUT / "elastic_progress.jsonl"
    progress.unlink(missing_ok=True)
    ckpt = OUT / "elastic_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    cluster = Cluster()
    events: dict = {}
    got: dict = {}
    try:
        cluster.add_node(num_gpus=0)
        a = cluster.add_node(num_gpus=1, cuda_device=0)
        cluster.add_node(num_gpus=1, cuda_device=1)
        cluster.wait_for_nodes()

        def faults():
            if not _wait_until(lambda: any(
                    r["step"] >= 2 for r in _progress(progress)), 300):
                return
            events["kill"] = time.time()
            cluster.kill_node(a)
            if not _wait_until(lambda: any(
                    r["world"] == 1 for r in _progress(progress)), 300):
                return
            events["shrunk_step"] = time.time()
            cluster.add_node(num_gpus=1, cuda_device=0)
            events["added"] = time.time()

        def fit():
            try:
                got["run"] = measure_trainer_gpt2(
                    cfg, BATCH, steps=ELASTIC_STEPS, warmup=WARMUP,
                    device="cuda", address=cluster.address, num_workers=2,
                    min_workers=1, placement_strategy="SPREAD",
                    ckpt_dir=str(ckpt), progress_path=str(progress))
            except Exception as e:
                got["error"] = e

        injector = threading.Thread(target=faults, daemon=True)
        runner = threading.Thread(target=fit, daemon=True)
        injector.start()
        runner.start()
        runner.join(ELASTIC_LIMIT_S)
        require(not runner.is_alive(), f"elastic gang: the run did not end "
                f"within {ELASTIC_LIMIT_S} s (events {events})")
        run = got.get("run")
        require(run is not None, f"elastic gang: the run raised "
                f"{got.get('error')!r} (from {got.get('error').__cause__!r})"
                if "error" in got else "elastic gang: the run gave nothing")
    finally:
        cluster.shutdown()
        shutil.rmtree(ckpt, ignore_errors=True)
    reports = run["reports"]
    worlds = sorted({r["world"] for r in reports})
    gaps = [abs(r["loss"] - ref["losses"][r["step"] - 1])
            / abs(ref["losses"][r["step"] - 1])
            for r in reports if r["step"] <= n_steps]
    shrunk = [r for r in reports if r["world"] == 1]
    regrown = [r for r in reports[reports.index(shrunk[-1]) + 1:]
               if r["world"] == 2] if shrunk else []
    shrink_s = shrunk[0]["wall"] - events["kill"] if shrunk else None
    regrow_s = regrown[0]["wall"] - events["added"] if regrown else None
    ms = {w: ms_per_step(reports, lambda r, w=w: r["world"] == w)
          for w in (1, 2)}
    final = run["final_pg_state"] or {}
    planned, sums = attribution_ok(run["goodput"])
    print(f"elastic gang (9b): 2 workers at fsdp=2 on cards 0 and 1, "
          f"min_workers=1 [{smi}]: killed card 0's node after step 2; "
          f"worlds in report order {[r['world'] for r in reports]} over "
          f"steps {run['steps_run']}; first shrunk step {shrink_s} s after "
          f"the kill, first regrown step {regrow_s} s after the "
          f"replacement node; ms/step at world 1 {ms[1]}, at world 2 "
          f"{ms[2]}; downtime {run['goodput']['downtime_s']} s by cause "
          f"{run['goodput']['by_cause']}; final group {final.get('state')} "
          f"after {final.get('reschedules')} reschedule(s); largest loss "
          f"gap to phase 4 (steps 1-{n_steps}) {max(gaps):.3e}")
    require(worlds == [1, 2], f"elastic gang: worlds {worlds}")
    require(all(math.isfinite(r["loss"]) for r in reports),
            f"elastic gang: non-finite loss {run['losses']}")
    require(max(gaps) <= 1e-2, f"elastic gang: losses off phase 4's by "
            f"{max(gaps):.3e} (1e-2)")
    require("reschedule" in run["goodput"]["by_cause"] and planned and sums,
            f"elastic gang: downtime {run['goodput']}")
    require(final.get("state") == "CREATED"
            and final.get("reschedules", 0) >= 1
            and a.node_id not in {nid for nid, _ in final["placement"]},
            f"elastic gang: final group {final}")
    out["elastic"] = {
        "ran": True, "worlds": [r["world"] for r in reports],
        "steps_run": run["steps_run"], "losses": run["losses"],
        "loss_rel_gaps": gaps, "shrink_s": shrink_s, "regrow_s": regrow_s,
        "ms_step_by_world": ms, "goodput": run["goodput"],
        "final_pg_state": final, "events": events}
    return out


# -- phase 10 ------------------------------------------------------------------


def head_ft_phase(torch, cfg, held, held_ms, smi):
    """Phase 10a: phase 5b's run (``measure_trainer_gpt2`` on a ``Cluster``
    of a GPU-less driver node and one GPU node, failure budget 0) on a
    cluster whose head persists to ``chip_smoke_out/head.db``; a thread
    watching ``progress_path`` puts a marker key into the KV after step
    1, and once step 2 is reported kills the head, keeps it down
    HEAD_DOWN_S and restarts it on the same address. ``held`` is the run
    whose losses it must give to the bit (phase 5b's; phase 4's with
    ``--head-ft``), ``held_ms`` its ms/step. Returns the report entry."""
    import threading

    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.scripts.measure import measure_trainer_gpt2

    n_steps = WARMUP + STEPS
    calls = n_steps + 1  # the steps, and step_cost's call of the step
    torch.cuda.empty_cache()
    for f in OUT.glob("head.db*"):
        f.unlink()
    progress = OUT / "head_ft_progress.jsonl"
    progress.unlink(missing_ok=True)
    ckpt = OUT / "head_ft_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    cluster = Cluster(persist_path=str(OUT / "head.db"))
    ev: dict = {}

    def crash():
        try:
            if not _wait_until(lambda: any(
                    r["step"] >= 1 for r in _progress(progress)), 600):
                return
            cluster.head.rpc_kv_put(HEAD_FT_KEY, b"written after step 1")
            if not _wait_until(lambda: any(
                    r["step"] >= 2 for r in _progress(progress)), 600):
                return
            head = cluster.head
            ev["kv_before"] = {k: head.rpc_kv_get(k)
                               for k in head.rpc_kv_keys()}
            ev["kill"] = time.time()
            address = cluster.kill_head()
            time.sleep(HEAD_DOWN_S)
            ev["restart"] = time.time()
            cluster.restart_head(address)
            ev["restarted"] = time.time()
            head = cluster.head
            _wait_until(lambda: all(
                v["heartbeats"] > 0
                for v in head.rpc_node_heartbeats().values()), 60)
            ev["beats"] = head.rpc_node_heartbeats()
            _wait_until(lambda: any(r["wall"] > ev["restarted"]
                                    for r in _progress(progress)), 600)
            ev["nodes"] = head.rpc_nodes()
            ev["pgs"] = head.rpc_placement_group_table()
            ev["kv_after"] = {k: head.rpc_kv_get(k) for k in ev["kv_before"]}
            ev["persist"] = head.rpc_pubsub_stats()["persist"]
            ev["reconnects"] = {
                "driver": worker_mod.backend().head.reconnects,
                "agents": [n.head.reconnects for n in cluster.nodes]}
        except Exception as e:  # noqa: BLE001 — held below
            ev["error"] = repr(e)

    thread = threading.Thread(target=crash, daemon=True)
    try:
        cluster.add_node(num_gpus=0)  # the driver's node: its store, queue
        cluster.add_node(num_gpus=1)
        cluster.wait_for_nodes()
        thread.start()
        run = measure_trainer_gpt2(
            cfg, BATCH, steps=n_steps, warmup=WARMUP, device="cuda",
            address=cluster.address, ckpt_dir=str(ckpt),
            progress_path=str(progress))
        thread.join(60)
    finally:
        cluster.shutdown()
        shutil.rmtree(ckpt, ignore_errors=True)
    require("error" not in ev and "kv_after" in ev,
            f"head restart: the crash thread did not finish: {ev}")
    reports = run["reports"]
    restarted = ev["restarted"]
    down_s = ev["restart"] - ev["kill"]
    beat_s = min(v["first_wall"] for v in ev["beats"].values()) - restarted
    next_s = min(r["wall"] for r in reports if r["wall"] > restarted) \
        - restarted
    before, spanning, after = [], [], []
    for a, b in zip(reports, reports[1:]):
        gap = (b["t"] - a["t"] - a["save_s"]) * 1e3
        if b["wall"] <= ev["kill"]:
            before.append(gap)
        elif a["wall"] >= restarted:
            after.append(gap)
        else:
            spanning.append(gap)
    pids = {r["pid"] for r in reports}
    pg_states = {k[-8:]: v["state"] for k, v in ev["pgs"].items()}
    alive = [n for n in ev["nodes"] if n["Alive"] and n["State"] == "ALIVE"]
    same = run["losses"] == held["losses"]
    print(f"head restart: CudaTrainer GPT-2 {cfg.n_params / 1e6:.0f}M batch "
          f"{BATCH} on a Cluster(persist_path) of a driver node and a GPU "
          f"node [{smi}]: the head killed after step 2, down {down_s:.3f} s, "
          f"restarted on its address in {restarted - ev['restart']:.3f} s; "
          f"first heartbeat on the new head {beat_s:.3f} s after the "
          f"restart, the next step report {next_s:.3f} s after it; "
          f"reconnect attempts: driver {ev['reconnects']['driver']}, agents "
          f"{ev['reconnects']['agents']}; the store's persist stats "
          f"{ev['persist']}; heartbeats received {[v['heartbeats'] for v in ev['beats'].values()]}")
    print(f"head restart: ms/step before the crash "
          f"{[round(x, 2) for x in before]}, across it "
          f"{[round(x, 2) for x in spanning]}, after it "
          f"{[round(x, 2) for x in after]} (the held run {held_ms:.2f}); "
          f"steps {run['steps_run']} from {len(pids)} worker process(es); "
          f"restarts {run['restart_history']}; losses "
          f"{'the same bits as' if same else 'NOT the same bits as'} the "
          f"held run's; nodes ALIVE {len(alive)} of {len(ev['nodes'])}; "
          f"placement groups {pg_states}; KV keys back {len(ev['kv_after'])}"
          f" of {len(ev['kv_before'])}; launches in the worker "
          f"{run['launches']} over {calls} calls of the step")
    require(run["steps_run"] == list(range(1, n_steps + 1)),
            f"head restart: reported steps {run['steps_run']}")
    require(len(pids) == 1, f"head restart: steps from processes {pids}")
    require(run["restart_history"] == [],
            f"head restart: restarts {run['restart_history']}")
    require(same, f"head restart: losses {run['losses']}, the held run's "
            f"{held['losses']}")
    for k in PORTED:
        want = held["launches_per_step"][k] * calls
        got = run["launches"].get(k, 0)
        require(got == want, f"head restart: {k} launched {got} times in "
                f"the worker, expected {want}")
    require(len(alive) == 2 == len(ev["nodes"]),
            f"head restart: nodes after the restart {ev['nodes']}")
    require(all(v["heartbeats"] > 0 and v["first_wall"] > restarted
                for v in ev["beats"].values()),
            f"head restart: heartbeats on the new head {ev['beats']}")
    require(list(pg_states.values()) == ["CREATED"],
            f"head restart: placement groups {pg_states}")
    require(ev["kv_after"] == ev["kv_before"]
            and ev["kv_before"].get(HEAD_FT_KEY) == b"written after step 1",
            f"head restart: KV before {ev['kv_before']}, after "
            f"{ev['kv_after']}")
    return {"steps_run": run["steps_run"], "losses": run["losses"],
            "launches": run["launches"], "calls": calls,
            "head_down_s": down_s, "restart_bind_s": restarted - ev["restart"],
            "first_heartbeat_s": beat_s, "next_report_s": next_s,
            "reconnects": ev["reconnects"], "persist": ev["persist"],
            "ms_before": before, "ms_across": spanning, "ms_after": after,
            "held_ms_step": held_ms, "pg_states": pg_states,
            "kv_keys": sorted(ev["kv_before"]),
            "restart_history": run["restart_history"]}


def store_capacity_for(arena_bytes: int) -> int:
    """The segment size (``store_capacity``) whose arena holds
    ``arena_bytes``: the header and slot table come off the top, their
    size read from a probe segment of the candidate size (removed)."""
    from ray_tpu_torch._native.shm_store import ShmStore

    size = arena_bytes
    for _ in range(3):
        probe = f"/dev/shm/rtorch_probe_{os.getpid()}"
        st = ShmStore(probe, size, create=True)
        arena = st.stats()["capacity"]
        st.close(unlink=True)
        if arena >= arena_bytes:
            return size
        size += arena_bytes - arena
    return size


def spill_phase(torch, cfg, params, held, smi, forward=None):
    """Phase 10b: phase 8b's job -- ``params`` (8a's parameters as numpy)
    scoring PREDICT_ROWS rows of 1025 seed-2 tokens at PREDICT_BATCH --
    through ``measure_batch_predict_gpt2(address=...)`` on a ``Cluster``
    of a GPU-less driver node whose store cannot hold the job's puts and a
    GPU node with the scoring actor. The driver node's arena holds the
    serialized checkpoint and SPILL_MARGIN bytes: the predictor puts the
    checkpoint first, the eight blocks of rows that follow spill it, and
    the actor's fetch restores it, which does not fit beside the blocks,
    so the parallel chunk pulls read it from the spill file; the blocks
    travel inline from the store. ``held`` is phase 8b's report entry
    (its NLL, bit for bit; rows/s printed beside). ``forward``: one
    forward's launches a kernel (FORWARD_LAUNCHES). Returns the report
    entry."""
    import numpy as np

    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core import serialization as ser
    from ray_tpu_torch.scripts.measure import measure_batch_predict_gpt2
    from ray_tpu_torch.train.checkpoint import Checkpoint

    forward = FORWARD_LAUNCHES if forward is None else forward
    tokens = torch.randint(
        0, cfg.vocab_size, (PREDICT_ROWS, cfg.seq_len + 1), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(2)).cpu().numpy()
    meta, chunks = ser.serialize(Checkpoint.from_dict({"params": params}))
    ckpt_data = ser.total_size(chunks)
    ckpt_bytes = ckpt_data + len(meta) + 1  # the store's meta: flag + meta
    arena = ckpt_bytes + SPILL_MARGIN
    capacity = store_capacity_for(arena)
    del meta, chunks
    torch.cuda.empty_cache()
    cluster = Cluster()
    try:
        drv = cluster.add_node(num_gpus=0, store_capacity=capacity)
        cluster.add_node(num_gpus=1)
        cluster.wait_for_nodes()
        res = measure_batch_predict_gpt2(
            cfg, params=params, tokens=tokens, batch_size=PREDICT_BATCH,
            device="cuda", address=cluster.address)
        store = drv.rpc_store_stats()
        fetch = drv.rpc_fetch_stats()
    finally:
        cluster.shutdown()
    n_batches = res["batches"]
    served = {p: fetch["counts"][p + "_bytes"]
              for p in ("inline", "stream", "chunk")}
    pulls = sorted(fetch["chunk_pulls"].values(), key=lambda r: -r["bytes"])
    pull = pulls[0] if pulls else {"bytes": 0, "chunks": 0,
                                   "first_wall": 0.0, "last_wall": 0.0}
    pull_s = pull["last_wall"] - pull["first_wall"]
    gbs = pull["bytes"] / pull_s / 1e9 if pull_s > 0 else float("nan")
    bits = bool(np.array_equal(res["nll"], np.asarray(held["nll"],
                                                      dtype=res["nll"].dtype)))
    launches = res["launches"]
    print(f"spill: BatchPredictor + CudaPredictor(gpt2_score) on a Cluster, "
          f"GPT-2 {cfg.n_params / 1e6:.0f}M, {res['rows']} rows x "
          f"{cfg.seq_len} tokens, batch {PREDICT_BATCH}, the actor on the "
          f"GPU node [{smi}]: {res['rows_s']:.1f} rows/s ({res['wall_s']:.3f}"
          f" s, the actor's start and the parameters' pull included) vs "
          f"phase 8b's {held['rows_s']:.1f}; the driver node's store "
          f"{capacity} B (arena {store['capacity']} B = the checkpoint's "
          f"{ckpt_bytes} B + {SPILL_MARGIN} B): spilled "
          f"{store['spilled_bytes_total']} B in {store['spill_s']:.4f} s, "
          f"{store['spill_restores']} objects ({store['restored_bytes']} B) "
          f"read back in {store['restore_s']:.4f} s, {store['spill_denied']} "
          f"denials; the checkpoint pulled in {pull['chunks']} chunks "
          f"({pull['bytes']} B) over {pull_s:.3f} s = {gbs:.3f} GB/s, "
          f"{fetch['counts']['spill_file_bytes']} B of chunks read from the "
          f"spill file; "
          f"served by path {served}, calls {fetch['counts']}; the scoring "
          f"worker's peak device memory "
          f"{(res['peak_memory_bytes'] or 0) / 2**30:.2f} GiB")
    print(f"spill: NLL bits equal to phase 8b's {bits}; launches {launches} "
          f"over {n_batches} batches")
    require(res["rows"] == PREDICT_ROWS and np.array_equal(
        res["ids"], np.arange(PREDICT_ROWS)),
        f"spill: ids {res['ids'][:8]}... ({len(res['ids'])} rows)")
    require(bits, "spill: NLL differs from phase 8b's")
    require(store["spilled_bytes_total"] >= ckpt_data
            and store["spill_restores"] > 0
            and store["restored_bytes"] >= ckpt_data,
            f"spill: the checkpoint ({ckpt_data} B) was not spilled and "
            f"read back: the driver node spilled "
            f"{store['spilled_bytes_total']} B and restored "
            f"{store['spill_restores']} objects "
            f"({store['restored_bytes']} B)")
    require(pull["bytes"] == ckpt_data and served["chunk"] >= ckpt_data,
            f"spill: the checkpoint ({ckpt_data} B) was not pulled by "
            f"chunks: {fetch['chunk_pulls']}, {served}")
    require(fetch["counts"]["spill_file_bytes"] >= ckpt_data,
            f"spill: {fetch['counts']['spill_file_bytes']} B of chunks read "
            f"from the spill file, less than the checkpoint's {ckpt_data}")
    require(fetch["counts"]["inline"] >= 8 and served["inline"] > 0,
            f"spill: the blocks did not travel inline: {fetch['counts']}")
    for k in PORTED:
        want = forward.get(k, 0) * n_batches
        require(launches.get(k, 0) == want, f"spill: {k} launched "
                f"{launches.get(k, 0)} times, expected {want}")
    return {"rows": res["rows"], "rows_s": res["rows_s"],
            "wall_s": res["wall_s"], "batches": n_batches,
            "launches": launches, "bits_equal_8b": bits,
            "store_capacity": capacity, "ckpt_bytes": ckpt_bytes,
            "store": store, "fetch": fetch, "served_bytes": served,
            "pull_s": pull_s, "pull_gb_s": gbs,
            "peak_memory_bytes": res["peak_memory_bytes"]}


# -- phase 11 ------------------------------------------------------------------


def direct_scores(torch, cfg, rows: int):
    """Phase 8b's direct-call reference on the seed-0 parameters: the
    first ``rows`` of 8b's seed-2 token rows, scored PREDICT_BATCH at a
    time by ``gpt2_score`` (8b holds its NLL bit for bit to this call).
    Returns (tokens as numpy, the rows' NLL as numpy)."""
    import numpy as np

    from ray_tpu_torch.models.gpt2 import gpt2_init
    from ray_tpu_torch.scripts.measure import gpt2_score

    tokens = torch.randint(
        0, cfg.vocab_size, (PREDICT_ROWS, cfg.seq_len + 1), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(2))[:rows]
    params = gpt2_init(torch.Generator(device="cuda").manual_seed(0), cfg,
                       device="cuda")
    nll = []
    with torch.no_grad():
        for i in range(0, rows, PREDICT_BATCH):
            part = tokens[i:i + PREDICT_BATCH]
            nll.append(gpt2_score(params, {"id": torch.arange(len(part)),
                                           "tokens": part}, cfg)["nll"])
    del params
    torch.cuda.empty_cache()
    return tokens.cpu().numpy(), np.concatenate(
        [n.cpu().numpy() for n in nll])


def spill_to_peer_phase(torch, cfg, smi):
    """Phase 11a: spillback over the gossiped view. A ``Cluster`` of node A
    (the driver's) and node B, each ``num_gpus=1`` on card 0; a long-lived
    actor holds A's GPU. Once every agent's ``peer_view`` names every peer
    (fresh), the driver submits OBSERVE_TASKS default-strategy tasks of
    ``num_gpus=OBSERVE_GPUS``, each scoring one PREDICT_BATCH-row batch of
    8b's rows with GPT-2 small's forward from the seed-0 parameters
    (``measure.score_rows_seed0``). A's leased admission rejects them; the
    client places them on B from A's gossiped view. Held: every task ran
    on B; the head's ``schedule_batch`` count rose by at most 1 (the
    reference test's bound); the NLL bit for bit 8b's direct call on the
    same rows (``direct_scores``); each task launched one forward's
    ``ln_fwd`` / ``gelu_fwd`` / ``flash_fwd`` and no other kernel.
    Returns the report entry."""
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.scripts.measure import GpuHolder, score_rows_seed0
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    rows = OBSERVE_TASKS * PREDICT_BATCH
    tokens, want = direct_scores(torch, cfg, rows)
    cluster = Cluster()
    try:
        a = cluster.add_node(num_gpus=1, cuda_device=0)
        b = cluster.add_node(num_gpus=1, cuda_device=0)
        cluster.wait_for_nodes()
        ray_tpu_torch.init(address=cluster.address)
        holder = ray_tpu_torch.remote(GpuHolder).options(
            num_gpus=1, scheduling_strategy=NodeAffinitySchedulingStrategy(
                a.node_id)).remote()
        require(ray_tpu_torch.get(holder.node.remote(), timeout=120)
                == a.node_id, "spill to peer: the holder is not on node A")
        t0 = time.perf_counter()

        def full_view():
            for agent in (a, b):
                view = agent.rpc_peer_view()
                peer = view.get((b if agent is a else a).node_id) or {}
                if not {a.node_id, b.node_id} <= set(view) or \
                        time.time() - peer.get("ts", 0.0) > 2.0:
                    return False
            return (a.rpc_peer_view()[b.node_id]["available"].get(
                "GPU", 0) >= 1 and a.pool.available().get("GPU", 1) == 0)

        require(_wait_until(full_view, 30.0),
                f"spill to peer: no full view in 30 s: "
                f"{a.rpc_peer_view()}")
        view_s = time.perf_counter() - t0
        before = cluster.head._server.handler_stats().get(
            "schedule_batch", {}).get("count", 0)
        task = ray_tpu_torch.remote(score_rows_seed0).options(
            num_gpus=OBSERVE_GPUS)
        t1 = time.perf_counter()
        outs = ray_tpu_torch.get([
            task.remote(tokens[i * PREDICT_BATCH:(i + 1) * PREDICT_BATCH],
                        np.arange(PREDICT_BATCH))
            for i in range(OBSERVE_TASKS)], timeout=600)
        tasks_s = time.perf_counter() - t1
        delta = cluster.head._server.handler_stats().get(
            "schedule_batch", {}).get("count", 0) - before
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
    nodes = [o["node"] for o in outs]
    got = np.concatenate([o["nll"] for o in outs])
    bits = bool(np.array_equal(got, want))
    launches = {}
    for o in outs:
        for k, v in o["launches"].items():
            launches[k] = launches.get(k, 0) + v
    names = ["B" if n == b.node_id else "A" if n == a.node_id else n
             for n in nodes]
    print(f"spill to peer: {OBSERVE_TASKS} tasks of num_gpus={OBSERVE_GPUS} "
          f"(GPT-2 {cfg.n_params / 1e6:.0f}M seed-0 forward, {PREDICT_BATCH} "
          f"rows x {cfg.seq_len} tokens each) with node A's GPU held "
          f"[{smi}]: a full gossiped view {view_s:.3f} s after the holder "
          f"started; nodes {names}; the head's schedule_batch "
          f"+{delta}; {tasks_s:.3f} s for the tasks (their workers' start, "
          f"torch import and CUDA context included); NLL bits equal 8b's "
          f"direct call {bits}; launches {launches}")
    require(all(n == b.node_id for n in nodes),
            f"spill to peer: tasks ran on {nodes}, B is {b.node_id}")
    require(delta <= 1, f"spill to peer: schedule_batch +{delta} (<= 1)")
    require(bits, "spill to peer: NLL differs from 8b's direct call")
    for k in PORTED:
        want_n = FORWARD_LAUNCHES.get(k, 0) * OBSERVE_TASKS
        require(launches.get(k, 0) == want_n, f"spill to peer: {k} "
                f"launched {launches.get(k, 0)} times, expected {want_n}")
    return {"nodes_on_b": sum(n == b.node_id for n in nodes),
            "schedule_batch_delta": delta, "view_s": view_s,
            "tasks_s": tasks_s, "bits_equal_8b": bits,
            "launches": launches}


class _ObservePoll:
    """Reads the state API every second on its own head connection while
    the traced fit runs: the actors, the objects with their attribution,
    and the workers' device snapshots -- the ones their event batches
    carry, which every run ships, and one ``fresh`` call (asking each
    worker now) once a device shows, so the reads barely load the run
    whose ms/step is held against 5b's."""

    def __init__(self, address: str):
        import threading

        from ray_tpu_torch.cluster.gcs_client import GcsClient

        self.gcs = GcsClient(address)
        self.peak: dict = {}    # (node, worker) -> max bytes in use
        self.kinds: set = set()
        self.device_nodes: set = set()
        self.trainer_nodes: set = set()
        self.objects: dict = {}  # every object seen live, by id
        self.fresh: list = []   # the one fresh call's snapshots
        self.polls = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        tick = 0
        while not self._stop.wait(0.25):
            try:
                # The objects every 0.25 s (the head alone answers); the
                # rest every second.
                for obj in self.gcs.objects.all(100_000)["objects"]:
                    self.objects[obj["object_id"]] = obj
                tick += 1
                if tick % 4:
                    continue
                snaps = self.gcs.metrics.device_stats(fresh=False)
                if not self.fresh and any(sn.get("devices") for sn in snaps):
                    snaps = self.fresh = self.gcs.metrics.device_stats(
                        fresh=True)
                for snap in snaps:
                    for d in snap.get("devices") or ():
                        key = (snap["node_id"], snap["worker_id"])
                        self.peak[key] = max(self.peak.get(key, 0),
                                             d.get("bytes_in_use", 0))
                        self.kinds.add(d.get("device_kind"))
                        self.device_nodes.add(snap["node_id"])
                for act in self.gcs.actors.all():
                    if act.get("class_name") == "_TrainWorker" and \
                            act.get("state") == "ALIVE":
                        self.trainer_nodes.add(act["node_id"])
                self.polls += 1
            except Exception as e:  # the head answers again next round
                print(f"observe: state poll: {e!r}")

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=30)
        self.gcs.close()


def ttft_check(torch, smi) -> dict:
    """Phase 11b's TTFT: phase 7's GPT-2 small engine
    (``SERVE_ENGINES["gpt2"]``) answers one request under a span with
    tracing on; ``traces.decompose`` of the request's spans partitions
    [its start, its first token] and sums to that TTFT exactly."""
    from ray_tpu_torch.cluster.traces import decompose
    from ray_tpu_torch.scripts.measure import SERVE_ENGINES, serve_prompts
    from ray_tpu_torch.serve import _observability as obs
    from ray_tpu_torch.serve.llm_engine import LLMEngine
    from ray_tpu_torch.util import tracing

    eng = LLMEngine(model="gpt2", preset="small", device="cuda",
                    **SERVE_ENGINES["gpt2"])
    try:
        prompt = serve_prompts(1, eng._cfg.vocab_size,
                               SERVE_ENGINES["gpt2"]["max_prompt_len"])[0]
        eng.generate(prompt, 4)  # warm: outside the traced request
        tracing.enable()
        tracing.drain()
        with tracing.span("chip_smoke.request") as root:
            t0 = time.time()
            with obs.request_scope("gpt2", None, trace_ctx={
                    "trace_id": root["trace_id"],
                    "span_id": root["span_id"]}):
                rid = eng.llm_submit(prompt, 8)
            first = None
            while True:
                resp = eng.llm_next(rid, timeout_s=5.0)
                if resp["chunks"] and first is None:
                    first = time.time()
                if resp["done"]:
                    break
        spans = [sp for sp in tracing.drain()
                 if sp["trace_id"] == root["trace_id"]]
    finally:
        tracing.disable()
        eng.shutdown_engine()
    d = decompose(spans)
    require(d is not None, f"observe: no decomposition of {spans}")
    gap = abs(sum(d["phases"].values()) - d["total_s"])
    print(f"observe: one GPT-2 small request through LLMEngine with tracing "
          f"on [{smi}]: TTFT {d['total_s'] * 1e3:.3f} ms by the trace "
          f"(root to the end of llm.prefill), {(first - t0) * 1e3:.3f} ms "
          f"by the caller's clock; phases (ms) "
          f"{ {k: round(v * 1e3, 3) for k, v in d['phases'].items()} }, "
          f"their sum off the TTFT by {gap:.3e} s; {len(spans)} spans")
    require(gap <= 1e-9, f"observe: the phases sum to "
            f"{sum(d['phases'].values())}, the TTFT is {d['total_s']}")
    require({"queue", "prefill"} <= set(d["phases"]),
            f"observe: phases {sorted(d['phases'])}")
    return {"ttft_s": d["total_s"], "client_ttft_s": first - t0,
            "phases": d["phases"], "dominant": d["dominant"],
            "spans": len(spans)}


def observe_phase(torch, cfg, held, smi):
    """Phase 11b: phase 5b again -- ``measure_trainer_gpt2`` on a
    ``Cluster`` of a GPU-less driver node and one GPU node -- with tracing
    on in the driver and the worker, under one driver span. ``held``:
    phase 5b's losses and ms/step (None: an untraced run on the same
    cluster first stands in). Held: the losses are 5b's bits; one trace,
    assembled by the head across the driver's and the worker's processes,
    whose ``train.step`` spans carry the driver's trace id and lie inside
    their parents after clock alignment, and whose critical path covers
    the root interval exactly; while the fit runs, the trainer's worker
    ALIVE on the GPU node, the run's live objects each attributed (owner,
    creating task or put), and the worker's device snapshot naming the
    card with at least GPT-2 small's parameters and AdamW's moments in
    fp32 in use, the driver node reporting no device; after it,
    ``list_tasks`` / ``summarize_tasks`` count the run's calls and
    ``memory_summary``'s total equals the agents' store bytes; the seven
    kernels launched as in 5b. Printed: spans a step, the GPU node's
    clock offset and RTT, ms/step with tracing on beside 5b's. Then the
    TTFT check (``ttft_check``). Returns the report entry."""
    import ray_tpu_torch
    from ray_tpu_torch import state
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.cluster.traces import critical_path, find_root
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.scripts.measure import measure_trainer_gpt2
    from ray_tpu_torch.util import tracing

    n_steps = WARMUP + STEPS
    calls = n_steps + 1
    state_bytes = 3 * 4 * cfg.n_params  # parameters + AdamW's two moments
    config.override("trace_sample_rate", 1.0)  # keep the run's trace
    torch.cuda.empty_cache()
    cluster = Cluster()
    poll = None
    try:
        drv = cluster.add_node(num_gpus=0)
        gpu = cluster.add_node(num_gpus=1)
        cluster.wait_for_nodes()
        if held is None:
            held = measure_trainer_gpt2(cfg, BATCH, steps=n_steps,
                                        warmup=WARMUP, device="cuda",
                                        address=cluster.address)
            print(f"observe: the untraced run on this cluster stands in for "
                  f"phase 5b: {held['ms_step']:.2f} ms/step")
        poll = _ObservePoll(cluster.address)
        tracing.enable()
        tracing.drain()
        # A driver-held object for the fit's length, put through a second
        # connection of this process (the run makes and closes its own):
        # the seed-1 batch's tokens, as the loop makes them. The run's own
        # objects, its calls' returns, live for milliseconds.
        from ray_tpu_torch.cluster.client import connect

        holder = connect(cluster.address)
        held_ref = holder.put(torch.randint(
            0, cfg.vocab_size, (BATCH, cfg.seq_len + 1), device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(1)
        ).cpu().numpy())
        with tracing.span("chip_smoke.observe") as root:
            run = measure_trainer_gpt2(cfg, BATCH, steps=n_steps,
                                       warmup=WARMUP, device="cuda",
                                       address=cluster.address)
        poll.stop()
        held_id = held_ref.id
        del held_ref
        holder.shutdown()
        ray_tpu_torch.init(address=cluster.address)
        tid = root["trace_id"]

        def assembled():
            tr = state.get_trace(tid)
            steps = [sp for sp in (tr or {}).get("spans", ())
                     if sp["name"] == "train.step"]
            return tr if len(steps) >= n_steps and any(
                sp["span_id"] == root["span_id"] for sp in tr["spans"]) \
                else None

        trace = None
        deadline = time.monotonic() + 60
        while trace is None and time.monotonic() < deadline:
            trace = assembled()
            time.sleep(0.25)
        require(trace is not None, f"observe: the trace {tid} was not "
                f"assembled: {state.list_traces()}")
        tstats = state.trace_stats()
        summary = state.summarize_tasks()
        tasks = state.list_tasks(limit=100_000)
        summary_ok = _wait_until(lambda: state.memory_summary()["totals"][
            "bytes_used"] == sum(n.store.stats()["used"]
                                 for n in cluster.nodes), 20.0)
        mem = state.memory_summary()["totals"]
    finally:
        if poll is not None:
            poll.stop()
        tracing.disable()
        tracing.drain()
        ray_tpu_torch.shutdown()
        cluster.shutdown()
        config.reset("trace_sample_rate")
    spans = trace["spans"]
    by_id = {sp["span_id"]: sp for sp in spans}
    steps = [sp for sp in spans if sp["name"] == "train.step"]
    pids = {sp.get("pid") for sp in spans}
    worker_pids = {sp.get("pid") for sp in steps}
    inside = all(
        sp["parent_id"] in by_id
        and by_id[sp["parent_id"]]["start_ns"] <= sp["start_ns"]
        and sp["end_ns"] <= by_id[sp["parent_id"]]["end_ns"]
        for sp in steps)
    top = find_root(spans)
    path = critical_path(spans)
    covered = sum(seg["t1_ns"] - seg["t0_ns"] for seg in path)
    clock = tstats["clock"].get(gpu.node_id, {})
    worker_peak = max((v for (nid, _w), v in poll.peak.items()
                       if nid == gpu.node_id), default=0)
    objects = list(poll.objects.values())
    objs_ok = any(o["object_id"] == held_id and o["task"] == "driver"
                  for o in objects) and all(
        o["owner"] and o["task"] for o in objects)
    run_calls = summary.get("run", {}).get("states", {}).get("FINISHED", 0)
    same = run["losses"] == held["losses"]
    print(f"observe: CudaTrainer(...).fit() on a Cluster (driver node, GPU "
          f"node) with tracing on in the driver and the worker [{smi}]: "
          f"{run['ms_step']:.2f} ms/step against phase 5b's "
          f"{held['ms_step']:.2f} ({run['ms_step'] / held['ms_step'] - 1:+.2%}"
          f"); losses {'the same bits as' if same else 'differ from'} 5b's; "
          f"trace {tid}: {len(spans)} spans from {len(pids)} processes, "
          f"{len(spans) / n_steps:.1f} spans a step, {len(steps)} "
          f"train.step spans (all under run: spans of pid "
          f"{sorted(worker_pids)}), root {top['name']}, critical path "
          f"{covered} ns of the root's {top['end_ns'] - top['start_ns']} ns; "
          f"the GPU node's clock offset {clock.get('offset_s', 0.0) * 1e6:.1f}"
          f" us, RTT {clock.get('rtt_s', 0.0) * 1e6:.1f} us "
          f"({clock.get('samples', 0)} probes)")
    print(f"observe: state during the fit ({poll.polls} polls): the trainer "
          f"worker ALIVE on the GPU node {gpu.node_id in poll.trainer_nodes}; "
          f"{len(objects)} objects seen live, the driver's among them and "
          f"every one with its owner and task {objs_ok} (tasks "
          f"{sorted({o['task'] for o in objects})})"
          f"; device {sorted(poll.kinds)} with {worker_peak / 2**30:.3f} GiB "
          f"in use at most in the worker (parameters + AdamW moments "
          f"{state_bytes / 2**30:.3f} GiB); nodes reporting a device "
          f"{['GPU node' if n == gpu.node_id else n for n in poll.device_nodes]}"
          f"; after it: {len(tasks)} task records, 'run' finished "
          f"{run_calls}, memory_summary {mem['bytes_used']} B = the agents' "
          f"store bytes {summary_ok}")
    require(same, f"observe: losses {run['losses']} differ from 5b's "
            f"{held['losses']}")
    require(len(pids) >= 2 and worker_pids and root["pid"] not in
            worker_pids, f"observe: spans from pids {pids}")
    require(all(sp["trace_id"] == tid for sp in steps) and inside,
            "observe: a train.step span is not under its parent")
    require(top["span_id"] == root["span_id"],
            f"observe: the trace's root is {top['name']}")
    require(covered == top["end_ns"] - top["start_ns"],
            "observe: the critical path does not cover the root interval")
    require(gpu.node_id in poll.trainer_nodes,
            "observe: the trainer's worker was not listed ALIVE")
    require(objs_ok, f"observe: objects without attribution, or the "
            f"driver's missing: {objects[:4]}")
    fresh_kinds = {d.get("device_kind") for sn in poll.fresh
                   for d in sn.get("devices") or ()}
    require(smi.split(",")[0].strip() in fresh_kinds,
            f"observe: device_stats(fresh=True) named {fresh_kinds}, "
            f"nvidia-smi {smi}")
    require(worker_peak >= state_bytes, f"observe: the worker's bytes in "
            f"use {worker_peak} < {state_bytes}")
    require(drv.node_id not in poll.device_nodes,
            "observe: the driver node reported a device")
    require(run_calls >= 1 and any(t["name"] == "run" for t in tasks),
            f"observe: summarize_tasks {summary}")
    require(summary_ok, "observe: memory_summary differs from the stores")
    for k in PORTED:
        want = held.get("launches", {}).get(k) if held.get("launches") \
            else None
        got = run["launches"].get(k, 0)
        require(want is None or got == want, f"observe: {k} launched {got} "
                f"times in the worker, 5b {want}")
    require(sum(run["launches"].get(k, 0) for k in PORTED) > 0,
            "observe: no kernel launched in the worker")
    ttft = ttft_check(torch, smi)
    return {"ms_step": run["ms_step"], "held_ms_step": held["ms_step"],
            "losses_equal_5b": same, "spans": len(spans),
            "spans_per_step": len(spans) / n_steps,
            "processes": len(pids), "train_step_spans": len(steps),
            "clock": clock, "worker_peak_bytes": worker_peak,
            "state_bytes": state_bytes, "objects": len(objects),
            "task_records": len(tasks), "launches": run["launches"],
            "calls": calls, "ttft": ttft}


OPERATE_STEPS = 160
OPERATE_SLO_S = 0.5
OPERATE_CHAOS = {"action": "delay", "method": "worker_events", "arg": 0.02}


def _failpoint_sites(table: dict, out=None) -> set:
    """(process path, site) of every armed site in a nested
    ``list_failpoints`` table."""
    out = set() if out is None else out
    for key, val in (table or {}).items():
        if isinstance(val, dict) and "site" in val and "spec" in val:
            out.add(key)
        elif isinstance(val, dict):
            for site in _failpoint_sites(val):
                out.add(f"{key}/{site}")
    return out


def operate_phase(torch, cfg, held, smi):
    """Phase 12: phase 5b's run, ``OPERATE_STEPS`` steps long, on a
    ``Cluster(metrics_port=0)`` of a GPU-less driver node and one GPU
    node, with log capture on and the signal and SLO loops every
    ``OPERATE_SLO_S`` s; the loop prints each step's loss. While the fit
    runs, through ``ray_tpu_torch.state`` on the driver's connection: the
    worker's stack, a 1.0 s ``capture_profile`` downloaded through the
    head, a 20 ms delay rule on the ``worker_events`` upload armed in
    every process, listed and cleared, ``/metrics/cluster`` over HTTP
    beside ``device_stats``, and two SLOs, one that holds and one that
    burns. After it: the worker's logs and the driver's ``LOGS`` lines,
    the federated step count and a windowed rate, and a failpoint fanned
    out to the GPU node's workers failing a ``num_gpus`` task. ``held``:
    phase 5b's run (None: a run on this cluster first stands in).
    Returns the report entry."""
    import threading
    import urllib.request

    import ray_tpu_torch
    from ray_tpu_torch import state
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.cluster.gcs_client import GcsClient
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.core.object_ref import TaskError
    from ray_tpu_torch.scripts.measure import (kernel_event_counts,
                                               measure_trainer_gpt2,
                                               task_node)
    from ray_tpu_torch.util import metrics as m

    n_ref = WARMUP + STEPS
    calls = OPERATE_STEPS + 1  # the steps, and step_cost's call
    state_bytes = 3 * 4 * cfg.n_params  # parameters + AdamW's two moments
    settings = {"signal_scrape_interval_s": OPERATE_SLO_S,
                "slo_eval_interval_s": OPERATE_SLO_S}
    for k, v in settings.items():
        config.override(k, v)
    progress = OUT / "operate_progress.jsonl"
    cap_dir = OUT / "operate_capture"
    shutil.rmtree(cap_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    cluster = Cluster(metrics_port=0)
    ops: dict = {}
    events: list = []
    gcs = None
    metrics_address = None
    try:
        drv = cluster.add_node(num_gpus=0)
        gpu = cluster.add_node(num_gpus=1)
        cluster.wait_for_nodes()
        metrics_address = cluster.head.metrics_address
        url = f"http://{metrics_address}/metrics/cluster"
        if held is None:
            held = measure_trainer_gpt2(cfg, BATCH, steps=n_ref,
                                        warmup=WARMUP, device="cuda",
                                        address=cluster.address)
            print(f"operate: a run on this cluster stands in for phase "
                  f"5b: {held['ms_step']:.2f} ms/step")
        progress.unlink(missing_ok=True)

        def federated_steps() -> float:
            parsed = m.parse_prometheus(urllib.request.urlopen(
                url, timeout=30).read().decode())
            return sum(v for k, v in parsed.get(
                "ray_tpu_train_step_phase_seconds_count", {}).items()
                if dict(k).get("node_id") == gpu.node_id
                and dict(k).get("phase") == "step")

        steps_before = federated_steps()  # a stand-in run's, if any
        gcs = GcsClient(cluster.address)
        gcs.pubsub.subscribe("chip-smoke-slo", "SLO")
        stop = threading.Event()

        def watch_slo():
            while not stop.is_set():
                try:
                    msgs, _ = gcs.pubsub.poll("chip-smoke-slo", timeout=0.5)
                except Exception:
                    continue
                events.extend(dict(mm["data"], seen=time.time())
                              for mm in msgs)

        def operate():
            # The driver is connected once the loop has reported a step.
            try:
                if not _wait_until(lambda: any(
                        p["step"] >= 1 for p in _progress(progress)), 600):
                    raise RuntimeError("no step reported")
                wid = _progress(progress)[0]["worker_id"]
                ops["worker_id"] = wid
                ops["slo_t0"] = time.time()
                ops["slo_ok"] = state.register_slo(
                    "ok", "step_p99 < 60s over 30s")
                ops["slo_burn"] = state.register_slo(
                    "burn", "mfu > 99% over 30s")
                ops["stack"] = state.dump_stack(wid)
                _wait_until(lambda: any(
                    sn.get("worker_id") == wid and sn.get("devices")
                    for sn in state.device_stats()), 10)
                before = state.device_stats()
                ops["scrape"] = urllib.request.urlopen(
                    url, timeout=30).read().decode()
                ops["devices"] = [before, state.device_stats()]
                ops["chaos_armed"] = state.set_channel_chaos(
                    [OPERATE_CHAOS])
                ops["chaos_listed"] = state.list_channel_chaos()
                ops["chaos_cleared"] = state.clear_channel_chaos()
                ops["chaos_after"] = state.list_channel_chaos()
                # Last: the worker's first window imports the profiler's
                # dependencies first (seconds, once), and its CUDA thread
                # waits for the import.
                ops["cap_t0"] = time.time()
                ops["capture"] = state.capture_profile(
                    wid, duration_s=1.0, out_dir=str(cap_dir))
                ops["cap_t1"] = time.time()
                _wait_until(lambda: any(e.get("slo") == "burn"
                                        for e in events), 60)
            except BaseException as e:  # reported and held below
                ops["error"] = repr(e)

        threads = [threading.Thread(target=watch_slo, daemon=True),
                   threading.Thread(target=operate, daemon=True)]
        for t in threads:
            t.start()
        run = measure_trainer_gpt2(
            cfg, BATCH, steps=OPERATE_STEPS, warmup=WARMUP, device="cuda",
            address=cluster.address, progress_path=str(progress),
            print_loss=True, stay_connected=True, ckpt_every=0)
        threads[1].join(120)
        require("error" not in ops and not threads[1].is_alive(),
                f"operate: the operator's thread: {ops.get('error')}")
        wid = ops["worker_id"]
        want_lines = [f"step {i + 1} loss {loss!r}"
                      for i, loss in enumerate(run["losses"])]
        backend = worker_mod.backend()
        got_driver = []

        def driver_lines():
            got_driver[:] = [r["line"] for r in backend.received_logs()
                             if r["worker_id"] == wid
                             and r["line"].startswith("step ")]
            return got_driver == want_lines

        driver_ok = _wait_until(driver_lines, 30)
        logged = [ln for ln in state.get_log(
            wid, tail_lines=OPERATE_STEPS + 200).splitlines()
            if ln.startswith("step ")]
        followed = "".join(c["data"] for c in state.follow_log(
            wid, idle_timeout_s=1.0))
        followed = [ln for ln in followed.splitlines()
                    if ln.startswith("step ")]
        step_count = federated_steps() - steps_before
        after = m.parse_prometheus(urllib.request.urlopen(
            url, timeout=30).read().decode())
        reports = len(run["reports"]) + 1  # the step reports and the final
        rate = state.query_metrics({
            "op": "rate", "name": "ray_tpu_train_reports_total",
            "window_s": 30.0, "match": {"node_id": gpu.node_id}})
        slos = state.slo_status()
        series = slos.get("series")
        scrape_d = m.histogram_dist(after, "ray_tpu_head_signal_scrape_seconds")
        stop.set()
        for name in ("ok", "burn"):
            state.remove_slo(name)
        slo_left = set(state.slo_status()["slos"])
        # The failpoint, fanned out to the GPU node's workers.
        site = "worker.execute.before"
        fp_out = state.set_failpoints({site: "raise:chip smoke"})
        fp_listed = _failpoint_sites(state.list_failpoints())
        fp_error = None
        try:
            ray_tpu_torch.get(ray_tpu_torch.remote(task_node).options(
                num_gpus=1, max_retries=0).remote(), timeout=300)
        except TaskError as e:
            fp_error = str(e)
        state.set_failpoints({site: None})
        fp_cleared = _failpoint_sites(state.list_failpoints())
        fp_node = ray_tpu_torch.get(ray_tpu_torch.remote(task_node).options(
            num_gpus=1, max_retries=0).remote(), timeout=300)
    finally:
        if gcs is not None:
            gcs.close()
        ray_tpu_torch.shutdown()
        cluster.shutdown()
        for k in settings:
            config.reset(k)
    # The capture: a torch.profiler trace of the worker, its kernels by
    # their __global__ names in the device events.
    cap = ops["capture"]
    trace_path = next(p for p in cap["files"] if p.endswith(".json"))
    trace_bytes = os.path.getsize(trace_path)
    with open(trace_path) as f:
        counts = kernel_event_counts(json.load(f))
    shutil.rmtree(cap_dir, ignore_errors=True)
    gpt2_kernels = NORM_KERNELS + FLASH_KERNELS
    # ms/step: the capture window's steps apart from the rest.
    reps = [r for r in run["reports"] if r["step"] > WARMUP]
    # The window opens after the import; steps reported from the RPC's
    # start to its end, past the window's, are neither set.
    win0 = ops["cap_t0"] + (cap.get("import_s") or 0.0)
    inside = [r for r in reps
              if win0 <= r["wall"] <= win0 + cap["duration_s"] + 0.5]
    outside = [r for r in reps
               if not ops["cap_t0"] <= r["wall"] <= ops["cap_t1"] + 0.5]

    def ms(rs):
        rs = sorted(rs, key=lambda r: r["step"])
        gaps = [(b["t"] - a["t"] - b["save_s"]) * 1e3
                for a, b in zip(rs, rs[1:]) if b["step"] == a["step"] + 1]
        return sum(gaps) / len(gaps) if gaps else float("nan")

    # The device gauges against device_stats, read during the fit.
    parsed = m.parse_prometheus(ops["scrape"])
    in_use = {dict(k)["worker_id"]: v for k, v in parsed.get(
        "ray_tpu_device_memory_bytes_in_use", {}).items()
        if dict(k)["node_id"] == gpu.node_id}
    snap_bytes = [d.get("bytes_in_use") for snaps in ops["devices"]
                  for sn in snaps if sn.get("worker_id") == wid
                  for d in sn.get("devices") or ()]
    store_nodes = {dict(k)["node_id"] for k in parsed.get(
        "ray_tpu_object_store_bytes_used", {})}
    chaos = ops["chaos_listed"]
    chaos_everywhere = (
        [r["method"] for r in chaos["head"]] == ["worker_events"]
        and all([r["method"] for r in chaos[n]["agent"]] == ["worker_events"]
                for n in (drv.node_id, gpu.node_id))
        and [r["method"] for r in chaos[gpu.node_id].get(wid, [])]
        == ["worker_events"])
    chaos_gone = (ops["chaos_after"]["head"] == [] and all(
        rules == [] for n in (drv.node_id, gpu.node_id)
        for rules in ops["chaos_after"][n].values()))
    burning = [e for e in events if e.get("slo") == "burn"
               and e.get("state") == "burning"]
    to_burning = (burning[0]["seen"] - ops["slo_t0"]) if burning else None
    ok_events = [e for e in events if e.get("slo") == "ok"]
    same = run["losses"][:n_ref] == held["losses"]
    launch_ok = all(run["launches"].get(k, 0) * (n_ref + 1)
                    == held["launches"].get(k, 0) * calls
                    for k in PORTED)
    fp_in = {p for p in fp_listed if p.endswith(site)}
    print(f"operate: CudaTrainer(...).fit() of {OPERATE_STEPS} steps on a "
          f"Cluster (driver node, GPU node; metrics on {metrics_address}"
          f", signal and SLO loops every {OPERATE_SLO_S} s) [{smi}]: "
          f"{ms(outside):.2f} ms/step outside the capture window, "
          f"{ms(inside):.2f} inside it ({len(inside)} steps), against phase "
          f"5b's {held['ms_step']:.2f}; the first {n_ref} losses "
          f"{'the same bits as' if same else 'differ from'} 5b's; launches "
          f"per call {'equal to' if launch_ok else 'differ from'} 5b's")
    print(f"operate: profile of worker {wid}: {cap['kind']}, "
          f"{trace_bytes} B of trace, kernel events in the 1.0 s window "
          f"{ {k: counts[k] for k in gpt2_kernels} }; the worker's first "
          f"window imported the profiler's dependencies for "
          f"{cap.get('import_s') or 0.0:.2f} s first, the RPC "
          f"{ops['cap_t1'] - ops['cap_t0']:.2f} s in all")
    print(f"operate: stack names the loop's frame "
          f"{'trainer_gpt2_loop' in ops['stack']}; logs: get_log "
          f"{len(logged)} loss lines, follow_log {len(followed)}, the "
          f"driver over LOGS {len(got_driver)}, all equal to the reported "
          f"{logged == want_lines and followed == want_lines and driver_ok}")
    print(f"operate: /metrics/cluster during the fit: the worker's device "
          f"bytes in use {sorted(in_use.values())} (device_stats "
          f"{sorted(set(snap_bytes))}; parameters + AdamW moments "
          f"{state_bytes}), store gauges of {len(store_nodes & {drv.node_id, gpu.node_id})}"
          f" nodes; after it: step count {step_count} of {reports} reports, "
          f"rate {rate.get('value')} reports/s over {rate.get('window_s')} s;"
          f" scrape {scrape_d['sum'] / scrape_d['count'] * 1e3 if scrape_d else float('nan'):.2f}"
          f" ms a scrape ({int(scrape_d['count']) if scrape_d else 0} scrapes), "
          f"{series} series in the ring")
    print(f"operate: SLOs: 'ok' {slos['slos'].get('ok', {}).get('state')} "
          f"({len(ok_events)} events), 'burn' "
          f"{slos['slos'].get('burn', {}).get('state')} "
          f"({len(burning)} burning events) after {to_burning} s; chaos "
          f"rule listed in head, both agents and the worker "
          f"{chaos_everywhere}, cleared {chaos_gone}; failpoint in "
          f"{sorted(fp_in)}, the task failed "
          f"{'with FailpointError' if fp_error and 'FailpointError' in fp_error else fp_error}"
          f", disarmed {not any(p.endswith(site) for p in fp_cleared)}")
    require(same, f"operate: losses {run['losses'][:n_ref]} differ from "
            f"5b's {held['losses']}")
    require(launch_ok, f"operate: launches {run['launches']} over {calls} "
            f"calls, 5b {held['launches']} over {n_ref + 1}")
    require("trainer_gpt2_loop" in ops["stack"],
            "operate: the stack does not name the loop")
    require(cap["kind"] == "torch_profiler", f"operate: capture {cap}")
    require(all(counts[k] > 0 for k in gpt2_kernels),
            f"operate: the trace names {counts}")
    require(logged == want_lines and followed == want_lines,
            f"operate: get_log {logged[:3]}..., follow_log {followed[:3]}..."
            f" against {want_lines[:3]}...")
    require(driver_ok, f"operate: the driver got {len(got_driver)} lines")
    require(any(v >= state_bytes for v in in_use.values()),
            f"operate: device bytes in use {in_use} < {state_bytes}")
    require(any(v in snap_bytes for v in in_use.values()),
            f"operate: the gauge {in_use} is not device_stats' {snap_bytes}")
    require({drv.node_id, gpu.node_id} <= store_nodes,
            f"operate: store gauges of {store_nodes}")
    require(step_count == reports,
            f"operate: {step_count} steps federated, {reports} reported")
    require((rate.get("value") or 0) > 0, f"operate: rate {rate}")
    require(ops["slo_ok"]["ok"] and ops["slo_burn"]["ok"],
            f"operate: register_slo {ops['slo_ok']} {ops['slo_burn']}")
    require(slos["slos"]["ok"]["state"] == "ok" and not ok_events,
            f"operate: the 'ok' SLO {slos['slos']['ok']}")
    require(len(burning) == 1 and slos["slos"]["burn"]["state"] == "burning",
            f"operate: burn events {burning}, {slos['slos']['burn']}")
    require(not slo_left & {"ok", "burn"}, f"operate: SLOs left {slo_left}")
    require(chaos_everywhere and chaos_gone,
            f"operate: chaos listed {chaos}, after {ops['chaos_after']}")
    require(f"head/{site}" in fp_in and all(
        any(p.startswith(f"{n}/agent/") for p in fp_in)
        for n in (drv.node_id, gpu.node_id)) and any(
        p.startswith(f"{gpu.node_id}/w-") for p in fp_in),
        f"operate: the failpoint armed in {sorted(fp_listed)} ({fp_out})")
    require(fp_error is not None and "FailpointError" in fp_error,
            f"operate: the armed task gave {fp_error}")
    require(not any(p.endswith(site) for p in fp_cleared)
            and fp_node == gpu.node_id,
            f"operate: after disarming {sorted(fp_cleared)}, {fp_node}")
    return {"ms_step": ms(outside), "ms_step_capture": ms(inside),
            "held_ms_step": held["ms_step"], "losses_equal_5b": same,
            "steps": OPERATE_STEPS, "calls": calls,
            "launches": run["launches"],
            "launches_per_call": {k: run["launches"].get(k, 0) / calls
                                  for k in PORTED},
            "trace_bytes": trace_bytes, "kernel_events": counts,
            "capture_import_s": cap.get("import_s"),
            "capture_rpc_s": ops["cap_t1"] - ops["cap_t0"],
            "device_bytes_in_use": sorted(in_use.values()),
            "step_count": step_count, "reports": reports,
            "rate": rate.get("value"), "series": series,
            "scrape_ms": (scrape_d["sum"] / scrape_d["count"] * 1e3
                          if scrape_d else None),
            "seconds_to_burning": to_burning}


# -- phase 15 ------------------------------------------------------------------


def streamed_split_phase(torch, counters, cfg, ingest, smi):
    """Phase 15b: phase 8a's ingest again (``ingest_dataset``, through
    ``measure_trainer_gpt2(dataset=ds)``) with ``target_block_size_bytes``
    at STREAM_TARGET_BYTES, below one block of 8 rows of 1025 int64
    tokens (65,600 B): every block splits, and ``_execute_split`` runs its
    stage as streaming tasks. The kernel counters are set to 0 just
    before the fit and read just after. Holds: the losses equal to 8a's
    (``ingest``) to the bit; the seven kernels' launches equal to 8a's;
    the stage's ``splits`` equal to ``block.split_cuts``'s count over the
    blocks, and the blocks' rows its pieces'. Returns the report entry."""
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.data import block as B
    from ray_tpu_torch.scripts.measure import measure_trainer_gpt2

    n_steps = WARMUP + STEPS
    ds, tokens = ingest_dataset(torch, cfg, n_steps)
    cuts = B.split_cuts({"tokens": tokens}, STREAM_TARGET_BYTES)
    want_splits = n_steps * (len(cuts) - 2)
    want_rows = [b - a for a, b in zip(cuts, cuts[1:])] * n_steps
    config.override("target_block_size_bytes", STREAM_TARGET_BYTES)
    try:
        for c in counters:
            c.clear()
        t0 = time.perf_counter()
        run = measure_trainer_gpt2(cfg, BATCH, steps=n_steps, warmup=WARMUP,
                                   device="cuda", dataset=ds)
        wall = time.perf_counter() - t0
        launches = {k: sum(c[k] for c in counters) for k in PORTED}
    finally:
        config.reset("target_block_size_bytes")
    stage = ds.stats().lineage()[-1]
    splits = (stage.extra or {}).get("splits", 0)
    run.update(launches=launches, splits=splits, want_splits=want_splits,
               block_rows=ds._block_rows, wall_s=wall)
    bits = run["losses"] == ingest["losses"]
    print(f"15b streamed split: phase 8a's ingest with target_block_size_bytes"
          f"={STREAM_TARGET_BYTES} (a block {tokens.nbytes} B) [{smi}]: "
          f"{ds.num_blocks} blocks of rows {ds._block_rows[:len(cuts) - 1]}"
          f"... from {n_steps}, splits {splits} (split_cuts: {want_splits}); "
          f"{run['ms_step']:.2f} ms/step vs 8a's {ingest['ms_step']:.2f}; "
          f"fit {wall:.2f} s; losses equal 8a's to the bit {bits}; launches "
          f"{launches}")
    require(bits, f"15b: losses {run['losses']} differ from 8a's "
            f"{ingest['losses']}")
    for k in PORTED:
        require(launches[k] == ingest["launches"][k],
                f"15b: {k} launched {launches[k]} times, 8a "
                f"{ingest['launches'][k]}")
    require(splits == want_splits and ds._block_rows == want_rows,
            f"15b: splits {splits} (split_cuts {want_splits}), block rows "
            f"{ds._block_rows} (want {want_rows})")
    return run


def streams_phase(torch, counters, cfg, ingest, predict, serving, params,
                  smi):
    """Phase 15: streaming returns, pushed task errors and an async actor
    on the H100. 15b (``streamed_split_phase``) runs first, on the local
    backend; then, on a ``Cluster`` of one node with the card
    (``num_gpus=1``):

    15a. a ``num_gpus=1, num_returns="streaming"`` task
    (``measure.score_stream``) scores phase 8b's PREDICT_ROWS rows at
    batch PREDICT_BATCH with ``gpt2_score`` on 8a's parameters (``params``,
    put in the store and passed as a ref, as D8 does) and yields each
    batch's NLL: PREDICT_ROWS / PREDICT_BATCH items. Held: every item bit
    for bit 8b's scores of its rows (``predict``); the driver read item 0
    before the worker stamped its last yield; each batch launched
    ``ln_fwd``, ``gelu_fwd`` and ``flash_fwd`` 25, 12 and 12 times in the
    worker, and no other kernel. Then the same task, its generator dropped
    after STREAM_DROP_AFTER items. Held, through ``ray_tpu_torch.state``:
    the task ended short of the last batch (its record, and its worker's
    ``yield`` lines), and within 10 s the head lists no object of the
    stream from index STREAM_DROP_AFTER on.
    15d. a ``num_gpus=1`` task that raises on the node. Held: its task id,
    name and error text reach the driver's ``ERRORS`` subscription within
    10 s of the driver seeing the error.
    15c. an async actor (``measure.AsyncEngineHost``, ``num_gpus=1``)
    builds phase 7's GPT-2 ``LLMEngine`` in its constructor; phase 7's
    SERVE_REQUESTS prompts go to its ``async def generate`` at once. Held:
    every output equal to phase 7's greedy tokens (``serving``); the
    calls overlapped (the engine's peak of active slots at 2 or more, its
    ``llm_stats`` sampled by the actor's poller). Printed: latency a
    request and decode tok/s beside phase 7's in-process engine.
    Returns the report entries."""
    import gc

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch import state
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.scripts.measure import (SERVE_ENGINES, AsyncEngineHost,
                                               fail_on_gpu, score_stream,
                                               serve_prompts)

    out = {"split": streamed_split_phase(torch, counters, cfg, ingest, smi)}
    gc.collect()
    torch.cuda.empty_cache()
    tokens = predict_tokens(torch, cfg)
    want = np.asarray(predict["nll"], dtype=np.float32)
    n_items = PREDICT_ROWS // PREDICT_BATCH
    ray_tpu_torch.shutdown()  # the local runtime of the phases before
    cluster = Cluster()
    try:
        t0 = time.perf_counter()
        cluster.add_node(num_gpus=1, store_capacity=STREAM_STORE_BYTES)
        cluster.wait_for_nodes()
        ray_tpu_torch.init(address=cluster.address, log_to_driver=False)
        pref = ray_tpu_torch.put(params)
        task = ray_tpu_torch.remote(score_stream).options(
            num_gpus=1, num_returns="streaming")

        # 15a: the whole stream, then the same task dropped.
        t1 = time.perf_counter()
        items, read0 = [], None
        for ref in task.remote(pref, tokens, PREDICT_BATCH, "15a-full"):
            items.append(ray_tpu_torch.get(ref, timeout=600))
            if read0 is None:
                read0 = time.time()  # the driver has item 0
        stream_s = time.perf_counter() - t1
        got = np.concatenate([it["nll"] for it in items])
        bits = bool(np.array_equal(got, want))
        per_batch = [it["launches"] for it in items]
        stamps = [it["t_yield"] for it in items]
        gen = task.remote(pref, tokens, PREDICT_BATCH, "15a-drop")
        drop_pid = None
        for _ in range(STREAM_DROP_AFTER):
            drop_pid = ray_tpu_torch.get(next(gen), timeout=600)["pid"]
        task_id = gen._task_id
        t_drop = time.perf_counter()
        del gen
        gc.collect()

        def ended():
            recs = [r for r in state.list_tasks(100_000)
                    if r["task_id"] == task_id
                    and r["state"] not in ("PENDING", "RUNNING")]
            return recs[0] if recs else None

        def tail_listed():
            return sorted(int(o["object_id"][32:], 16)
                          for o in state.list_objects(100_000)
                          if o["object_id"].startswith(task_id)
                          and int(o["object_id"][32:], 16)
                          >= STREAM_DROP_AFTER)

        rec = _wait_until(ended, 30.0) and ended()
        require(_wait_until(lambda: not tail_listed(), 10.0),
                f"15a: the head still lists the dropped stream's items "
                f"{tail_listed()} 10 s after the drop")
        gone_s = time.perf_counter() - t_drop
        wid = next((r["worker_id"] for r in state.list_logs()
                    if r["pid"] == drop_pid), None)
        log = state.get_log(wid, tail_lines=1000) if wid else ""
        yields = sum(1 for line in log.splitlines()
                     if line.startswith("15a-drop yield "))
        print(f"15a streaming task: GPT-2 {cfg.n_params / 1e6:.0f}M "
              f"gpt2_score over {PREDICT_ROWS} rows x {cfg.seq_len} tokens at "
              f"batch {PREDICT_BATCH} in a num_gpus=1 worker, "
              f"{len(items)} items [{smi}]: {stream_s:.3f} s for the stream "
              f"({PREDICT_ROWS / stream_s:.1f} rows/s, the worker's start "
              f"and the parameters' upload included) vs 8b's "
              f"{predict['rows_s']:.1f} rows/s; the worker's yields "
              f"{(stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1):.2f} ms "
              f"apart; item 0 read {(read0 - stamps[0]) * 1e3:.2f} ms after "
              f"its yield, {(stamps[-1] - read0) * 1e3:.2f} ms before the "
              f"last yield; bits equal 8b's {bits}; launches a batch "
              f"{per_batch[0]}")
        print(f"15a dropped after {STREAM_DROP_AFTER} items [{smi}]: the "
              f"task's record {rec and rec['state']} "
              f"({rec and (rec.get('error') or '')[:60]}), its worker logged "
              f"{yields} of {n_items} yields; the head listed none of the "
              f"tail {gone_s:.3f} s after the drop")
        require(len(items) == n_items, f"15a: {len(items)} items")
        require(bits, "15a: streamed NLL differs from 8b's")
        require(read0 < stamps[-1], f"15a: item 0 read at {read0}, after "
                f"the last yield at {stamps[-1]}")
        for i, launched in enumerate(per_batch):
            require(launched == FORWARD_LAUNCHES, f"15a: batch {i} launched "
                    f"{launched}, expected {FORWARD_LAUNCHES}")
        require(rec is not None and rec["state"] != "FINISHED",
                f"15a: the dropped task's record {rec}")
        require(0 < yields < n_items, f"15a: the dropped task yielded "
                f"{yields} of {n_items} batches")
        out["stream"] = {
            "items": len(items), "bits_equal_8b": bits, "stream_s": stream_s,
            "yield_ms": (stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1),
            "read0_before_last_yield_ms": (stamps[-1] - read0) * 1e3,
            "launches_per_batch": per_batch[0], "dropped_yields": yields,
            "dropped_state": rec["state"], "tail_gone_s": gone_s}
        del pref

        # 15d: a task error pushed on ERRORS.
        head = worker_mod.backend().head
        head.call("pubsub_subscribe", "chip-smoke-errors", "ERRORS")
        t_sub = time.perf_counter()
        ref = ray_tpu_torch.remote(fail_on_gpu).options(num_gpus=1).remote(
            "chip-smoke 15d")
        failed = ""
        try:
            ray_tpu_torch.get(ref, timeout=300)
        except ray_tpu_torch.TaskError as e:
            failed = str(e)
        t_err = time.perf_counter()
        pushed = None
        while pushed is None and time.perf_counter() - t_err < 10.0:
            for m in head.call("pubsub_poll", "chip-smoke-errors", 1.0)[0]:
                for e in m["data"]["errors"]:
                    if e["task_id"] == ref.id[:32]:
                        pushed = (m["data"], e)
        t_push = time.perf_counter()
        head.call("pubsub_unsubscribe", "chip-smoke-errors")
        print(f"15d pushed task error [{smi}]: the driver saw the error "
              f"{t_err - t_sub:.3f} s after the submit, ERRORS carried it "
              f"{t_push - t_err:.3f} s later: "
              f"{pushed and {**pushed[1], 'error': pushed[1]['error'][:80]}}")
        require("chip-smoke 15d" in failed, f"15d: the task gave {failed!r}")
        require(pushed is not None and pushed[1]["name"] == "fail_on_gpu"
                and "chip-smoke 15d" in (pushed[1]["error"] or "")
                and pushed[0]["node_id"] == cluster.nodes[0].node_id,
                f"15d: ERRORS carried {pushed} within 10 s")
        out["errors"] = {"error_s": t_err - t_sub, "pushed_s": t_push - t_err}

        # 15c: an async actor hosting the engine.
        t2 = time.perf_counter()
        host = ray_tpu_torch.remote(AsyncEngineHost).options(
            num_gpus=1).remote("gpt2", "small", SERVE_NEW_TOKENS)
        ray_tpu_torch.get(host.stats.remote(), timeout=600)
        build_s = time.perf_counter() - t2
        prompts = serve_prompts(SERVE_REQUESTS, cfg.vocab_size,
                                SERVE_ENGINES["gpt2"]["max_prompt_len"])
        t3 = time.perf_counter()
        refs = [host.generate.remote(p, SERVE_NEW_TOKENS) for p in prompts]
        done, pending = {}, list(refs)
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1,
                                                timeout=600)
            require(ready, "15c: no request finished in 600 s")
            now = time.perf_counter()
            for r in ready:
                done[r.id] = now
        wall = time.perf_counter() - t3
        outs = ray_tpu_torch.get(refs, timeout=60)
        stats = ray_tpu_torch.get(host.stats.remote(), timeout=60)
        ray_tpu_torch.kill(host)
        latency = sorted((done[r.id] - t3) * 1e3 for r in refs)
        n_tok = sum(len(o) for o in outs)
        ref7 = serving["gpt2"]
        equal = outs == ref7["tokens_out"]
        print(f"15c async actor hosting LLMEngine (GPT-2 small, "
              f"{SERVE_REQUESTS} requests x {SERVE_NEW_TOKENS} tokens at "
              f"once) [{smi}]: actor and engine up in {build_s:.2f} s; "
              f"{n_tok / wall:.1f} tok/s over the run ({wall:.3f} s) vs "
              f"phase 7's in-process {ref7['serve_tok_s']:.1f}; latency a "
              f"request p50 {np.percentile(latency, 50):.1f} ms p99 "
              f"{np.percentile(latency, 99):.1f} ms vs phase 7's p50 "
              f"{ref7['latency_ms_p50']:.1f} p99 {ref7['latency_ms_p99']:.1f};"
              f" peak active slots {stats['active_peak']} of "
              f"{stats['max_batch']}, mean occupancy "
              f"{stats['mean_occupancy']}; tokens equal phase 7's {equal}")
        require(equal, "15c: the actor's tokens differ from phase 7's")
        require(stats["active_peak"] >= 2,
                f"15c: the engine's peak active slots {stats['active_peak']}")
        out["async_actor"] = {
            "build_s": build_s, "wall_s": wall, "tok_s": n_tok / wall,
            "latency_ms_p50": float(np.percentile(latency, 50)),
            "latency_ms_p99": float(np.percentile(latency, 99)),
            "active_peak": stats["active_peak"],
            "mean_occupancy": stats["mean_occupancy"],
            "tokens_equal_phase7": equal}
        out["cluster_s"] = time.perf_counter() - t0
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
    return out


# -- phase 16 ------------------------------------------------------------------


def _maps_rtorch_segment() -> bool:
    """Whether this process maps one of the port's store segments."""
    with open("/proc/self/maps") as f:
        return any("/dev/shm/rtorch_" in line for line in f)


def _task_stages(r: dict, t_submit: float, t_got: float) -> dict:
    """Where a phase-16 scoring task's seconds went, from its wall times
    (``measure.score_rows_counted``'s, and ``t_call`` where the env's
    module stamped its call before importing the harness): to its
    worker's start (0 for a worker started before the submit), on to the
    call and through the harness's import (or, for a function the worker
    loaded with its module, on to the call with the import), the
    parameters onto the card (the CUDA context), the first batch, the
    other batches, and the result back to the driver."""
    start = max(r["t_process"], t_submit)
    out = {"to_worker_start": start - t_submit}
    if "t_call" in r:
        out.update(to_call=r["t_call"] - start,
                   harness_import=r["t_entry"] - r["t_call"])
    else:
        out["to_call_with_import"] = r["t_entry"] - start
    out.update(to_device=r["t_device"] - r["t_entry"],
               first_batch=r["t_first"] - r["t_device"],
               other_batches=r["t_end"] - r["t_first"],
               result_back=t_got - r["t_end"])
    return {k: round(v, 3) for k, v in out.items()}


def envs_phase(torch, cfg, predict, params, smi):
    """Phase 16: runtime envs and the ``ray://`` client on a ``Cluster`` of
    one node with the card (``num_gpus=1``), GPT-2 small at full width
    with 8a's parameters (``params``, numpy) and 8b's rows (``predict``
    holds 8b's NLLs). A module (ENV_MODULE_SOURCE) is written into a
    temporary directory, which this process puts on its own ``sys.path``
    as a user's script directory is, so its functions pickle by name. The
    cluster's agents run in this process and would hand its ``sys.path``
    to their workers; ``worker_pythonpath_exclude`` keeps the directory
    off them, as it is off the workers of a cluster on other machines.

    16a: the module's ``score`` as a ``num_gpus=1`` task with no env
    (held: an import error), then with ``runtime_env={"working_dir": dir,
    "env_vars": {"CHIP16_VAR": ...}}`` (held: 8b's NLLs bit for bit, the
    cwd under the node's env cache, the env var, FORWARD_LAUNCHES a batch
    and no other kernel), a second task of the env (held: the same pid,
    one ``rtenv:pkg:`` key in the head's KV) and a plain ``num_gpus=1``
    task of ``measure.score_rows_counted`` (held: another pid, the same
    NLLs). 16b: two ``num_gpus=0.5`` tasks of the module's
    ``version_of``, each with 16a's working_dir and its own ``py_modules``
    version of ENV_VERSION_MODULE, at once (held: versions 1 and 2, two
    pids, overlapping runs, no kernel launched). 16c: a
    ``ClientProxyServer`` on the cluster and ``chip_smoke.py
    --client-driver`` in a subprocess (``client_driver_main``; held as its
    docstring says). Returns the report entry."""
    import importlib
    import pickle
    import tempfile

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.scripts.measure import score_rows_counted
    from ray_tpu_torch.util.client import ClientProxyServer

    tokens = predict_tokens(torch, cfg)
    want = np.asarray(predict["nll"], dtype=np.float32)
    n_batches = PREDICT_ROWS // PREDICT_BATCH
    root = Path(tempfile.mkdtemp(prefix="chip16_"))
    wd = root / "app"
    wd.mkdir()
    (wd / f"{ENV_MODULE}.py").write_text(ENV_MODULE_SOURCE)
    versions = []
    for v in (1, 2):
        d = root / f"v{v}" / ENV_VERSION_MODULE
        d.mkdir(parents=True)
        (d / "__init__.py").write_text(f"VERSION = {v}\n")
        versions.append(str(d))
    env = {"working_dir": str(wd), "env_vars": {"CHIP16_VAR": ENV_VAR_VALUE}}
    sys.path.insert(0, str(wd))
    mod = importlib.import_module(ENV_MODULE)
    config.override("worker_pythonpath_exclude", ",".join(
        [config.worker_pythonpath_exclude, str(wd)]))
    ray_tpu_torch.shutdown()  # the local runtime of the phases before
    cluster = Cluster()
    proxy = None
    out = {}
    try:
        cluster.add_node(num_gpus=1, store_capacity=STREAM_STORE_BYTES)
        cluster.wait_for_nodes()
        node = cluster.nodes[0]
        ray_tpu_torch.init(address=cluster.address, log_to_driver=False)
        pref = ray_tpu_torch.put(params)
        score = ray_tpu_torch.remote(mod.score)

        # 16a: no env, then a working_dir and env vars.
        failed = ""
        try:
            ray_tpu_torch.get(score.options(num_gpus=1).remote(
                pref, tokens, PREDICT_BATCH), timeout=600)
        except ray_tpu_torch.TaskError as e:
            failed = str(e)
        require(f"No module named '{ENV_MODULE}'" in failed,
                f"16a: the task with no runtime_env gave {failed[-300:]!r}, "
                f"not an import error")
        t0, w0 = time.perf_counter(), time.time()
        first_ref = score.options(num_gpus=1, runtime_env=env).remote(
            pref, tokens, PREDICT_BATCH)
        first = ray_tpu_torch.get(first_ref, timeout=600)
        first_s = time.perf_counter() - t0
        stages = {"first": _task_stages(first, w0, time.time())}
        # The worker goes back to its env's pool once it reports the task
        # done, just after the result is stored.
        require(_wait_until(lambda: any(
            w.proc.pid == first["pid"]
            for pool in node._idle.values() for w in pool), 10.0),
            "16a: the env's worker did not return to its pool")
        t0, w0 = time.perf_counter(), time.time()
        second = ray_tpu_torch.get(score.options(
            num_gpus=1, runtime_env=env).remote(pref, tokens, PREDICT_BATCH),
            timeout=600)
        second_s = time.perf_counter() - t0
        stages["second"] = _task_stages(second, w0, time.time())
        t0, w0 = time.perf_counter(), time.time()
        plain = ray_tpu_torch.get(ray_tpu_torch.remote(
            score_rows_counted).options(num_gpus=1).remote(
                pref, tokens, PREDICT_BATCH), timeout=600)
        plain_s = time.perf_counter() - t0
        stages["plain"] = _task_stages(plain, w0, time.time())
        pkg_keys = cluster.head.rpc_kv_keys("rtenv:pkg:")
        direct_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            ray_tpu_torch.get(first_ref, timeout=60)
            direct_ms.append((time.perf_counter() - t0) * 1e3)
        bits = [bool(np.array_equal(r["nll"], want))
                for r in (first, second, plain)]
        print(f"16a runtime env (working_dir + env_vars), GPT-2 "
              f"{cfg.n_params / 1e6:.0f}M scoring {PREDICT_ROWS} rows x "
              f"{cfg.seq_len} tokens at batch {PREDICT_BATCH} in a "
              f"num_gpus=1 task [{smi}]: first result with the env "
              f"{first_s:.3f} s (zip, upload, extract, spawn, CUDA start, "
              f"scoring) vs a plain task's {plain_s:.3f} s (a prestarted "
              f"worker: CUDA start, scoring) and the env's second task "
              f"{second_s:.3f} s; pids {first['pid']} / {second['pid']} / "
              f"plain {plain['pid']}; cwd {first['cwd']}; "
              f"{len(pkg_keys)} package key(s) in the head's KV; NLLs bit "
              f"for bit 8b's (first, second, plain) {bits}; launches a "
              f"batch {first['launches'][0]}; seconds by stage {stages}")
        require(all(bits), f"16a: NLLs equal to 8b's: {bits}")
        require(first["cwd"].startswith(node._rtenv_cache_root),
                f"16a: cwd {first['cwd']} not under the node's env cache "
                f"{node._rtenv_cache_root}")
        require(first["var"] == ENV_VAR_VALUE,
                f"16a: CHIP16_VAR is {first['var']!r}")
        for r in (first, second, plain):
            require(len(r["launches"]) == n_batches and all(
                b == FORWARD_LAUNCHES for b in r["launches"]),
                f"16a: launches a batch {r['launches'][:2]}..., expected "
                f"{FORWARD_LAUNCHES} in each of {n_batches}")
        require(second["pid"] == first["pid"],
                f"16a: the env's second task ran on pid {second['pid']}, "
                f"not the first's {first['pid']}")
        require(len(pkg_keys) == 1, f"16a: package keys {pkg_keys}")
        require(plain["pid"] != first["pid"],
                "16a: a plain task ran in the env's worker")
        out.update(first_s=first_s, second_s=second_s, plain_s=plain_s,
                   stages=stages,
                   launches_per_batch=first["launches"][0],
                   bits_equal_8b=all(bits),
                   direct_get_ms=float(np.median(direct_ms)))

        # 16b: two py_modules versions of one module, at once (the
        # module's version_of, with 16a's working_dir beside each).
        ver = ray_tpu_torch.remote(mod.version_of)
        t0, w0 = time.perf_counter(), time.time()
        got = ray_tpu_torch.get([ver.options(num_gpus=0.5, runtime_env={
            "working_dir": str(wd), "py_modules": [d]}).remote(
                ENV_VERSION_MODULE, ENV_HOLD_S) for d in versions],
            timeout=600)
        b_s = time.perf_counter() - t0
        overlap = max(g["t0"] for g in got) < min(g["t1"] for g in got)
        to_call = [round(g["t0"] - w0, 3) for g in got]
        print(f"16b py_modules, two versions of {ENV_VERSION_MODULE} in two "
              f"num_gpus=0.5 tasks at once [{smi}]: versions "
              f"{[g['version'] for g in got]}, pids "
              f"{[g['pid'] for g in got]}, overlapping {overlap}, "
              f"{b_s:.3f} s for both (each holds its half "
              f"{ENV_HOLD_S} s; submit to the call {to_call} s); launches "
              f"{[g['launches'] for g in got]}")
        require([g["version"] for g in got] == [1, 2],
                f"16b: versions {[g['version'] for g in got]}")
        require(got[0]["pid"] != got[1]["pid"], "16b: one process for both")
        require(overlap, "16b: the two tasks did not run at once")
        require(not any(g["launches"] for g in got),
                f"16b: kernels launched {[g['launches'] for g in got]}")
        out["py_modules"] = {"s": b_s, "pids": [g["pid"] for g in got],
                             "launches": {}}

        # 16c: a remote driver over ray://.
        proxy = ClientProxyServer(cluster.address)
        params_path, tokens_path = root / "params.pkl", root / "tokens.npy"
        with open(params_path, "wb") as f:
            pickle.dump(params, f, protocol=5)
        np.save(tokens_path, tokens)
        result_path = root / "client.json"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, __file__, "--client-driver", proxy.address,
             str(wd), str(params_path), str(tokens_path), str(result_path)],
            capture_output=True, text=True, timeout=ENV_CLIENT_LIMIT_S)
        client_s = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            print(f"16c client: {line}")
        require(proc.returncode == 0,
                f"16c: the client driver exited {proc.returncode}: "
                f"{proc.stderr[-2000:]}")
        res = json.loads(result_path.read_text())
        t_bye = time.perf_counter()
        gone = _wait_until(lambda: res["session_id"] not in proxy.sessions()
                           and cluster.head.rpc_get_actor(
                               res["actor_id"], 0.0)["state"] == "DEAD",
                           10.0)
        nll = np.asarray(res["nll"], dtype=np.float32)
        c_bits = bool(np.array_equal(nll, want))
        print(f"16c ray:// driver in a subprocess [{smi}]: {client_s:.2f} s "
              f"for the process (its imports {res['imports_s']:.3f} s, "
              f"loading the parameters {res['load_s']:.3f} s, connect "
              f"{res['connect_s']:.3f} s, the "
              f"{res['params_bytes'] / 1e6:.0f} MB put of 8a's parameters "
              f"{res['put_s']:.3f} s, the task and the actor "
              f"{res['run_s']:.3f} s); a get of the scored result through "
              f"the proxy {res['get_ms']:.2f} ms vs a direct driver's "
              f"{out['direct_get_ms']:.2f} ms (medians of 5); NLLs bit for "
              f"bit 8b's {c_bits}; actor pid {res['probe']['pid']} on "
              f"{res['probe']['device']}, its CUDA tensor on the client's "
              f"{res['probe']['tensor_device']}; slow task cancelled "
              f"{res['cancelled']}; client CUDA initialised "
              f"{res['cuda_initialized']}, rtorch segment mapped "
              f"{res['maps_store']}; session and actor gone "
              f"{time.perf_counter() - t_bye:.2f} s after the exit {gone}")
        require(c_bits, "16c: NLLs through ray:// differ from 8b's")
        require(len(res["launches"]) == n_batches and all(
            b == FORWARD_LAUNCHES for b in res["launches"]),
            f"16c: launches a batch {res['launches'][:2]}...")
        require(res["cwd"].startswith(node._rtenv_cache_root)
                and res["var"] == ENV_VAR_VALUE,
                f"16c: the task ran in {res['cwd']} with {res['var']!r}")
        require(res["probe"]["tensor_device"] == "cpu"
                and res["probe"]["tensor"] == [0, 1, 2, 3]
                and res["probe"]["var"] == ENV_VAR_VALUE,
                f"16c: the actor's probe {res['probe']}")
        require(res["cancelled"], "16c: the slow task was not cancelled")
        require(not res["cuda_initialized"] and not res["maps_store"],
                f"16c: the client initialised CUDA "
                f"{res['cuda_initialized']}, mapped a segment "
                f"{res['maps_store']}")
        require(gone, f"16c: 10 s after the client's exit the proxy holds "
                f"{proxy.sessions().get(res['session_id'])}")
        out["client"] = {
            "s": client_s, "connect_s": res["connect_s"],
            "put_s": res["put_s"], "run_s": res["run_s"],
            "get_ms": res["get_ms"], "bits_equal_8b": c_bits,
            "launches_per_batch": res["launches"][0]}
    finally:
        if proxy is not None:
            proxy.shutdown()
        ray_tpu_torch.shutdown()
        cluster.shutdown()
        config.reset("worker_pythonpath_exclude")
        sys.path.remove(str(wd))
        sys.modules.pop(ENV_MODULE, None)
        shutil.rmtree(root, ignore_errors=True)
    return out


def client_driver_main(address: str, working_dir: str, params_path: str,
                       tokens_path: str, result_path: str) -> int:
    """``--client-driver``: phase 16c's remote driver. Puts
    ``working_dir`` on its own ``sys.path`` (its script directory),
    connects with ``ray_tpu_torch.init("ray://" + address)``, loads 8a's
    parameters from ``params_path`` and puts them through the proxy,
    submits the module's ``score`` (``num_gpus=1``) with 16a's runtime
    env, creates (once the task is done: the actor keeps the card) a
    ``num_gpus=1`` ``EnvProbe`` actor of the env and calls ``probe`` (a
    CUDA tensor comes back), waits on both, times five gets
    of the scored result, cancels a slow task of the env and drops its
    ref, disconnects, and writes what it saw to ``result_path``: the
    NLLs and launches, the probe, whether the slow task raised
    ``TaskCancelledError``, whether this process initialised CUDA or
    mapped an ``rtorch_*`` segment, its session and actor ids, and the
    seconds of each step."""
    import importlib
    import pickle

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._tree import tree_leaves
    from ray_tpu_torch.scripts.measure import _process_start

    started = time.time() - _process_start()
    sys.path.insert(0, working_dir)
    mod = importlib.import_module(ENV_MODULE)
    env = {"working_dir": working_dir,
           "env_vars": {"CHIP16_VAR": ENV_VAR_VALUE}}
    with open(params_path, "rb") as f:
        params = pickle.load(f)
    tokens = np.load(tokens_path)
    loaded = time.time() - _process_start() - started
    t0 = time.perf_counter()
    ray_tpu_torch.init(address=f"ray://{address}")
    try:
        connect_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pref = ray_tpu_torch.put(params)
        put_s = time.perf_counter() - t0
        params_bytes = sum(a.nbytes for a in tree_leaves(params))
        del params
        t0 = time.perf_counter()
        task = ray_tpu_torch.remote(mod.score).options(
            num_gpus=1, runtime_env=env).remote(pref, tokens, PREDICT_BATCH)
        # The actor keeps its card for life: it is created once the task
        # has given the card back.
        ray_tpu_torch.wait([task], num_returns=1, timeout=ENV_CLIENT_LIMIT_S)
        actor = ray_tpu_torch.remote(mod.EnvProbe).options(
            num_gpus=1, runtime_env=env).remote()
        call = actor.probe.remote()
        ready, rest = ray_tpu_torch.wait([task, call], num_returns=2,
                                         timeout=ENV_CLIENT_LIMIT_S)
        require(not rest, "the task and the actor's call did not finish")
        scored, probe = ray_tpu_torch.get([task, call], timeout=60)
        run_s = time.perf_counter() - t0
        get_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            ray_tpu_torch.get(task, timeout=60)
            get_ms.append((time.perf_counter() - t0) * 1e3)
        slow = ray_tpu_torch.remote(mod.slow).options(
            runtime_env=env).remote(ENV_CLIENT_LIMIT_S)
        ray_tpu_torch.cancel(slow, force=True)
        try:
            ray_tpu_torch.get(slow, timeout=60)
            cancelled = False
        except ray_tpu_torch.TaskCancelledError:
            cancelled = True
        del slow
        torch = sys.modules.get("torch")
        result = {
            "nll": [float(x) for x in scored["nll"]],
            "launches": scored["launches"], "cwd": scored["cwd"],
            "var": scored["var"],
            "probe": {"pid": probe["pid"], "var": probe["var"],
                      "device": probe["device"],
                      "tensor_device": probe["tensor"].device.type,
                      "tensor": probe["tensor"].tolist()},
            "cancelled": cancelled,
            "cuda_initialized": bool(torch is not None
                                     and torch.cuda.is_initialized()),
            "maps_store": _maps_rtorch_segment(),
            "session_id": worker_mod.backend().session_id,
            "actor_id": actor._actor_id,
            "imports_s": started, "load_s": loaded,
            "connect_s": connect_s, "put_s": put_s,
            "params_bytes": params_bytes, "run_s": run_s,
            "get_ms": float(np.median(get_ms))}
        print(f"scored {len(result['nll'])} rows; session "
              f"{result['session_id']}")
    finally:
        ray_tpu_torch.shutdown()
    Path(result_path).write_text(json.dumps(result))
    return 0


# -- phase 17 ------------------------------------------------------------------


def _handle_stream(handle, prompt, t0: float) -> dict:
    """One ``handle.stream`` of SERVE_NEW_TOKENS tokens: its tokens, chunks,
    and the first chunk's and the last's seconds after ``t0`` as this
    process read them."""
    out = {"tokens": [], "chunks": 0, "ttft_s": None}
    for chunk in handle.stream(list(prompt), SERVE_NEW_TOKENS):
        if out["ttft_s"] is None:
            out["ttft_s"] = time.perf_counter() - t0
        out["tokens"].extend(chunk)
        out["chunks"] += 1
    out["latency_s"] = time.perf_counter() - t0
    return out


def _run_lane(fn, prompts) -> dict:
    """Every prompt at once, each on a thread of its own calling ``fn(prompt,
    t0)``; returns the results in prompt order, the wall seconds, and the
    TTFT and latency percentiles in ms."""
    import threading

    import numpy as np

    results: list = [None] * len(prompts)
    errors: list = []

    def one(i):
        try:
            results[i] = fn(prompts[i], t0)
        except BaseException as e:  # noqa: BLE001 -- held by the caller
            errors.append(f"{i}: {e!r}")

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    require(not errors and all(r is not None for r in results),
            f"a stream failed: {errors[:3]}")
    ttft = [r["ttft_s"] * 1e3 for r in results if r["ttft_s"] is not None]
    lat = [r["latency_s"] * 1e3 for r in results]
    n_tok = sum(len(r["tokens"]) for r in results)
    return {"results": results, "wall_s": wall, "tok_s": n_tok / wall,
            "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p99": float(np.percentile(ttft, 99)),
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p99": float(np.percentile(lat, 99))}


def _llm_series(obs, text: str) -> dict:
    """{(family, labels): value} of deployment ``llm``'s serve series in a
    scrape."""
    return {(fam, lab): v
            for fam, series in obs.parse_prometheus(text).items()
            if fam.startswith("ray_tpu_serve_")
            for lab, v in series.items()
            if dict(lab).get("deployment") == "llm"}


def _occupancy(before: dict, after: dict) -> float:
    """Mean active slots over the decode steps between two ``llm_stats``."""
    steps = after["steps"] - before["steps"]
    return (after["occupancy_sum"] - before["occupancy_sum"]) / max(1, steps)


def serve_deploy_phase(torch, cfg, serving, predict, params, smi,
                       async_actor=None):
    """Phase 17: Serve on a ``Cluster`` of one node with the card
    (``num_gpus=1``), its controller, replicas and HTTP proxy worker
    processes.

    17a. ``LLMEngine`` as deployment ``llm`` (phase 7's GPT-2 small engine:
    seed 0, bf16, 32 slots, ring cache 1024, prefill lane 4 x 128;
    ``num_gpus=0.5``, route prefix "/llm"); phase 7's SERVE_REQUESTS
    prompts, SERVE_NEW_TOKENS new tokens each, sent at once through
    ``handle.stream()``, then over HTTP (chunked ndjson) through the
    node's proxy. Held: every request's tokens equal phase 7's greedy
    tokens (``serving``) on both lanes; each lane's mean active slots over
    its decode steps above 1 (so at least 2 at some step); every HTTP
    stream 200, chunked, ending in the done line; the cluster's scrape
    carries each of ``llm``'s serve series once, the series this phase
    moved all under the node's id (this process's registry is also its
    in-process agents', so the scrape holds, unmoved, what earlier
    phases' engines recorded under the engine's default name ``llm``),
    and the replica gauge under one replica label. Printed: tok/s,
    TTFT p50/p99 (the client's first chunk) and latency a request for each
    lane beside phase 7's and 15c's (``async_actor``), and
    ``serve.stats()``'s phases and decode rollup for ``llm``.
    17b. ``measure.GPT2Scorer`` as deployment ``score`` (8a's parameters,
    ``params``, put in the store and read by the replica, which scores
    one warm-up batch in its constructor;
    ``@serve.batch(max_batch_size=8)``, ``num_gpus=0.5``, "/score"): 8b's
    PREDICT_ROWS rows POSTed one a request, SERVE_SCORE_IN_FLIGHT in
    flight. Held: every answer 200 with its id; each NLL within
    SERVE_NLL_TOL of 8b's direct call (``predict``); every formed batch
    launched ``ln_fwd``, ``gelu_fwd`` and ``flash_fwd`` 25, 12 and 12
    times in the replica's worker and nothing else; the federated
    ``ray_tpu_serve_batch_size`` counting PREDICT_ROWS rows over the
    batches the replica formed. Printed: rows/s beside 8b's, the batch
    sizes, the worker's peak device memory.
    17c. a ``ClientProxyServer`` and ``chip_smoke.py
    --serve-client-driver`` in a subprocess streaming
    SERVE_CLIENT_PROMPTS of the prompts at once from ``llm`` through
    ``ray://`` (``ClientBackend.serve_stream``). Held: phase 7's tokens;
    no CUDA context and no store segment in the client. Printed: its TTFT
    beside 17a's handle lane.
    Then ``serve.shutdown()``. Held: within 10 s the head lists no live
    actor of SERVE_ACTORS. Returns the report entry."""
    import gc
    from collections import Counter
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch import serve, state
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.scripts.measure import (SERVE_ENGINES, GPT2Scorer,
                                               http_post_json,
                                               http_stream_tokens,
                                               serve_prompts)
    from ray_tpu_torch.serve import _observability as obs
    from ray_tpu_torch.serve.llm_engine import LLMEngine
    from ray_tpu_torch.util.client import ClientProxyServer

    ref7 = serving["gpt2"]
    prompts = serve_prompts(SERVE_REQUESTS, cfg.vocab_size,
                            SERVE_ENGINES["gpt2"]["max_prompt_len"])
    want_tokens = ref7["tokens_out"]
    rows = predict_tokens(torch, cfg)
    want_nll = np.asarray(predict["nll"], dtype=np.float32)
    gc.collect()
    torch.cuda.empty_cache()
    ray_tpu_torch.shutdown()  # the local runtime of the phases before
    cluster = Cluster()
    proxy = None
    out: dict = {}
    t_phase = time.perf_counter()
    try:
        cluster.add_node(num_gpus=1, store_capacity=STREAM_STORE_BYTES)
        cluster.wait_for_nodes()
        node_id = cluster.nodes[0].node_id
        ray_tpu_torch.init(address=cluster.address, log_to_driver=False)

        # 17a: the engine as a deployment, through the handle and HTTP.
        t0 = time.perf_counter()
        llm = serve.deployment(name="llm", route_prefix="/llm",
                               ray_actor_options={"num_gpus": 0.5})(
                                   LLMEngine)
        handle = serve.run(llm.bind(
            model="gpt2", preset="small", seed=0,
            max_new_tokens=SERVE_NEW_TOKENS, max_new_cap=SERVE_NEW_TOKENS,
            **SERVE_ENGINES["gpt2"]))
        deploy_s = time.perf_counter() - t0
        port = serve.start_http_proxies()[node_id]
        # This process's registry is also its in-process agents': what an
        # engine of an earlier phase recorded here under the engine's
        # default name "llm" (phase 7's in this process, node "local";
        # 11b's and 15c's on the nodes of their clusters) is in the scrape
        # too, and must not move.
        llm_before = _llm_series(obs, obs.metrics_text())
        stats = [ray_tpu_torch.get(handle.llm_stats.remote(), timeout=60)]
        lanes = {"handle": _run_lane(
            lambda p, t: _handle_stream(handle, p, t), prompts)}
        stats.append(ray_tpu_torch.get(handle.llm_stats.remote(),
                                       timeout=60))
        lanes["http"] = _run_lane(lambda p, t: http_stream_tokens(
            port, "/llm", {"tokens": p, "max_tokens": SERVE_NEW_TOKENS}, t),
            prompts)
        stats.append(ray_tpu_torch.get(handle.llm_stats.remote(),
                                       timeout=60))
        occupancy = {lane: _occupancy(stats[i], stats[i + 1])
                     for i, lane in enumerate(("handle", "http"))}
        equal = {lane: [r["tokens"] for r in lanes[lane]["results"]]
                 == want_tokens for lane in lanes}
        def http_fault(r):
            headers = {k.lower(): v for k, v in r["headers"]}
            return (r["status"] != 200 or r["done"] != {"done": True}
                    or headers.get("transfer-encoding") != "chunked")

        http_bad = [(i, {k: r[k] for k in ("status", "done", "headers")})
                    for i, r in enumerate(lanes["http"]["results"])
                    if http_fault(r)]
        want_decode = 2 * SERVE_REQUESTS * SERVE_NEW_TOKENS

        def decode_tokens():
            return obs.decode_stats(obs.parse_prometheus(
                obs.metrics_text()), "llm").get("tokens", 0)

        _wait_until(lambda: decode_tokens() >= want_decode, 10.0)
        text = obs.metrics_text()
        parsed = obs.parse_prometheus(text)
        series = [ln.rsplit(" ", 1)[0] for ln in text.splitlines()
                  if ln.startswith("ray_tpu_serve_")
                  and 'deployment="llm"' in ln]
        families = sorted({ln.split("{")[0] for ln in series})
        moved = {k for k, v in _llm_series(obs, text).items()
                 if llm_before.get(k) != v}
        nodes = {dict(lab).get("node_id") for _, lab in moved}
        replicas = {dict(lab)["replica"] for lab in
                    parsed.get("ray_tpu_serve_replica_ongoing", {})
                    if dict(lab).get("deployment") == "llm"
                    and dict(lab).get("node_id") == node_id}
        st = serve.stats()["deployments"]["llm"]
        c15 = (f"15c's {async_actor['tok_s']:.1f} tok/s, latency p50 "
               f"{async_actor['latency_ms_p50']:.1f} p99 "
               f"{async_actor['latency_ms_p99']:.1f} ms" if async_actor
               else "15c not run in this call")
        for lane, r in lanes.items():
            print(f"17a LLMEngine as a Serve deployment, {lane} lane "
                  f"(GPT-2 small bf16, {SERVE_REQUESTS} requests x "
                  f"{SERVE_NEW_TOKENS} tokens at once, replica num_gpus=0.5) "
                  f"[{smi}]: {r['tok_s']:.1f} tok/s over the run "
                  f"({r['wall_s']:.3f} s); TTFT (the client's first chunk) "
                  f"p50 {r['ttft_ms_p50']:.1f} ms p99 {r['ttft_ms_p99']:.1f} "
                  f"ms; latency a request p50 {r['latency_ms_p50']:.1f} ms "
                  f"p99 {r['latency_ms_p99']:.1f} ms; mean active slots "
                  f"{occupancy[lane]:.2f}; tokens equal phase 7's "
                  f"{equal[lane]} -- phase 7's in-process "
                  f"{ref7['serve_tok_s']:.1f} tok/s, TTFT p50 "
                  f"{ref7['ttft_ms_p50']:.1f} p99 {ref7['ttft_ms_p99']:.1f} "
                  f"ms, latency p50 {ref7['latency_ms_p50']:.1f} p99 "
                  f"{ref7['latency_ms_p99']:.1f} ms; {c15}")
        print(f"17a [{smi}]: deployed in {deploy_s:.2f} s (replica worker, "
              f"CUDA context, engine and its graphs); serve.stats() llm: "
              f"phases {st.get('phases')}, requests {st.get('requests')}, "
              f"decode {st.get('decode')}; the scrape's llm families "
              f"{families}; the series this phase moved on nodes "
              f"{sorted(nodes)} ({len(moved)} of them; earlier phases' "
              f"engines left {len(llm_before)} unmoved); replica labels "
              f"{sorted(replicas)}")
        for lane in lanes:
            require(equal[lane], f"17a: the {lane} lane's tokens differ "
                    f"from phase 7's")
            require(occupancy[lane] > 1.0, f"17a: the {lane} lane's mean "
                    f"active slots {occupancy[lane]:.2f}: no step held 2")
        require(not http_bad, f"17a: {len(http_bad)} HTTP streams answered "
                f"otherwise than 200, chunked, done: {http_bad[:2]}")
        require(decode_tokens() >= want_decode, f"17a: the scrape counts "
                f"{decode_tokens()} decode tokens of {want_decode}")
        require(len(series) == len(set(series)),
                "17a: a serve series of llm appears twice in the scrape")
        require(nodes == {node_id}, f"17a: phase 17 moved llm's series "
                f"on nodes {nodes}, not only the replica's {node_id}")
        require(len(replicas) == 1, f"17a: replica labels {replicas}")
        out["llm"] = {
            "deploy_s": deploy_s, "occupancy": occupancy,
            "tokens_equal_phase7": equal, "families": families,
            **{lane: {k: v for k, v in r.items() if k != "results"}
               for lane, r in lanes.items()},
            "stats": {k: st.get(k) for k in ("phases", "requests",
                                             "decode")}}

        # 17b: the batched scorer, one row a request over HTTP.
        pref = ray_tpu_torch.put(params)
        t0 = time.perf_counter()
        scorer = serve.deployment(
            name="score", route_prefix="/score",
            max_concurrent_queries=SERVE_SCORE_IN_FLIGHT,
            ray_actor_options={"num_gpus": 0.5})(GPT2Scorer)
        shandle = serve.run(scorer.bind(pref))
        score_deploy_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_SCORE_IN_FLIGHT) as ex:
            answers = list(ex.map(
                lambda i: http_post_json(port, "/score", {
                    "id": i, "tokens": rows[i].tolist()}),
                range(len(rows))))
        wall = time.perf_counter() - t1
        sst = ray_tpu_torch.get(shandle.stats.remote(), timeout=60)
        del pref
        bad = [(i, s, b) for i, (s, b) in enumerate(answers)
               if s != 200 or b.get("id") != i]
        nll = np.asarray([b["nll"] if s == 200 else np.nan
                          for s, b in answers], dtype=np.float32)
        err = float(np.max(np.abs(nll - want_nll)))

        def batch_hist():
            return obs.histogram_dist(obs.parse_prometheus(
                obs.metrics_text()), "ray_tpu_serve_batch_size",
                deployment="score") or {}

        _wait_until(lambda: batch_hist().get("sum") == len(rows), 10.0)
        hist = batch_hist()
        sizes = sst["batch_sizes"]
        print(f"17b GPT2Scorer as a Serve deployment (GPT-2 "
              f"{cfg.n_params / 1e6:.0f}M, 8a's parameters, "
              f"@serve.batch(max_batch_size={SERVE_SCORE_BATCH}), "
              f"num_gpus=0.5), {len(rows)} rows x {cfg.seq_len} tokens "
              f"POSTed one a request, {SERVE_SCORE_IN_FLIGHT} in flight "
              f"[{smi}]: {len(rows) / wall:.1f} rows/s ({wall:.3f} s) vs "
              f"8b's {predict['rows_s']:.1f}; deployed in "
              f"{score_deploy_s:.2f} s (the replica's worker, torch, the "
              f"parameters from the store onto the card, one warm-up "
              f"batch); {len(sizes)} batches formed, sizes "
              f"{dict(sorted(Counter(sizes).items()))}; NLL max "
              f"abs diff to 8b's direct call {err:.3e}; launches of the "
              f"first batch {sst['launches'][0] if sst['launches'] else {}};"
              f" the scrape's batch-size histogram: {hist.get('count')} "
              f"batches, {hist.get('sum')} rows; the worker's peak device "
              f"memory {sst['peak_memory_bytes'] / 2**30:.2f} GiB")
        require(not bad, f"17b: {len(bad)} answers not 200 with their id: "
                f"{bad[:2]}")
        require(err <= SERVE_NLL_TOL, f"17b: NLL {err:.3e} from 8b's")
        require(sum(sizes) == len(rows) and max(sizes) <= SERVE_SCORE_BATCH,
                f"17b: batch sizes {sizes}")
        for i, launched in enumerate(sst["launches"]):
            require(launched == FORWARD_LAUNCHES, f"17b: batch {i} "
                    f"launched {launched}, expected {FORWARD_LAUNCHES}")
        require(hist.get("sum") == len(rows)
                and hist.get("count") == len(sizes),
                f"17b: the scrape's batch-size histogram {hist}, the "
                f"replica formed {len(sizes)} batches of {sum(sizes)} rows")
        out["score"] = {
            "deploy_s": score_deploy_s, "wall_s": wall,
            "rows_s": len(rows) / wall, "nll_max_abs_diff": err,
            "batch_sizes": sizes, "batches": len(sizes),
            "launches_per_batch": sst["launches"][0],
            "peak_memory_bytes": sst["peak_memory_bytes"]}

        # 17c: the engine streamed through ray://.
        proxy = ClientProxyServer(cluster.address)
        OUT.mkdir(exist_ok=True)
        prompts_path = OUT / "serve_client_prompts.json"
        result_path = OUT / "serve_client.json"
        prompts_path.write_text(json.dumps(prompts[:SERVE_CLIENT_PROMPTS]))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, __file__, "--serve-client-driver",
             proxy.address, str(prompts_path), str(result_path)],
            capture_output=True, text=True, timeout=SERVE_CLIENT_LIMIT_S)
        client_s = time.perf_counter() - t0
        require(proc.returncode == 0, f"17c: the client driver exited "
                f"{proc.returncode}: {proc.stderr[-2000:]}")
        res = json.loads(result_path.read_text())
        c_equal = res["tokens"] == want_tokens[:SERVE_CLIENT_PROMPTS]
        ttft = np.asarray(res["ttft_s"]) * 1e3
        print(f"17c ray:// driver in a subprocess streaming "
              f"{SERVE_CLIENT_PROMPTS} prompts at once from llm through "
              f"ClientBackend.serve_stream [{smi}]: {client_s:.2f} s for "
              f"the process; TTFT through the proxy p50 "
              f"{np.percentile(ttft, 50):.1f} ms p99 "
              f"{np.percentile(ttft, 99):.1f} ms vs 17a's handle lane p50 "
              f"{lanes['handle']['ttft_ms_p50']:.1f} ms (64 at once); the "
              f"streams' wall {res['wall_s']:.3f} s; tokens equal phase "
              f"7's {c_equal}; client CUDA initialised "
              f"{res['cuda_initialized']}, rtorch segment mapped "
              f"{res['maps_store']}, backend {res['backend']}")
        require(c_equal, "17c: the tokens through ray:// differ from "
                "phase 7's")
        require(res["backend"] == "ClientBackend",
                f"17c: the client ran on {res['backend']}")
        require(not res["cuda_initialized"] and not res["maps_store"],
                f"17c: the client initialised CUDA {res['cuda_initialized']}"
                f", mapped a segment {res['maps_store']}")
        out["client"] = {"s": client_s, "wall_s": res["wall_s"],
                         "ttft_ms_p50": float(np.percentile(ttft, 50)),
                         "ttft_ms_p99": float(np.percentile(ttft, 99)),
                         "tokens_equal_phase7": c_equal}

        # Teardown: nothing of Serve outlives serve.shutdown().
        t0 = time.perf_counter()
        serve.shutdown()

        def live():
            return [(a["class_name"], a["actor_id"][:12])
                    for a in state.list_actors()
                    if a["class_name"] in SERVE_ACTORS
                    and a["state"] != "DEAD"]

        gone = _wait_until(lambda: not live(), 10.0)
        print(f"17 teardown [{smi}]: serve.shutdown() and no live Serve "
              f"actor in {time.perf_counter() - t0:.2f} s ({gone}); phase "
              f"17 {time.perf_counter() - t_phase:.1f} s")
        require(gone, f"17: live after serve.shutdown(): {live()}")
        out["phase_s"] = time.perf_counter() - t_phase
    finally:
        if proxy is not None:
            proxy.shutdown()
        ray_tpu_torch.shutdown()
        cluster.shutdown()
    return out


def serve_client_driver_main(address: str, prompts_path: str,
                             result_path: str) -> int:
    """``--serve-client-driver``: phase 17c's remote driver. Connects with
    ``ray_tpu_torch.init("ray://" + address)``, streams each prompt of
    ``prompts_path`` (a JSON list) from deployment ``llm`` at once, each
    on a thread (``serve.get_deployment_handle("llm").stream``), and
    writes to ``result_path`` the tokens, each stream's first chunk and
    last (seconds after the start), whether this process initialised CUDA
    or mapped an ``rtorch_*`` segment, and its backend's class."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import worker as worker_mod

    prompts = json.loads(Path(prompts_path).read_text())
    ray_tpu_torch.init(address=f"ray://{address}")
    try:
        handle = serve.get_deployment_handle("llm")
        lane = _run_lane(lambda p, t: _handle_stream(handle, p, t), prompts)
        torch = sys.modules.get("torch")
        result = {
            "tokens": [r["tokens"] for r in lane["results"]],
            "ttft_s": [r["ttft_s"] for r in lane["results"]],
            "latency_s": [r["latency_s"] for r in lane["results"]],
            "wall_s": lane["wall_s"],
            "cuda_initialized": bool(torch is not None
                                     and torch.cuda.is_initialized()),
            "maps_store": _maps_rtorch_segment(),
            "backend": type(worker_mod.backend()).__name__}
    finally:
        ray_tpu_torch.shutdown()
    Path(result_path).write_text(json.dumps(result))
    return 0


# -- phase 18: Tune ------------------------------------------------------------

# 18a: ASHA over four learning rates (grid order), 3e-4 among them: at the
# rung of step 2 a trial is stopped when its loss is worse than the best
# loss recorded there before it, and after one AdamW step the smaller
# rates' losses are the worse.
TUNE_ASHA_LRS = (1e-3, 3e-4, 1e-4, 3e-5)
TUNE_ASHA = dict(steps=6, grace_period=2, reduction_factor=2)
# 18b: PBT over 3e-4 and a rate so small that its loss stays near the
# first step's. PBT ranks each trial's latest loss, whatever its step, and
# two trials sharing the card can run steps apart; a curve above 3e-4's
# at every step keeps the small rate the bottom trial, so it exploits
# 3e-4's checkpoint at its first perturbation step after 3e-4's step 2.
TUNE_PBT_LRS = (3e-4, 1e-6)
TUNE_PBT_MUTATIONS = {"lr": [2e-4, 4e-4]}
# 18c: two trials of the trainer, three steps each.
TUNE_TRAINER_LRS = (3e-4, 1e-3)
TUNE_TRAINER_STEPS = 3


def tune_phase(torch, counters, cfg, ref, smi):
    """Phase 18: Tune over GPT-2 small trials (phase 4's config, init and
    batch; ``ref`` is phase 4's GPT-2 flash run). 18a ASHA and 18b PBT
    through ``measure_tune_gpt2`` on the local backend, two
    ``{"GPU": 0.5}`` trials on the card at once; 18c Tune x Train with
    gangs on a ``Cluster`` of one node with the card
    (``measure_tune_trainer_gpt2``). Returns the report entry."""
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.scripts.measure import (measure_tune_gpt2,
                                               measure_tune_trainer_gpt2)

    out = {}
    t_phase = time.perf_counter()
    per_step = ref["launches_per_step"]

    # 18a: ASHA.
    steps = TUNE_ASHA["steps"]
    a = measure_tune_gpt2(cfg, BATCH, lrs=TUNE_ASHA_LRS, scheduler="asha",
                          steps=steps, max_concurrent=2,
                          resources={"GPU": 0.5},
                          grace_period=TUNE_ASHA["grace_period"],
                          reduction_factor=TUNE_ASHA["reduction_factor"])
    out["asha"] = a
    require(not a["errors"], f"tune ASHA: trial errors {a['errors']}")
    for t in a["trials"]:
        print(f"tune ASHA: lr {t['lr']:g}: steps {t['steps']} (started "
              f"{t['steps_started']}), losses "
              f"{[round(x, 4) for x in t['losses']]}, first report "
              f"{t['first_report_s']:.2f} s after its entry, "
              f"{t['ms_step']:.2f} ms/step with two trials on the card "
              f"(phase 4: {ref['ms_step']:.2f}) [{smi}]")
    (t3,) = [t for t in a["trials"] if t["lr"] == 3e-4]
    n3 = len(t3["losses"])
    gaps = [abs(x - y) / abs(y) for x, y in zip(t3["losses"], ref["losses"])]
    require(max(gaps) <= 1e-5, f"tune ASHA: the 3e-4 trial's losses off "
            f"phase 4's first {n3} by {max(gaps):.3e} (rtol 1e-5)")
    stopped = [t["lr"] for t in a["trials"] if t["steps"][-1] < steps]
    require(stopped, "tune ASHA: no trial stopped before max_t")
    require(a["replay"] == a["decisions"], f"tune ASHA: a fresh scheduler "
            f"replayed {a['replay']} on the record, the run decided "
            f"{a['decisions']}")
    started = a["steps_started"]
    for k in PORTED:
        want = per_step[k] * started
        require(a["launches"].get(k, 0) == want, f"tune ASHA: {k} launched "
                f"{a['launches'].get(k, 0)} times over {started} started "
                f"steps, expected {want}")
    full = [t for t in a["trials"] if t["steps"][-1] == steps]
    lowest = min(full, key=lambda t: t["losses"][-1])
    require(a["best"]["lr"] == lowest["lr"]
            and a["best"]["loss"] == lowest["losses"][-1],
            f"tune ASHA: best {a['best']}, the lowest final loss at max_t "
            f"lr {lowest['lr']:g} {lowest['losses'][-1]}")
    dec = sorted(a["decide_ms"])
    print(f"tune ASHA: {len(a['trials'])} trials, max_t {steps}, grace "
          f"{TUNE_ASHA['grace_period']}, rf {TUNE_ASHA['reduction_factor']},"
          f" 2 at once at GPU 0.5: wall {a['wall_s']:.2f} s; stopped before "
          f"max_t: lr {stopped}; best lr {a['best']['lr']:g} loss "
          f"{a['best']['loss']:.4f}; decisions {a['decisions']} (a fresh "
          f"ASHAScheduler replays the same); {started} steps started, each "
          f"kernel launched phase 4's count a step x {started}; process "
          f"peak memory with two trials "
          f"{a['peak_memory_bytes'] / 2**30:.2f} GiB (phase 4, one run: "
          f"{ref['peak_memory_bytes'] / 2**30:.2f} GiB); report to decision"
          f" p50 {dec[len(dec) // 2]:.2f} ms, max {dec[-1]:.2f} ms [{smi}]")

    # 18b: PBT with checkpoints.
    p = measure_tune_gpt2(cfg, BATCH, lrs=TUNE_PBT_LRS, scheduler="pbt",
                          steps=6, max_concurrent=2, resources={"GPU": 0.5},
                          ckpt_every=2, perturbation_interval=2,
                          mutations=TUNE_PBT_MUTATIONS, seed=0)
    out["pbt"] = p
    require(not p["errors"], f"tune PBT: trial errors {p['errors']}")
    require(p["exploits"], "tune PBT: no exploit happened; arrivals "
            + str([(r["result"]["lr"], r["result"]["step"],
                    round(r["result"]["loss"], 4)) for r in p["log"]]))
    require(not p["dirs_left"], "tune PBT: the checkpoints' directory is "
            "still there")
    by_id = {t["trial_id"]: t for t in p["trials"]}
    seen: dict = {}
    restarts, checked = [], 0
    for ex in p["exploits"]:
        t = by_id[ex["trial"]]
        seen[ex["trial"]] = seen.get(ex["trial"], 0) + 1
        # Each exploit starts the trial's next attempt; one that starts
        # from a checkpoint of the last step runs no step and reports
        # nothing (it can only be the trial's last).
        if seen[ex["trial"]] >= len(t["attempt_losses"]):
            print(f"tune PBT: trial {ex['trial']} exploited at step "
                  f"{ex['step']} from {ex['checkpoint']['sharded']}: its "
                  f"next attempt started at the last step and ran none")
            continue
        att = t["attempt_losses"][seen[ex["trial"]]]
        nxt = next((r for r in p["log"] if r["trial"] == ex["trial"]
                    and r["wall"] > ex["wall"]), None)
        restart = nxt["result"]["wall"] - ex["wall"] if nxt else None
        restarts.append(restart)
        checked += 1
        rec = ex["recomputed"]
        g = [abs(x - y) / abs(y) for x, y in zip(att, rec)]
        print(f"tune PBT: trial {ex['trial']} exploited at step {ex['step']}"
              f" from {ex['checkpoint']['sharded']} at lr "
              f"{ex['config']['lr']:g}: its next attempt's losses "
              f"{[round(x, 5) for x in att[:2]]}, recomputed here from the "
              f"donor's checkpoint {[round(x, 5) for x in rec]} (relative "
              f"gaps {[f'{x:.2e}' for x in g]}); restart (stop to the new "
              f"attempt's first report) "
              f"{'n/a' if restart is None else f'{restart:.2f} s'}")
        require(g and max(g) <= 1e-5, f"tune PBT: the exploiting attempt's "
                f"losses {att[:2]} off the donor's checkpoint's {rec}")
    require(checked, "tune PBT: no exploit's attempt ran a step")
    saves = [x for t in p["trials"] for x in t["save_s"]]
    loads = [x for t in p["trials"] for x in t["load_s"]]
    print(f"tune PBT: {len(p['exploits'])} exploit(s); trials "
          f"{[(t['lr'], t['attempts']) for t in p['trials']]}; checkpoint "
          f"bytes by trial {p['ckpt_bytes']}; save_s "
          f"{[round(x, 3) for x in saves]}; load_s "
          f"{[round(x, 3) for x in loads]}; wall {p['wall_s']:.2f} s; "
          f"checkpoint directory removed [{smi}]")
    out["pbt_restart_s"] = restarts

    # 18c: Tune x Train with gangs on a cluster of one node with the card.
    torch.cuda.empty_cache()
    cluster = Cluster()
    try:
        cluster.add_node(num_cpus=4, num_gpus=1)
        cluster.wait_for_nodes()
        c = measure_tune_trainer_gpt2(cfg, BATCH, cluster.address,
                                      lrs=TUNE_TRAINER_LRS,
                                      steps=TUNE_TRAINER_STEPS)
    finally:
        cluster.shutdown()
    out["trainer"] = c
    trials = sorted(c["trials"], key=lambda t: t["entry"])
    require([t["error"] for t in trials] == [None] * len(TUNE_TRAINER_LRS),
            f"tune x train: trial errors {[t['error'] for t in trials]}")
    require(all(x["end"] <= y["entry"] for x, y in zip(trials, trials[1:])),
            "tune x train: the trials overlapped on the one card")
    calls = TUNE_TRAINER_STEPS + 1  # the steps and step_cost's call
    for t in trials:
        for k in PORTED:
            want = per_step[k] * calls
            require(t["launches"].get(k, 0) == want, f"tune x train: {k} "
                    f"launched {t['launches'].get(k, 0)} times in the "
                    f"trainer's worker, expected {want}")
        print(f"tune x train: lr {t['lr']:g}: losses "
              f"{[round(x, 4) for x in t['losses']]}; trial start to first "
              f"report {t['first_step_wall'] - t['entry']:.2f} s, wall "
              f"{t['end'] - t['entry']:.2f} s; trial pid {t['pid']}, "
              f"trainer worker pid {t['worker_pid']} [{smi}]")
        marks = [("trial process", t["process"]), ("trial entry",
                                                  t["entry"])]
        marks += [(f"worker {k}", v) for k, v in sorted(
            t["worker_startup"].items(), key=lambda kv: kv[1] or 0) if v]
        marks.append(("first step", t["first_step_wall"]))
        print("tune x train: lr " + f"{t['lr']:g}" + ": seconds from fit's "
              "start: " + ", ".join(f"{k} {v - c['fit_wall']:.2f}"
                                    for k, v in marks if v is not None))
    (c3,) = [t for t in trials if t["lr"] == 3e-4]
    g = [abs(x - y) / abs(y) for x, y in zip(c3["losses"], ref["losses"])]
    require(len(g) == TUNE_TRAINER_STEPS and max(g) <= 2e-3,
            f"tune x train: the 3e-4 trial's losses off phase 4's first "
            f"three by {max(g) if g else None} (rtol 2e-3)")
    require(c["live_pgs"] == [] and c["settle_s"] <= 10.0,
            f"tune x train: live placement groups {c['live_pgs']} "
            f"{c['settle_s']:.2f} s after fit")
    require(c["available"].get("GPU") == 1.0, f"tune x train: available "
            f"{c['available']} after fit")
    print(f"tune x train: 2 gang trials ([{{CPU: 1}}, {{CPU: 1, GPU: 1}}], "
          f"PACK) one after the other on the card, fit {c['wall_s']:.2f} s;"
          f" groups {c['pgs']}, none live {c['settle_s']:.2f} s after fit; "
          f"available {c['available']}")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def tune_main() -> int:
    """``--tune``: phase 18 alone, after phase 4's GPT-2 flash run it is
    held against."""
    import torch

    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import fused_norm as fn
    from ray_tpu_torch.scripts.measure import FUSED_FLAGS, measure_gpt2

    require(torch.cuda.is_available(), "--tune needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    _build.build(list(SOURCES))
    cfg = GPT2Config(**FUSED_FLAGS)
    counters = (fn.KERNEL_INVOCATIONS, fa.KERNEL_INVOCATIONS)
    step = run_step(torch, counters, "GPT-2", measure_gpt2, cfg, BATCH,
                    WARMUP, STEPS, EXPECTED_PER_STEP)
    out = tune_phase(torch, counters, cfg, step, smi)
    print(f"phase 18: {out['phase_s']:.1f} s [{smi}]")
    (OUT / "chip_smoke_tune.json").write_text(
        json.dumps(out, indent=1, default=str))
    return 0


def _to_cuda(torch, tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(torch, v) for k, v in tree.items()}
    return tree.cuda() if isinstance(tree, torch.Tensor) else tree


def _bits_equal(torch, a, b) -> bool:
    """Same dtype, shape and bits (a DTensor by its local shard); a Python
    value (the step) by equality."""
    if not isinstance(a, torch.Tensor):
        return a == b
    if hasattr(a, "to_local"):
        if a.placements != b.placements:
            return False
        a, b = a.to_local(), b.to_local()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def checkpoint_round_trip(torch, mesh, cfg, smi):
    """The sharded GPT-2 state after one step, through ``save_sharded``
    into ``chip_smoke_out/ckpt`` and ``load_sharded`` back onto the same
    mesh: every leaf bit for bit. Returns bytes and seconds."""
    from ray_tpu_torch._tree import tree_leaves
    from ray_tpu_torch.models.gpt2 import gpt2_init, gpt2_loss, gpt2_shardings
    from ray_tpu_torch.train.checkpoint import load_sharded, save_sharded
    from ray_tpu_torch.train.train_step import (make_init_fn, make_train_step,
                                                state_shardings)

    sh = gpt2_shardings(cfg, mesh)
    gen = torch.Generator(device="cuda")
    state = make_init_fn(lambda g: gpt2_init(g, cfg, device="cuda"), sh,
                         mesh)(gen.manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, cfg.seq_len + 1),
                           device="cuda", generator=gen.manual_seed(1))
    state, _ = make_train_step(lambda p, b: gpt2_loss(p, b, cfg), sh, mesh)(
        state, {"tokens": tokens})
    torch.cuda.synchronize()
    path = OUT / "ckpt"
    shutil.rmtree(path, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        save_sharded(state, str(path))
        save_s = time.perf_counter() - t0
        nbytes = sum(p.stat().st_size for p in path.iterdir())
        t0 = time.perf_counter()
        loaded = load_sharded(str(path), state_shardings(sh))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(path, ignore_errors=True)
    pairs = list(zip(tree_leaves(state), tree_leaves(loaded)))
    same = sum(_bits_equal(torch, a, b) for a, b in pairs)
    print(f"mesh of 1: checkpoint of the GPT-2 state after one step "
          f"[{smi}]: {len(pairs)} leaves, {nbytes / 1e9:.3f} GB, save "
          f"{save_s:.2f} s, load {load_s:.2f} s, {same} of {len(pairs)} "
          f"leaves bit for bit")
    require(same == len(pairs) and loaded["step"] == state["step"],
            f"checkpoint round trip: {same} of {len(pairs)} leaves equal, "
            f"step {loaded['step']} vs {state['step']}")
    return {"bytes": nbytes, "save_s": save_s, "load_s": load_s,
            "leaves": len(pairs), "bit_equal": same}


def mesh_phase(torch, counters, unsharded, smi):
    """Phase 5: a one-rank NCCL group and ``build_mesh(MeshConfig(fsdp=-1))``;
    the GPT-2, Llama and MoE (expert-parallel over the one-rank ``ep``
    group) main-path steps through ``measure_*(mesh=...)``, each with every
    kernel counter set to 0 just before it and read just after, held to
    the unsharded runs of phase 4 (``unsharded``: same init and batch);
    then the checkpoint round trip; then 2 NCCL ranks of GPT-2 at fsdp=2
    and of the MoE at ep=2 where there are two cards. Returns the report
    entries."""
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.models.moe import MoEConfig
    from ray_tpu_torch.parallel import distributed
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.scripts.measure import (FUSED_FLAGS, LLAMA_FLAGS,
                                               MOE_FLAGS, measure_gpt2,
                                               measure_llama, measure_moe)

    out = {}
    t0 = time.perf_counter()
    distributed.initialize("chip-smoke", 0, 1)
    try:
        mesh = build_mesh(MeshConfig(fsdp=-1))
        out["setup_s"] = time.perf_counter() - t0
        print(f"mesh of 1: {mesh} over a one-rank nccl group, up in "
              f"{out['setup_s']:.2f} s")
        for key, label, measure, cfg, batch in (
                ("gpt2", "GPT-2", measure_gpt2, GPT2Config(**FUSED_FLAGS),
                 BATCH),
                ("llama", "Llama", measure_llama, LlamaConfig(**LLAMA_FLAGS),
                 L_BATCH),
                ("moe", "MoE", measure_moe,
                 MoEConfig(**MOE_FLAGS, expert_parallel=True), L_BATCH)):
            ref = unsharded[key]
            for c in counters:
                c.clear()
            r = measure(cfg, batch, steps=STEPS, warmup=WARMUP,
                        device="cuda", mesh=mesh)
            r["launches"] = {k: sum(c[k] for c in counters) for k in PORTED}
            gaps = [abs(a - b) / abs(b)
                    for a, b in zip(r["losses"], ref["losses"])]
            r["loss_rel_gaps"] = gaps
            print(f"mesh of 1, {label} {cfg.n_params / 1e6:.0f}M batch "
                  f"{batch} seq {cfg.seq_len} [{smi}]: {r['ms_step']:.2f} "
                  f"ms/step, {r['tok_s']:.1f} tok/s, MFU {r['mfu']:.2f}%, "
                  f"peak memory {r['peak_memory_bytes'] / 2**30:.3f} GiB; "
                  f"unsharded {ref['ms_step']:.2f} ms/step, "
                  f"{ref['tok_s']:.1f} tok/s, peak memory "
                  f"{ref['peak_memory_bytes'] / 2**30:.3f} GiB; losses "
                  f"{[round(x, 4) for x in r['losses']]}, largest relative "
                  f"gap to unsharded {max(gaps):.3e}; launches "
                  f"{r['launches']}")
            require(gaps[0] <= 1e-5, f"mesh {key}: first loss off by "
                    f"{gaps[0]:.3e} (rtol 1e-5)")
            require(max(gaps) <= 1e-4, f"mesh {key}: losses off by "
                    f"{max(gaps):.3e} (rtol 1e-4)")
            require(r["launches"] == ref["launches"],
                    f"mesh {key}: launches {r['launches']} vs unsharded "
                    f"{ref['launches']}")
            require(all(r["launches"][k] > 0 for k in PORTED
                        if ref["launches"][k]),
                    f"mesh {key}: a kernel of the path did not launch")
            out[key] = r
        for key, label, measure, cfg, batch in (
                ("gpt2", "GPT-2", measure_gpt2, GPT2Config(**FUSED_FLAGS),
                 BATCH),
                ("llama", "Llama", measure_llama, LlamaConfig(**LLAMA_FLAGS),
                 L_BATCH)):
            out[f"{key}_ring"] = ring_of_one(
                torch, counters, label, measure,
                dataclasses.replace(cfg, attention_impl="ring"), batch, mesh,
                unsharded[key], smi)
        out["checkpoint"] = checkpoint_round_trip(
            torch, mesh, GPT2Config(**FUSED_FLAGS), smi)
    finally:
        distributed.shutdown()
    out["two_ranks"] = two_rank_phase(torch, out["gpt2"], smi, "gpt2")
    out["two_ranks_moe"] = two_rank_phase(torch, out["moe"], smi, "moe")
    for model, ref in (("gpt2_ring", "gpt2"), ("llama_ring", "llama"),
                       ("llama_ulysses", "llama"), ("gpt2_tp", "gpt2"),
                       ("llama_tp", "llama")):
        out[f"two_ranks_{model}"] = two_rank_phase(
            torch, unsharded[ref], smi, model)
    out["two_ranks_pipeline"] = two_rank_pipeline(torch, smi)
    return out


def ring_of_one(torch, counters, label, measure, cfg, batch, mesh, ref, smi):
    """A main-path step with ``attention_impl="ring"`` over the mesh of 1,
    every kernel counter set to 0 just before and read just after: a ring
    of one is the causal flash call, so the losses and the launches of
    every kernel must be phase 4's (``ref``) exactly."""
    for c in counters:
        c.clear()
    r = measure(cfg, batch, steps=STEPS, warmup=WARMUP, device="cuda",
                mesh=mesh)
    r["launches"] = {k: sum(c[k] for c in counters) for k in PORTED}
    print(f"mesh of 1, {label} with attention_impl='ring' [{smi}]: "
          f"{r['ms_step']:.2f} ms/step, {r['tok_s']:.1f} tok/s, peak memory "
          f"{r['peak_memory_bytes'] / 2**30:.3f} GiB; losses "
          f"{[round(x, 6) for x in r['losses']]}, phase 4's "
          f"{[round(x, 6) for x in ref['losses']]}; launches {r['launches']}")
    require(r["losses"] == ref["losses"], f"ring of one, {label}: losses "
            f"{r['losses']}, phase 4's {ref['losses']}")
    require(r["launches"] == ref["launches"], f"ring of one, {label}: "
            f"launches {r['launches']}, phase 4's {ref['launches']}")
    return r


# The 2-rank runs: (mesh axis over the two ranks, global batch, label).
TWO_RANK_RUNS = {"gpt2": ("fsdp", BATCH, "GPT-2 small"),
                 "moe": ("ep", L_BATCH, "MoE small"),
                 "gpt2_ring": ("sp", BATCH, "GPT-2 small, ring attention"),
                 "llama_ring": ("sp", L_BATCH, "Llama small, ring attention"),
                 "llama_ulysses": ("sp", L_BATCH, "Llama small, Ulysses"),
                 "gpt2_tp": ("tp", BATCH, "GPT-2 small"),
                 "llama_tp": ("tp", L_BATCH, "Llama small")}
# The first loss's tolerance where it is not 1e-4: at tp=2 each
# row-parallel product's partial sums are all-reduced in bf16, one more
# rounding a product than the unsharded step (as XLA all-reduces them).
FIRST_LOSS_RTOL = {"gpt2_tp": 2e-3, "llama_tp": 2e-3}
# Launches a step on each rank of the sp=2 runs: the ring calls each flash
# kernel twice where the flash path calls it once; Ulysses' attention is
# the dense path, as in the JAX package.
TWO_RANK_LAUNCHES = {
    "gpt2_ring": dict(EXPECTED_PER_STEP, flash_fwd=48, flash_dkv=24,
                      flash_dq=24),
    "llama_ring": dict(EXPECTED_LLAMA, flash_fwd=64, flash_dkv=32,
                       flash_dq=32),
    "llama_ulysses": dict(EXPECTED_LLAMA, flash_fwd=0, flash_dkv=0,
                          flash_dq=0),
    # At tp=2 a rank makes the unsharded step's calls on its H/tp heads and
    # its columns of the MLP: the same launches.
    "gpt2_tp": EXPECTED_PER_STEP, "llama_tp": EXPECTED_LLAMA}


def two_rank_phase(torch, one_rank, smi, model):
    """``model`` on 2 NCCL ranks (this script with ``--mesh-rank``), where
    there are two cards: GPT-2 small at fsdp=2, the MoE at ep=2 (each rank
    routes the whole batch and computes its 4 experts), GPT-2 / Llama
    small at sp=2 (each rank the whole batch and its half of the
    positions), or GPT-2 / Llama small at tp=2 (each rank the whole batch,
    its heads, MLP columns and vocabulary rows). The first loss within
    rtol 1e-4 (``FIRST_LOSS_RTOL`` for tp) of ``one_rank`` (the mesh of 1,
    or phase 4's unsharded run for sp and tp), the later ones within the
    bf16 rule (rtol 1e-2); for sp and tp, each rank's launches a step
    (``TWO_RANK_LAUNCHES``). Otherwise one line saying why it did not
    run."""
    axis, batch, label = TWO_RANK_RUNS[model]
    n = torch.cuda.device_count()
    if n < 2:
        print(f"mesh of 2 ({axis}=2, {label}): not run: {n} CUDA device "
              "(needs 2)")
        return {"ran": False, "devices": n}
    from ray_tpu_torch.parallel.distributed import free_port

    result = OUT / f"mesh2_{model}.json"
    for r in range(2):
        result.with_suffix(f".rank{r}.json").unlink(missing_ok=True)
    address = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen([sys.executable, __file__, "--mesh-rank",
                               str(r), "2", address, str(result), model])
             for r in range(2)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    require(rcs == [0, 0], f"mesh of 2 ({model}): ranks exited {rcs}")
    ranks = [json.loads(result.with_suffix(f".rank{r}.json").read_text())
             for r in range(2)]
    r = ranks[0]
    gaps = [abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                one_rank["losses"])]
    against = "phase 4" if axis in ("sp", "tp") else "the mesh of 1"
    first = FIRST_LOSS_RTOL.get(model, 1e-4)
    for i, rank in enumerate(ranks):
        print(f"mesh of 2 ({axis}=2), {label} batch {batch}, rank {i} "
              f"[{rank['smi']}]: {rank['ms_step']:.2f} ms/step, "
              f"{rank['tok_s']:.1f} tok/s, MFU {rank['mfu']:.2f}%, peak "
              f"memory {rank['peak_memory_bytes'] / 2**30:.3f} GiB; "
              f"launches a step {rank['launches_per_step']}")
    print(f"mesh of 2 ({axis}=2), {label}: losses "
          f"{[round(x, 4) for x in r['losses']]}, relative gaps to {against} "
          f"{[f'{g:.2e}' for g in gaps]}")
    require(gaps[0] <= first, f"mesh of 2 ({model}): first loss off by "
            f"{gaps[0]:.3e} (rtol {first})")
    require(max(gaps) <= 1e-2, f"mesh of 2 ({model}): losses off by "
            f"{max(gaps):.3e}")
    if model in TWO_RANK_LAUNCHES:
        for i, rank in enumerate(ranks):
            require(rank["launches_per_step"] == TWO_RANK_LAUNCHES[model],
                    f"mesh of 2 ({model}): rank {i} launches a step "
                    f"{rank['launches_per_step']}, expected "
                    f"{TWO_RANK_LAUNCHES[model]}")
    return {"ran": True, **r, "ranks": ranks, "loss_rel_gaps": gaps}


def mesh_rank_main(rank: int, world: int, address: str, result: str,
                   model: str) -> int:
    """One NCCL rank of ``two_rank_phase``; each rank writes its result,
    with its launches (the counters zeroed just before the run) and its
    card's name and power limit, beside ``result``."""
    import torch

    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.models.moe import MoEConfig
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import fused_norm as fn
    from ray_tpu_torch.parallel import distributed
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.scripts.measure import (FUSED_FLAGS, LLAMA_FLAGS,
                                               MOE_FLAGS, measure_gpt2,
                                               measure_llama, measure_moe)

    runs = {
        "gpt2": (measure_gpt2, GPT2Config(**FUSED_FLAGS), MeshConfig(
            fsdp=world)),
        "moe": (measure_moe, MoEConfig(**MOE_FLAGS, expert_parallel=True),
                MeshConfig(fsdp=1, ep=world)),
        "gpt2_ring": (measure_gpt2, GPT2Config(
            **FUSED_FLAGS, attention_impl="ring"), MeshConfig(fsdp=1,
                                                              sp=world)),
        "llama_ring": (measure_llama, LlamaConfig(
            **LLAMA_FLAGS, attention_impl="ring"), MeshConfig(fsdp=1,
                                                              sp=world)),
        "llama_ulysses": (measure_llama, LlamaConfig(
            **LLAMA_FLAGS, attention_impl="ulysses"), MeshConfig(fsdp=1,
                                                                 sp=world)),
        "gpt2_tp": (measure_gpt2, GPT2Config(**FUSED_FLAGS),
                    MeshConfig(fsdp=1, tp=world)),
        "llama_tp": (measure_llama, LlamaConfig(**LLAMA_FLAGS),
                     MeshConfig(fsdp=1, tp=world)),
    }
    measure, cfg, mesh_cfg = runs[model]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize("chip-smoke-2", rank, world,
                           coordinator_address=address)
    try:
        counters = (fn.KERNEL_INVOCATIONS, fa.KERNEL_INVOCATIONS)
        for c in counters:
            c.clear()
        r = measure(cfg, TWO_RANK_RUNS[model][1], steps=STEPS, warmup=WARMUP,
                    mesh=build_mesh(mesh_cfg))
        n_steps = r["warmup"] + STEPS
        r["launches_per_step"] = {k: sum(c[k] for c in counters) / n_steps
                                  for k in PORTED}
    finally:
        distributed.shutdown()
    r["smi"] = subprocess.run(
        ["nvidia-smi", "-i", str(torch.cuda.current_device()),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    Path(result).with_suffix(f".rank{rank}.json").write_text(json.dumps(r))
    return 0


# -- main ----------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA "
              "device", file=sys.stderr)
        return 1

    # Phase 1: device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    name = torch.cuda.get_device_name(0)

    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_init, gpt2_loss
    from ray_tpu_torch.models.llama import LlamaConfig, llama_init, llama_loss
    from ray_tpu_torch.models.moe import MoEConfig, moe_init, moe_loss
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import fused_norm as fn
    from ray_tpu_torch.ops import ring_attention as ra
    from ray_tpu_torch.ops.attention import dense_causal_attention
    from ray_tpu_torch._device import device_spec
    from ray_tpu_torch.scripts.measure import (FUSED_DENSE_FLAGS, FUSED_FLAGS,
                                               LLAMA_FLAGS, MOE_FLAGS,
                                               measure_gpt2, measure_llama,
                                               measure_moe)

    OUT.mkdir(exist_ok=True)
    report = {"nvidia_smi": smi, "device": name}

    # Phase 2: build.
    t0 = time.perf_counter()
    report["build_s"] = _build.build(list(SOURCES))
    print(f"build: {report['build_s']} s of nvcc, phase "
          f"{time.perf_counter() - t0:.1f} s")
    for lib in SOURCES:
        shutil.copy(_build.library_path(lib).with_suffix(".log"),
                    OUT / f"nvcc_{lib}.log")
    report["ptxas"] = ptxas_report(
        [(OUT / f"nvcc_{lib}.log").read_text() for lib in SOURCES], fa)
    print("ptxas (registers, spill stores/loads B, static + dynamic shared "
          "memory B, notes): " + "; ".join(
              f"{k} {r.get('registers')}, {r.get('spill_stores')}/"
              f"{r.get('spill_loads')}, {r.get('static_smem')} + "
              f"{r.get('dynamic_smem')}, {','.join(r['notes']) or 'none'}"
              for k, r in report["ptxas"].items()))
    spills = [k for k, r in report["ptxas"].items()
              if r.get("spill_stores") or r.get("spill_loads")]
    print(f"ptxas: {len(report['ptxas'])} kernels, spills in "
          f"{', '.join(spills) or 'none'}")

    # Phase 3: each kernel against its plain version.
    clock = PhaseClock(smi)
    report["phase_s"] = clock.seconds
    spec = device_spec(name)
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    warm_clocks()
    failures = []
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        key = str(dtype).split(".")[-1]
        errs, inp = check_kernels(torch, fn, ROWS, D_MODEL, dtype, failures, 0)
        times = time_kernels(torch, fn, inp, spec, flush)
        results[key] = {k: {"max_abs_err": errs[k], **times[k]}
                        for k in NORM_KERNELS}
        del inp
        errs, inp = check_rms(torch, fn, L_ROWS, L_D_MODEL, dtype, failures, 1)
        times = time_rms(torch, fn, inp, spec, flush)
        results[key].update({k: {"max_abs_err": errs[k], **times[k]}
                             for k in RMS_KERNELS})
        del inp
    for rows, d in NORM_ODD_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            check_kernels(torch, fn, rows, d, dtype, failures, rows + d)
            check_rms(torch, fn, rows, d, dtype, failures, rows + d + 1)
    for rows, d in RMS_WARP_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            check_rms(torch, fn, rows, d, dtype, failures, rows + d + 1)
    for rows, d in RMS_UNALIGNED_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            check_rms(torch, fn, rows, d, dtype, failures, rows + d + 2,
                      shift=True)
    for n in GELU_ODD_LENGTHS:
        for dtype in (torch.bfloat16, torch.float32):
            check_gelu(torch, fn, n, dtype, failures, n)
    for rows, d in LN_WARP_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            check_kernels(torch, fn, rows, d, dtype, failures, rows + d)
    errs, inp = check_flash(torch, fa, FLASH_CASES[0], failures, 0)
    times = time_flash(torch, fa, inp, spec, flush)
    results["bfloat16"].update({k: {"max_abs_err": errs[k], **times[k]}
                                for k in FLASH_KERNELS})
    del inp
    errs, inp = check_flash(torch, fa, FLASH_LLAMA_CASE, failures, 7,
                            packed=False)
    times = time_flash(torch, fa, inp, spec, flush)
    report["flash_llama_shape"] = {k: {"max_abs_err": errs[k], **times[k]}
                                   for k in FLASH_KERNELS}
    del inp
    report["flash_odd_shapes"] = [
        {"case": list(case), "max_abs_err": check_flash(
            torch, fa, case, failures, i + 1)[0]}
        for i, case in enumerate(FLASH_CASES[1:])]
    report["attention_crossover"] = time_crossover(
        torch, fa, dense_causal_attention, flush)
    report["kernels"] = results
    gpt2_shape = f"R={ROWS} D={D_MODEL}"
    llama_shape = f"R={L_ROWS} D={L_D_MODEL}"
    for k in PORTED:
        rows = [("", results["bfloat16"][k])]
        if k in FLASH_KERNELS:
            rows.append((" llama", report["flash_llama_shape"][k]))
        for tag, r in rows:
            if k in FLASH_KERNELS:
                shape = (f"B={L_BATCH} T={L_SEQ} H={L_N_HEAD} D=64" if tag else
                         f"B={BATCH} T={SEQ} H={N_HEAD} D=64")
            else:
                shape = llama_shape if k in RMS_KERNELS else gpt2_shape
            per_step = (EXPECTED_LLAMA if k in RMS_KERNELS or tag
                        else EXPECTED_PER_STEP)[k]
            extra = (f"host_us={r['host_us']:.1f} " if k in FLASH_KERNELS
                     else "")
            if "library_dres_ms" in r:
                extra = f"library_dres_ms={r['library_dres_ms']:.4f} "
            print(f"{k}{tag}: kernel_ms={r['ms']:.4f} {extra}"
                  f"plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']:.4f} "
                  f"bound_us={r['bound_ms'] * 1e3:.1f} ({r['bound_by']}) "
                  f"max_abs_err={r['max_abs_err']:.3e} "
                  f"launches_per_step={per_step} [bf16, {shape}]")
    require(not failures, "kernel vs plain: " + "; ".join(failures))
    clock.lap("3")

    # Phase 3b: the ring on the flash kernels, one process.
    counters = (fn.KERNEL_INVOCATIONS, fa.KERNEL_INVOCATIONS)
    report["ring"] = ring_phase(torch, fa, ra, counters, flush, smi)
    clock.lap("3b")

    # Phase 4: the train steps -- GPT-2's main path (flash) first, then
    # GPT-2 with dense attention, then Llama's main path, then the MoE's.
    cfg = GPT2Config(**FUSED_FLAGS)
    step = run_step(torch, counters, "GPT-2", measure_gpt2, cfg, BATCH,
                    WARMUP, STEPS, EXPECTED_PER_STEP)
    report["train_step"] = step
    report["train_step_dense"] = run_step(
        torch, counters, "GPT-2", measure_gpt2, GPT2Config(**FUSED_DENSE_FLAGS),
        BATCH, DENSE_WARMUP, DENSE_STEPS, EXPECTED_DENSE)
    lcfg = LlamaConfig(**LLAMA_FLAGS)
    lstep = run_step(torch, counters, "Llama", measure_llama, lcfg, L_BATCH,
                     WARMUP, STEPS, EXPECTED_LLAMA)
    report["train_step_llama"] = lstep
    mcfg = MoEConfig(**MOE_FLAGS)
    mstep = run_step(torch, counters, "MoE", measure_moe, mcfg, L_BATCH,
                     WARMUP, STEPS, EXPECTED_MOE)
    print(f"MoE: {mcfg.n_active_params / 1e6:.0f}M of "
          f"{mcfg.n_params / 1e6:.0f}M parameters active a token; "
          f"{mcfg.n_experts} experts, top-{mcfg.top_k}, capacity "
          f"{int(mcfg.capacity_factor * L_ROWS / mcfg.n_experts)} tokens an "
          f"expert of {L_ROWS} a step [{smi}]")
    report["train_step_moe"] = mstep
    clock.lap("4")

    # Phase 4b: the trainer, over phase 4's GPT-2 flash run.
    report["trainer"] = trainer_phase(torch, counters, cfg, step, smi)
    clock.lap("4b")

    # Phase 8: the data library -- phase 4b's run fed from a Dataset (8a),
    # then batch inference with its trained parameters (8b).
    report["ingest"], trained = ingest_phase(torch, counters, cfg,
                                             report["trainer"], smi)
    report["batch_predict"] = batch_predict_phase(torch, counters, cfg,
                                                  trained, smi)
    clock.lap("8")

    # Phase 4c: GPT-2's blocks as a 2-stage pipeline in one process.
    report["pipeline"] = pipeline_phase(torch, counters, smi)
    clock.lap("4c")

    # Phase 5: the same steps over a mesh of 1, the sharded checkpoint,
    # and 2 ranks where there are two cards.
    mesh = mesh_phase(torch, counters,
                      {"gpt2": step, "llama": lstep, "moe": mstep}, smi)
    report["mesh"] = mesh
    clock.lap("5")

    # Phase 5b: the trainer's rank in a worker process of a Cluster.
    report["cluster_trainer"] = cluster_trainer_phase(
        torch, cfg, step, report["trainer"], mesh["two_ranks"], smi)
    clock.lap("5b")

    # Phase 9: the trainer through a preemption notice, and the elastic
    # gang (run after 5b; the number keeps the earlier phases' numbers).
    report["drain"] = drain_phase(torch, cfg, step,
                                  report["cluster_trainer"], smi)
    clock.lap("9")

    # Phase 10: the trainer through a head restart, held against phase
    # 5b's run (10a), and phase 8b's scoring through spilled, restored and
    # chunk-pulled objects (10b).
    report["head_ft"] = head_ft_phase(
        torch, cfg, {"losses": report["cluster_trainer"]["losses"],
                     "launches_per_step": step["launches_per_step"]},
        report["cluster_trainer"]["ms_step"], smi)
    report["spill"] = spill_phase(torch, cfg, trained,
                                  report["batch_predict"], smi)
    clock.lap("10")

    # Phase 11: spillback to a peer over the gossiped view (11a), and
    # phase 5b's run observed through the state API and the trace plane
    # (11b), held against phase 5b's run.
    report["spill_to_peer"] = spill_to_peer_phase(torch, cfg, smi)
    report["observe"] = observe_phase(torch, cfg, report["cluster_trainer"],
                                      smi)
    clock.lap("11")

    # Phase 12: the cluster operated -- phase 5b's run read, profiled,
    # scraped, held to SLOs and fault-injected through the state API.
    report["operate"] = operate_phase(torch, cfg, report["cluster_trainer"],
                                      smi)
    clock.lap("12")

    # Phase 6: kernel paths vs the plain path, same weights and batch.
    gen = torch.Generator(device="cuda")
    params = gpt2_init(gen.manual_seed(0), cfg, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (4, cfg.seq_len + 1),
                           device="cuda", generator=gen.manual_seed(2))
    dense = GPT2Config(**FUSED_DENSE_FLAGS)
    report["kernel_vs_plain_path"] = compare_paths(
        torch, gpt2_loss, params, tokens,
        {"flash+fused": cfg, "dense+fused": dense,
         "plain": dataclasses.replace(dense, fused_norm=False)})
    del params
    params = llama_init(gen.manual_seed(0), lcfg, device="cuda")
    tokens = torch.randint(0, lcfg.vocab_size, (2, lcfg.seq_len + 1),
                           device="cuda", generator=gen.manual_seed(2))
    report["kernel_vs_plain_path"].update(compare_paths(
        torch, llama_loss, params, tokens,
        {"llama flash+rms": lcfg,
         "llama dense+rms": dataclasses.replace(lcfg, use_flash=False),
         "plain": dataclasses.replace(lcfg, fused_norm=False,
                                      use_flash=False)}))
    del params
    params = moe_init(gen.manual_seed(0), mcfg, device="cuda")
    report["kernel_vs_plain_path"].update(compare_moe_paths(
        torch, moe_loss, params, tokens, mcfg))
    del params
    clock.lap("6")

    # Phase 7: the serving engines.
    report["serving"] = serve_phase(torch, counters, smi)
    clock.lap("7")

    # Phase 15: streaming returns (15a), the streamed block split (15b),
    # an async actor hosting phase 7's engine (15c), a pushed task error
    # (15d).
    report["streams"] = streams_phase(
        torch, counters, cfg, report["ingest"], report["batch_predict"],
        report["serving"], trained, smi)
    clock.lap("15")

    # Phase 16: runtime envs (16a, 16b) and a remote driver over ray://
    # (16c), on 8a's parameters and 8b's rows.
    report["envs"] = envs_phase(torch, cfg, report["batch_predict"], trained,
                                smi)
    clock.lap("16")

    # Phase 17: Serve on the card -- phase 7's engine as a deployment
    # (17a), 8b's scoring through @serve.batch (17b), ray:// (17c).
    report["serve"] = serve_deploy_phase(
        torch, cfg, report["serving"], report["batch_predict"], trained, smi,
        report["streams"]["async_actor"])
    del trained
    clock.lap("17")

    # Phase 18: Tune -- ASHA (18a) and PBT (18b) over GPT-2 small trials
    # sharing the card on the local backend, and Tune x Train with gangs
    # on a cluster (18c), held against phase 4's GPT-2 flash run.
    report["tune"] = tune_phase(torch, counters, cfg, step, smi)
    clock.lap("18")

    # Phase 13: the kernels line. Each kernel's launches are those of the
    # main path it belongs to (the flash kernels: GPT-2's, with Llama's and
    # the MoE's beside them), and ``launches_mesh`` those of the same path
    # over the mesh of 1.
    kernels = []
    for kname, where, body in TPU_KERNELS:
        bf = results["bfloat16"][kname]
        main = lstep if kname in RMS_KERNELS else step
        entry = {
            "name": kname, "route": "cuda",
            "source": SOURCES["flash_attention" if kname in FLASH_KERNELS
                              else "fused_norm"],
            "replaces": where, "launches": main["launches"][kname],
            "max_abs_err": bf["max_abs_err"], "ms": bf["ms"],
            "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"],
            "bound_by": bf["bound_by"], "library_ms": bf["library_ms"],
            "status": "ported+checked", "body": body,
            "main_path": "llama" if kname in RMS_KERNELS else "gpt2",
            "launches_per_step": main["launches_per_step"][kname],
            "launches_mesh": mesh["llama" if kname in RMS_KERNELS
                                  else "gpt2"]["launches"][kname],
            "launches_trainer": report["trainer"]["launches"][kname],
            "launches_ingest": report["ingest"]["launches"][kname],
            "launches_stream_per_batch": report["streams"]["stream"][
                "launches_per_batch"].get(kname, 0),
            "launches_envs_per_batch": report["envs"][
                "launches_per_batch"].get(kname, 0),
            "launches_envs_client_per_batch": report["envs"]["client"][
                "launches_per_batch"].get(kname, 0),
            "launches_envs_py_modules": report["envs"]["py_modules"][
                "launches"].get(kname, 0),
            "launches_serve_score_per_batch": report["serve"]["score"][
                "launches_per_batch"].get(kname, 0),
            "launches_tune_asha": report["tune"]["asha"]["launches"].get(
                kname, 0),
            "tune_asha_steps_started": report["tune"]["asha"][
                "steps_started"],
            "launches_tune_trainer_worker": [
                t["launches"].get(kname, 0)
                for t in report["tune"]["trainer"]["trials"]],
            "launches_streamed_split_per_call": (
                report["streams"]["split"]["launches"][kname]
                / (WARMUP + STEPS + 1)),
            "launches_batch_predict_per_batch": (
                report["batch_predict"]["launches"][kname]
                / report["batch_predict"]["batches"]),
            "launches_cluster": report["cluster_trainer"]["launches"].get(
                kname, 0),
            "launches_preempt_b": report["drain"]["preempt"]["launches"].get(
                kname, 0),
            "launches_head_ft": report["head_ft"]["launches"].get(kname, 0),
            "launches_spill_to_peer_per_task": (
                report["spill_to_peer"]["launches"].get(kname, 0)
                / OBSERVE_TASKS),
            "launches_observe": report["observe"]["launches"].get(kname, 0),
            "launches_operate_per_call": report["operate"][
                "launches_per_call"][kname],
            "launches_spill_per_batch": (
                report["spill"]["launches"].get(kname, 0)
                / report["spill"]["batches"]),
            "launches_ring_of_one": mesh[("llama" if kname in RMS_KERNELS
                                          else "gpt2") + "_ring"][
                                              "launches"][kname],
            "launches_pipeline_call": {
                style: report["pipeline"][style]["launches"][kname]
                for style in ("1f1b", "gpipe")},
            "dtype": "bfloat16",
        }
        tp2 = mesh["two_ranks_" + ("llama" if kname in RMS_KERNELS
                                   else "gpt2") + "_tp"]
        if tp2["ran"]:
            entry["launches_tp2_per_step_rank"] = [
                r["launches_per_step"][kname] for r in tp2["ranks"]]
        if "library_dres_ms" in bf:
            entry["library_dres_ms"] = bf["library_dres_ms"]
        if kname in FLASH_KERNELS:
            entry["library"] = bf["library"]
            entry["host_us"] = bf["host_us"]
            entry["llama"] = {
                "launches": lstep["launches"][kname],
                "launches_mesh": mesh["llama"]["launches"][kname],
                "launches_per_step": lstep["launches_per_step"][kname],
                **{k: report["flash_llama_shape"][kname][k] for k in
                   ("max_abs_err", "ms", "host_us", "plain_ms", "library_ms",
                    "bound_ms")}}
            entry["ring"] = {
                f"{r['case']} sp={r['sp']}": {
                    "launches": r["launches"][kname], "ms": r["ring_ms"],
                    "flash_over_t_ms": r["flash_over_t_ms"]}
                for r in report["ring"]}
            entry["moe"] = {
                "launches": mstep["launches"][kname],
                "launches_mesh": mesh["moe"]["launches"][kname],
                "launches_per_step": mstep["launches_per_step"][kname]}
        else:
            f32 = results["float32"][kname]
            entry["fp32"] = {k: f32[k] for k in ("max_abs_err", "ms",
                                                 "plain_ms", "library_ms",
                                                 "bound_ms")}
        kernels.append(entry)
    report["kernels_line"] = {"kernels": kernels, "not_ported": []}
    clock.lap("13")
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report["kernels_line"]))

    # Phase 14.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def _ingest_and_predict(torch, flag: str):
    """The runs phases 15 and 16 are held against, for ``--streams`` and
    ``--envs``: phase 4's GPT-2 flash run, phase 4b's trainer (8a's
    reference), 8a (its parameters) and 8b (its NLLs). Returns (smi,
    cfg, counters, ingest, trained, predict)."""
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import fused_norm as fn
    from ray_tpu_torch.scripts.measure import FUSED_FLAGS, measure_gpt2

    require(torch.cuda.is_available(), f"{flag} needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    _build.build(list(SOURCES))
    cfg = GPT2Config(**FUSED_FLAGS)
    counters = (fn.KERNEL_INVOCATIONS, fa.KERNEL_INVOCATIONS)
    step = run_step(torch, counters, "GPT-2", measure_gpt2, cfg, BATCH,
                    WARMUP, STEPS, EXPECTED_PER_STEP)
    trainer = trainer_phase(torch, counters, cfg, step, smi)
    ingest, trained = ingest_phase(torch, counters, cfg, trainer, smi)
    predict = batch_predict_phase(torch, counters, cfg, trained, smi)
    return smi, cfg, counters, ingest, trained, predict


def streams_main() -> int:
    """``--streams``: phase 15 alone, after the runs it is held against
    (``_ingest_and_predict``'s, and phase 7's GPT-2 engine)."""
    import torch

    smi, cfg, counters, ingest, trained, predict = _ingest_and_predict(
        torch, "--streams")
    serving = serve_phase(torch, counters, smi, models=("gpt2",))
    t0 = time.perf_counter()
    out = streams_phase(torch, counters, cfg, ingest, predict, serving,
                        trained, smi)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s [{smi}]")
    (OUT / "chip_smoke_streams.json").write_text(
        json.dumps(out, indent=1, default=str))
    return 0


def envs_main() -> int:
    """``--envs``: phase 16 alone, after the runs it is held against
    (``_ingest_and_predict``'s)."""
    import torch

    smi, cfg, _counters, _ingest, trained, predict = _ingest_and_predict(
        torch, "--envs")
    t0 = time.perf_counter()
    out = envs_phase(torch, cfg, predict, trained, smi)
    print(f"phase 16: {time.perf_counter() - t0:.1f} s [{smi}]")
    (OUT / "chip_smoke_envs.json").write_text(
        json.dumps(out, indent=1, default=str))
    return 0


def serve_main() -> int:
    """``--serve``: phase 17 alone, after the runs it is held against
    (``_ingest_and_predict``'s, and phase 7's GPT-2 engine)."""
    import torch

    smi, cfg, counters, _ingest, trained, predict = _ingest_and_predict(
        torch, "--serve")
    serving = serve_phase(torch, counters, smi, models=("gpt2",))
    t0 = time.perf_counter()
    out = serve_deploy_phase(torch, cfg, serving, predict, trained, smi)
    print(f"phase 17: {time.perf_counter() - t0:.1f} s [{smi}]")
    (OUT / "chip_smoke_serve.json").write_text(
        json.dumps(out, indent=1, default=str))
    return 0


def two_workers_main() -> int:
    """``--two-workers``: phase 5b's two-worker run and what it is held
    against, alone, for a machine with two or more cards: phase 4's GPT-2
    flash run, phase 4b's local trainer run (printed beside), the mesh of
    1 and phase 5's 2 NCCL ranks, then ``cluster_trainer_phase``."""
    import torch

    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import fused_norm as fn
    from ray_tpu_torch.parallel import distributed
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.scripts.measure import (FUSED_FLAGS, measure_gpt2,
                                               measure_trainer_gpt2)

    require(torch.cuda.device_count() >= 2,
            f"--two-workers needs two CUDA devices, found "
            f"{torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    _build.build(list(SOURCES))
    cfg = GPT2Config(**FUSED_FLAGS)
    step = run_step(torch, (fn.KERNEL_INVOCATIONS, fa.KERNEL_INVOCATIONS),
                    "GPT-2", measure_gpt2, cfg, BATCH, WARMUP, STEPS,
                    EXPECTED_PER_STEP)
    local = measure_trainer_gpt2(cfg, BATCH, steps=WARMUP + STEPS,
                                 warmup=WARMUP, device="cuda")
    distributed.initialize("chip-smoke", 0, 1)
    try:
        one = measure_gpt2(cfg, BATCH, steps=STEPS, warmup=WARMUP,
                           device="cuda", mesh=build_mesh(MeshConfig(fsdp=-1)))
    finally:
        distributed.shutdown()
    two = two_rank_phase(torch, one, smi, "gpt2")
    cluster_trainer_phase(torch, cfg, step, local, two, smi)
    return 0


def drain_main() -> int:
    """``--drain``: phase 9 alone (9a; 9b with two or more cards), after
    phase 4's GPT-2 flash run it is held against; phase 5b's ms/step is
    not measured (printed as nan)."""
    import torch

    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import fused_norm as fn
    from ray_tpu_torch.scripts.measure import FUSED_FLAGS, measure_gpt2

    require(torch.cuda.is_available(), "--drain needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    _build.build(list(SOURCES))
    cfg = GPT2Config(**FUSED_FLAGS)
    step = run_step(torch, (fn.KERNEL_INVOCATIONS, fa.KERNEL_INVOCATIONS),
                    "GPT-2", measure_gpt2, cfg, BATCH, WARMUP, STEPS,
                    EXPECTED_PER_STEP)
    out = drain_phase(torch, cfg, step, {"ms_step": float("nan")}, smi)
    (OUT / "chip_smoke_drain.json").write_text(
        json.dumps(out, indent=1, default=str))
    return 0


def head_ft_main(layers: int | None = None,
                 parts: tuple = ("10a", "10b")) -> int:
    """``--head-ft``: phase 10 alone, after what it is held against: phase
    4's GPT-2 flash run (10a's losses and launches; phase 5b's run gives
    phase 4's bits) and phase 8b's scoring (10b's NLL and rows/s), 8b on
    the seed-0 initial parameters (8a does not run). ``layers`` cuts
    GPT-2's depth (the launches a step then come from phase 4's run at
    that depth, one forward's from the depth), ``parts`` the subphases
    run."""
    import torch

    from ray_tpu_torch.models.convert import params_to_numpy
    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_init
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import fused_norm as fn
    from ray_tpu_torch.scripts.measure import FUSED_FLAGS, measure_gpt2

    require(torch.cuda.is_available(), "--head-ft needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    _build.build(list(SOURCES))
    cfg = GPT2Config(**FUSED_FLAGS)
    expected, forward = EXPECTED_PER_STEP, FORWARD_LAUNCHES
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layer=layers)
        expected = {}
        forward = {"ln_fwd": 2 * layers + 1, "gelu_fwd": layers,
                   "flash_fwd": layers}
    counters = (fn.KERNEL_INVOCATIONS, fa.KERNEL_INVOCATIONS)
    step = run_step(torch, counters, "GPT-2", measure_gpt2, cfg, BATCH,
                    WARMUP, STEPS, expected)
    out = {}
    if "10a" in parts:
        out["head_ft"] = head_ft_phase(torch, cfg, step, step["ms_step"], smi)
    if "10b" in parts:
        params = params_to_numpy(gpt2_init(
            torch.Generator(device="cuda").manual_seed(0), cfg,
            device="cuda"))
        predict = batch_predict_phase(torch, counters, cfg, params, smi,
                                      forward=forward)
        out["spill"] = spill_phase(torch, cfg, params, predict, smi,
                                   forward=forward)
    (OUT / "chip_smoke_head_ft.json").write_text(
        json.dumps(out, indent=1, default=str))
    return 0


def observe_main(parts: tuple = ("11a", "11b")) -> int:
    """``--observe``: phase 11 alone. 11a needs nothing before it (its
    reference is 8b's direct call on the seed-0 parameters); 11b's phase
    5b reference is an untraced run on the same cluster. ``parts``: the
    subphases run."""
    import torch

    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.scripts.measure import FUSED_FLAGS

    require(torch.cuda.is_available(), "--observe needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    _build.build(list(SOURCES))
    cfg = GPT2Config(**FUSED_FLAGS)
    out = {}
    if "11a" in parts:
        out["spill_to_peer"] = spill_to_peer_phase(torch, cfg, smi)
    if "11b" in parts:
        out["observe"] = observe_phase(torch, cfg, None, smi)
    (OUT / "chip_smoke_observe.json").write_text(
        json.dumps(out, indent=1, default=str))
    return 0


def operate_main() -> int:
    """``--operate``: phase 12 alone, its phase 5b reference a run on its
    own cluster first."""
    import torch

    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.scripts.measure import FUSED_FLAGS

    require(torch.cuda.is_available(), "--operate needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    _build.build(list(SOURCES))
    out = operate_phase(torch, GPT2Config(**FUSED_FLAGS), None, smi)
    (OUT / "chip_smoke_operate.json").write_text(
        json.dumps(out, indent=1, default=str))
    return 0


def tp_ranks_main() -> int:
    """``--tp-ranks``: phase 5's tp=2 two-rank runs (GPT-2 and Llama)
    alone, after phase 4's GPT-2 and Llama runs they are held against,
    for a machine with two or more cards."""
    return _ranks_main("--tp-ranks", ("gpt2_tp", "llama_tp"))


def pp_ranks_main() -> int:
    """``--pp-ranks``: phase 5's pipeline over two NCCL ranks alone (each
    rank computes the sequential reference it is held against), for a
    machine with two or more cards."""
    import torch

    from ray_tpu_torch.ops import _build

    require(torch.cuda.device_count() >= 2,
            f"--pp-ranks needs two CUDA devices, found "
            f"{torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    OUT.mkdir(exist_ok=True)
    _build.build(list(SOURCES))
    two_rank_pipeline(torch, smi)
    return 0


def sp_ranks_main() -> int:
    """``--sp-ranks``: phase 5's sp=2 two-rank runs (GPT-2 ring, Llama
    ring, Llama Ulysses) alone, after phase 4's GPT-2 and Llama runs they
    are held against, for a machine with two or more cards."""
    return _ranks_main("--sp-ranks",
                       ("gpt2_ring", "llama_ring", "llama_ulysses"))


def _ranks_main(flag: str, models) -> int:
    """Phase 4's GPT-2 and Llama runs, then the two-rank runs of
    ``models`` held against them."""
    import torch

    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import fused_norm as fn
    from ray_tpu_torch.scripts.measure import (FUSED_FLAGS, LLAMA_FLAGS,
                                               measure_gpt2, measure_llama)

    require(torch.cuda.device_count() >= 2,
            f"{flag} needs two CUDA devices, found "
            f"{torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    _build.build(list(SOURCES))
    counters = (fn.KERNEL_INVOCATIONS, fa.KERNEL_INVOCATIONS)
    ref = {"gpt2": run_step(torch, counters, "GPT-2", measure_gpt2,
                            GPT2Config(**FUSED_FLAGS), BATCH, WARMUP, STEPS,
                            EXPECTED_PER_STEP),
           "llama": run_step(torch, counters, "Llama", measure_llama,
                             LlamaConfig(**LLAMA_FLAGS), L_BATCH, WARMUP,
                             STEPS, EXPECTED_LLAMA)}
    for model in models:
        two_rank_phase(torch, ref[model.split("_")[0]], smi, model)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                sys.argv[4], sys.argv[5], sys.argv[6]))
    if sys.argv[1:2] == ["--two-workers"]:
        sys.exit(two_workers_main())
    if sys.argv[1:2] == ["--sp-ranks"]:
        sys.exit(sp_ranks_main())
    if sys.argv[1:2] == ["--drain"]:
        sys.exit(drain_main())
    if sys.argv[1:2] == ["--head-ft"]:
        sys.exit(head_ft_main())
    if sys.argv[1:2] == ["--observe"]:
        sys.exit(observe_main())
    if sys.argv[1:2] == ["--operate"]:
        sys.exit(operate_main())
    if sys.argv[1:2] == ["--envs"]:
        sys.exit(envs_main())
    if sys.argv[1:2] == ["--client-driver"]:
        sys.exit(client_driver_main(*sys.argv[2:7]))
    if sys.argv[1:2] == ["--streams"]:
        sys.exit(streams_main())
    if sys.argv[1:2] == ["--tune"]:
        sys.exit(tune_main())
    if sys.argv[1:2] == ["--serve"]:
        sys.exit(serve_main())
    if sys.argv[1:2] == ["--serve-client-driver"]:
        sys.exit(serve_client_driver_main(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--tp-ranks"]:
        sys.exit(tp_ranks_main())
    if sys.argv[1:2] == ["--pp-ranks"]:
        sys.exit(pp_ranks_main())
    if sys.argv[1:2] == ["--pp-rank"]:
        sys.exit(pp_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4], sys.argv[5]))
    sys.exit(main())
