#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ray_tpu_torch) on one card.

    python3 chip_smoke.py            # runs every phase; needs one CUDA card

Phases, each printing what it finds; any failure exits non-zero:

0. the card's name and power limit; build the CUDA kernels from
   ray_tpu_torch/csrc (timed), with ptxas's registers and spills; the
   six wgmma kernels (the bf16 flash forward, dQ and dK/dV at d 64/128
   and at d 256) must contain HGMMA instructions in the built library's
   SASS (cuobjdump), and the three d-256 ones no spill; the fifteen
   3xTF32 instances (the fp32 forward, dQ and dK/dV at d 16-256) HMMA
   (mma.sync) instructions, and those at d <= 128 no spill.
1. each kernel against its plain PyTorch version on the card: the flash
   forward at the serving shapes, s 2048 and the training shape (b 4,
   s 2048, bf16), the flash backward (dQ and dK/dV) at b 1/4, s
   128/512/2048, causal and not, sk 512 > sq 128 and d 64, both with
   ragged lengths (s 100, s 1000, sq 128 / sk 300) and d 64 in bf16, fp32
   at b 1 x s 4096 causal (G 4: 1,536 adds into one dQ accumulator
   without its restarts), the
   paged kernel at the decode shape and on a 64-page table whose
   contexts land on the split boundaries of its split-K grid, with ctx
   0 exact, out-of-pool ids below ctx read as clamped, and two calls on
   the same inputs equal bit for bit. fp32 (the 3xTF32 forward, dQ and
   dK/dV) at atol 1e-4 (the backward also rtol 1e-4: dK sums up to sk*G
   products an element), bf16 (the wgmma kernels) at atol/rtol 2e-2
   against the plain version in fp32 on the same bf16 inputs; every bf16
   forward, dQ and dK/dV launch must take the wgmma route, every fp32
   forward, dQ and dK/dV the 3xTF32 one. Times of each kernel, its plain
   version and one PyTorch call computing the same function
   (scaled_dot_product_attention, its backward for the dQ/dK/dV pair),
   with the least time the card could take (for fp32 work, the 3xTF32
   floor at 495 / 3 TFLOP/s, the 67 TFLOP/s SIMT bound printed beside
   it). The backward is timed at the training shape, the paged wrapper
   (its split and merge launches) at the decode shape; the fp32 kernels
   at d 128 at the same shapes, and the fp32 dQ and dK/dV pair against
   SDPA's fp32 backward.
   Phase 1 also holds the paged kernel at the published shapes that
   Qwen2 and Gemma give it (G 7 under the row maximum 8 at hd 128 and
   64, G 1 and G 8 at hd 256; fp32 and bf16; the old contexts and a 64-page
   table; timed at the decode shape), the flash forward, dQ and dK/dV at
   head dim 256 (16/16 heads; every bf16 launch on the wgmma route, every
   fp32 launch on the 3xTF32 route; timed at b 8 x s 512
   and, the backward, b 2 x s 2048), the head dims 16 and 32 of the tiny
   presets (the flash kernels, fp32 and bf16, and the paged kernel under
   every row maximum; the scalar bf16 forward, dQ and dK/dV timed at b 4
   x s 128, head dim 16, beside their plain versions, SDPA and their
   bounds), and the 3xTF32 kernels at d 16, 32, 64, 128 and 256 by GQA
   groups 1, 4, 7 and 8, causal and not.
2. fp32, 2 layers, at full Llama-3-8B, Qwen2-7B and Gemma-7B width: the
   dense engine (flash prefill) and the paged engine (paged decode) give
   identical greedy transcripts, which agree with a cache-free forward
   pass through the reference attention.
3. bf16 Llama-3-8B, all 32 layers, one shared set of random weights:
   the dense engine, then the paged engine (with a prefix-cache hit),
   each answer 8 requests with 32 tokens; the launch counters show
   their kernels ran, every flash launch on the wgmma route; TTFT and
   ITL medians. The dense engine then answers a 700-token prompt
   through its overflow bucket (1023, a ragged flash length).
4. fp32, 2 layers, batch 2 x seq 256, at full Llama-3-8B width and then
   full Gemma-7B width (head dim 256): the loss and
   every gradient leaf through the flash kernels match the reference
   attention's (max |dg| <= 1e-4 max |g| per leaf), and full remat
   matches no remat.
5. training: the run of ``ray_tpu_torch.tools.profile_train`` (Llama-3-8B
   width, 8 layers, fp32 params, bf16 compute, full remat, batch 4 x seq
   2048), 5 AdamW steps on one batch of random tokens; the loss is
   finite and falls, the launch counters show the
   forward (twice under remat) and both backward kernels ran on every
   layer of every step, all three on the wgmma route; step
   time, tokens/s, MFU, peak memory.
6. Qwen2-7B and Gemma-7B at full width (configs from
   ``llama_config_from_hf`` on their published config.json values, bf16
   random weights from seed 0, 28 layers each) through the dense and
   then the paged engine with phase 3's requests: the flash forward
   launches once a layer a prefill batch, on the wgmma route (head dim
   128 and 256), the paged kernel once a layer a decode step; TTFT and
   ITL medians.
7. training GPT-2 125M whole (batch 8 x 1024), Mixtral-8x7B width cut
   to 2 layers (batch 4 x 2048) and Gemma-7B width cut to 4 layers
   (batch 2 x 2048), 5 AdamW steps each: losses fall, every layer's
   forward, dQ and dK/dV run on their routes (all wgmma, Gemma's at head
   dim 256 too); step time, tokens/s, MFU, peak memory.
8. the tiny presets on the card (head dim 16): ``LLMEngine()`` and
   ``PagedLLMEngine()`` with their defaults (Llama tiny, fp32) answer
   prompts that pad to the 128 bucket with the same greedy transcripts,
   which agree with a cache-free forward; ``loss_fn`` and its backward
   on the Llama, GPT-2 and Mixtral tiny presets through the kernels
   match the reference attention's gradients (1e-4 of each leaf's max).
   The counters show the d-16 flash and hd-16 paged kernels ran.
9. disaggregated prefill/decode and the decode API. (a) fp32, 2 layers
   at Llama-3-8B width, phase 3's requests: ``DisaggPagedEngine`` (2
   prefill workers, divert floor 128, a 60 s handoff lease) gives the
   ``PagedLLMEngine``'s greedy tokens with every prompt of 128 tokens
   or more diverted and handed off, no page leaked, and again under a
   dropped handoff and a killed worker (0.5 s lease; recovered, both
   workers alive after). (b) bf16
   Llama-3-8B, 32 layers, phase 3's weights and requests: the paged
   engine, then the disaggregated one with its workers on streams of
   their own; TTFT and ITL p50/p99 of each, the paged kernel's
   launches, the staging pool's size; how many transcripts agree
   (printed, not required in bf16). (c) ``prefill`` of one 512-token
   prompt launches the flash forward once a layer and matches
   ``prefill_batch`` (bf16 atol/rtol 2e-2); ``insert_sequence`` writes
   a dense-cache slot exactly; ``init_shapes`` has ``init_params``'s
   shapes and dtypes.
10. the RL learners (PPO, IMPALA, APPO on the conv module at Catch's 10
   x 10 x 1; DQN, CQL on the Q MLP and BC, MARWIL on the MLP at
   CartPole's 4 / 2; SAC at Pendulum's 3 / 1; DreamerV3 at CartPole's 4 /
   2 with the reference's defaults, batch 8 x 16), each built on the card
   and on the CPU from the same parameters and given the same 3 batches
   (PPO the same permutations, SAC and DreamerV3 the same noise): the first
   gradients agree at atol 1e-5 / rtol 1e-4 and the parameters after
   the 3 updates within 0.2 lr an optimizer step; the losses of each
   update at rtol 1e-4 against a CPU learner that starts that update
   from the card learner's state (``rl_phase`` says why); ms per
   update on the card (median of 10).
11. the parallel layer (``ray_tpu_torch.parallel``, the models' mesh
   surface) at world size 1 over NCCL: one card cannot hold two ranks of
   one communicator, so multi-rank numerics are held on the CPU by the
   gloo tests. Phase 5's Llama-3-8B width, 8 layers, 4 x 2048 (fp32
   params, bf16 compute, full remat): ``loss_fn(mesh={fsdp 1, sp 1, tp
   1})`` with Ulysses (the wgmma flash forward, dQ and dK/dV on the local
   heads, launches counted) and with ring attention (plain ops, no
   launch), ``loss_fn_pp`` at pp 1 with 4 microbatches; Mixtral-8x7B
   width, 2 layers, under {dp 1, ep 1}. Each loss and every gathered
   gradient leaf are held to the mesh-free run on the same weights and
   attention math (the flash kernels; ring's fp32 math to the reference
   attention) at bf16 atol/rtol 2e-2 (atol scaled by the leaf's largest
   value); ms a
   step (loss and backward) of each beside the mesh-free step. The phase
   destroys its process group.
12. tensor-parallel serving at world size 1 over NCCL (multi-rank serving
   is held on the CPU by ``tests/test_torch_tp_serve.py``): phase 3's
   Llama-3-8B bf16 weights and requests through both engines with
   ``mesh={tp 1}`` give phase 3's greedy tokens request by request with
   the same flash (wgmma) and paged launches; TTFT and ITL p50/p99 beside
   phase 3's; the engine's peak memory on top of the weights stays below
   a second copy of them; ``LLMEngine(tp=2)`` on one card raises the
   reference's ValueError.
13. sharded checkpoints, the predictor, and disaggregated serving and
   page export/import under ``mesh=``. (a) Phase 5's run (rebuilt from
   ``profile_train``, cut to ``CKPT_LAYERS`` = 1 layer to keep the
   whole script inside its time limit) after its 5 AdamW steps: params
   and AdamW state
   through ``train.dist_checkpoint.save`` into the temporary directory
   (its free space printed first; the params alone if it cannot hold
   both), freed, restored into fresh tensors on the card: every leaf's
   checksum (the sum of its bytes as integers) and the step-6 loss
   equal those from before the save, bit for bit; save and restore
   seconds and GB/s. (b) ``TorchPredictor.from_checkpoint`` over the
   same checkpoint, ``llama.forward`` on 8 x 512 tokens: the argmax
   equals the in-memory forward's, the flash forward launches once a
   layer on the wgmma route; the predict time. (c) at world size 1 over
   NCCL, phase 9's disaggregated engine (2 workers) with ``mesh={tp
   1}``: fp32 at 2 layers gives phase 9(a)'s paged tokens for 8/8
   requests; bf16 at 32 layers on phase 3's weights and requests hands
   off every prompt of 128 tokens or more, leaks no page, and prints
   TTFT and ITL p50/p99 beside 9(b)'s and how many transcripts equal
   9(b)'s (bf16 disaggregated transcripts differ between runs: the two
   workers race for q7, whose worker may hold q1's pages in its staging
   cache), and for each that differs the token where it parts and the
   decode chunk that produced it in both runs (``serve_latency.py``'s
   chunk log); q1's pages exported from one ``mesh={tp 1}`` paged engine
   and imported into another, where q7 hits them (128 tokens) and
   decodes the exporter's q7 tokens.
14. the port's own runtime (``ray_tpu_torch.init``) on the card. (a)
   the node reports the card as ``{"GPU": 1}``; a CPU task sees
   ``CUDA_VISIBLE_DEVICES=""`` and no CUDA; two one-GPU bundles stay
   pending and a two-GPU bundle can never fit; ``num_gpus`` on a task
   raises the actor-scoped ValueError. (b) a 1 GiB bf16 CPU tensor
   through ``put``/``get`` bit for bit, the ``get`` a view into the shm
   store; a CUDA tensor arrives as a CPU tensor with its bits; GB/s. (c)
   an actor with ``num_gpus=1`` (its worker's ``CUDA_VISIBLE_DEVICES``
   one id) builds phase 3's bf16 Llama-3-8B weights (seed 0) on its card
   and serves phase 3's requests through the dense and then the paged
   engine, driven through actor calls (submit per request, polls of
   ``collect``; the replica holds a wave until a ``flush`` call hands
   it to the engine at once, as phase 3 submits it): phase 3's tokens for
   8/8 requests in each engine and phase 3's launches, the flash forward
   once a layer a prefill batch, all wgmma, and the paged kernel once a
   layer a decode step, merges equal to splits; the kernel library
   loaded, not rebuilt; the actor's time to become ready, the actor-call
   round trip, TTFT and ITL beside phase 3's. (d) after ``shutdown()`` the
   card's free memory is back within 1 GiB of its reading before (a).
15. the Train gang on the card (``ray_tpu_torch.train``, the runtime
   started afresh). (a) ``TorchTrainer`` with one ``use_gpu`` worker and
   ``TorchConfig(distributed=True)`` (NCCL at world size 1) trains phase
   5's run for 3 AdamW steps through ``tools/train_gang.py``'s
   ``gang_loop``, every gradient averaged over the group: phase 5's first
   three losses at rtol 2e-2 (the largest difference and bit equality
   printed), 48 forward and 24 dQ and dK/dV launches in the worker, all
   wgmma, its ``CUDA_VISIBLE_DEVICES`` one id, the kernel library loaded
   and not rebuilt; step time beside phase 5's; the card's free memory
   printed first. (b) a restart drill at phase 7's GPT-2 125M (8 x 1024):
   a checkpoint (params and AdamW state through ``dist_checkpoint``)
   reported after each step, the first worker exits after step 1,
   ``FailureConfig(max_failures=1)``: the restarted gang is a new process
   on the same card, resumes at step 2, and steps 0-3 give phase 7's
   losses at rtol 2e-2; the GPU is free after ``fit()``. (c) two one-GPU
   workers on the one card raise PlacementGroupError naming the GPU
   bundle within a 5 s ``train_pg_ready_timeout_s``;
   ``TorchConfig(device=None)`` without ``use_gpu`` raises ValueError.
   (d) after ``shutdown()`` the card's free memory is back within 1 GiB.
16. Data on the card (``ray_tpu_torch.data``, the runtime started afresh
   with a 3 GiB store). (a) The device feed alone: 1 GiB of float32 rows
   (2048 x [128, 1024], seed 0) from ``from_numpy`` through
   ``iter_torch_batches()`` in 32 MiB batches, each staged batch equal to
   its host batch bit for bit; the feed's GB/s beside a bare pinned and a
   pageable ``copy_`` of 32 MiB; a pass with a bf16 GEMM of about one
   batch's feed time per batch against the sum of the two alone; a
   ``break`` after two batches gives back the prefetch thread, the pinned
   ring and the card memory. (b) Phase 15(a)'s one-worker NCCL gang with
   ``datasets={"train": ds}`` (phase 5's token rows three times): 3 steps
   from ``get_dataset_shard("train").iter_torch_batches(batch_size=4)``
   whose losses equal phase 5's first three bit for bit, 48 forward and
   24 dQ and dK/dV launches, all wgmma; step time beside 15(a)'s. (c)
   ``predict_batches`` of ``TorchPredictor`` at Llama-3-8B full width
   (bf16, 32 layers, phase 3's seed-0 weights drawn on the actor's card)
   on a ``num_gpus=1`` actor pool over 8 rows of 512 tokens: the argmax
   equals ``TorchPredictor.predict`` in the driver, 32 wgmma forward
   launches in the actor; ms a batch, the actor's ready time. (d)
   ``train_offline`` of BC on the card from a JSON sample-batch file
   gives the losses of direct updates on the same batches. The card's
   free memory is back after ``shutdown()``.
17. the serving plane (``ray_tpu_torch.serve``) and compiled DAGs on the
   card, the runtime started afresh. (a) ``serve.run`` of the paged
   engine (``engine=True``, ``num_gpus=1``) at Llama-3-8B bf16, 32
   layers, phase 3's seed-0 weights drawn on the replica's card: phase
   3's 8 requests through ``handle.remote``, then one prompt again
   unary, through ``handle.stream`` and through the HTTP proxy (unary
   and SSE), whose tokens must all be equal; in the replica the paged
   kernel once a layer a decode step, merges equal to splits, every
   flash launch wgmma, no page leaked, the shared prefix hit, the kernel
   library loaded and not rebuilt; TTFT and ITL p50/p99 beside phases 3
   and 14, and how many transcripts equal phase 3's (printed only:
   requests one router call apart batch differently). (b) the dense
   engine at fp32, Llama-3-8B width, 2 layers, from a ``num_gpus=1``
   replica: the router's tokens equal 9(a)'s paged tokens for 8/8
   requests, every prefill flash launch (two a batch) on the 3xTF32
   route. (e) that deployment with ``serve_request_replay`` on: its
   replica is SIGKILLed after a stream's first chunk, the controller
   starts another on the freed card and the router resumes the stream,
   whose spliced tokens equal an unkilled run's; the time to recover.
   (c) one ``num_gpus=1`` actor with two bound methods compiled with
   ``device="auto"``: the K and V of one 8B request (2 x [32, 8, 512,
   128] bf16, 64 MiB) cross a ``DeviceChannel`` as the same CUDA
   tensors (``data_ptr``) with their values; with ``device="off"`` they
   ride shm and arrive as CPU tensors with equal bits; us a hop of each,
   GB/s of the shm hop, and a small value's round trip through
   ``dag.execute`` beside an actor call. (d) ``LLMPipeline`` (DAG mode)
   at Llama-3-8B bf16 with its generate stage on a ``num_gpus=1`` actor:
   each reply equals the same stage run in the driver on the same seed-0
   weights, token for token, and the stage launches the wgmma flash
   forward once a layer a request; ms a request. (f) after
   ``serve.shutdown()`` and ``shutdown()`` the card's free memory is back
   within 1 GiB. The phase prints its seconds.
18. Data's readers and Tune on the card, the runtime started afresh
   with a 1 GiB store. (a) phase 7's GPT-2 tokens (8 x 1025, numpy seed
   0) as int64 byte records through ``Dataset.write_tfrecords``, a tar of
   ``.tokens`` members, a sqlite table of (step, row, blob) and a
   deflate Avro file written by a small encoder here, each read back
   through ``read_tfrecords`` / ``read_webdataset`` / ``read_sql`` /
   ``read_avro`` and ``map_batches`` equal to the source bit for bit;
   the MB/s of a 256 MiB ``read_tfrecords`` pass (printed only). This
   machine has neither pyarrow, PIL nor pandas: the image, HuggingFace,
   Delta, Iceberg and BigQuery readers run in the CPU tests. (b) a
   ``Tuner`` sweep of GPT-2 125M (params from seed 0, AdamW(lr, weight
   decay 0.01)) over lr 3e-4, 1e-3, 1e-1 under ASHA (max_t 8, grace 2,
   reduction 2), one ``num_gpus=1`` trial actor at a time, each
   step's 8 rows read by ``read_tfrecords(...).iter_torch_batches()`` on
   the trial's card from a file whose steps 0-4 are phase 7's batch and
   5-7 rows of numpy seed 1: the lr 3e-4 trial's first five losses equal
   phase 7's bit for bit, ASHA stops a trial before max_t, every trial
   ends, the trials' launches are the d-64 wgmma kernels' (2 x 12
   forward, 12 dQ, 12 dK/dV a step); each trial's losses, the rung it
   stopped at, its actor's ready time and step time. (c) the lr 3e-4
   trial with ``max_failures=1``: params and AdamW state saved through
   ``dist_checkpoint`` and reported at step 3, its actor ends with
   ``os._exit(1)``, and the retry's steps 4-7, resumed from
   ``tune.get_checkpoint()``, equal (b)'s losses bit for bit. (d) a
   ``Tuner`` over a ``TorchTrainer`` (one ``use_gpu`` worker, NCCL) with
   ``datasets={"train": ds}``, one trial at lr 3e-4: its step-4 loss
   equals (b)'s. The card's free memory is back after
   ``shutdown()``; the phase prints its seconds.
19. the RLlib drivers on the card (``ray_tpu_torch.rllib``, the runtime
   started afresh with a 256 MiB store): learners on the card through
   ``learners(device=None)``, EnvRunners plain CPU actors. (a) an
   ``EnvRunner`` (the conv module on Catch) and an ``OffPolicyRunner`` of
   each kind (DQN on CartPole, SAC on Pendulum) given a card learner's
   weights return the batches and ``evaluate`` returns that the same
   runner code computes in this process from the same seed, bit for bit;
   the runner's worker sees ``CUDA_VISIBLE_DEVICES=""`` and no card. (b)
   ``tests/test_rllib.py::test_ppo_cnn_learns_pixel_catch``'s program (2
   runners x 16 envs x 64 steps, lr 1e-3, seed 0): an
   ``episode_return_mean`` of 0.6 within 40 iterations, the learner's
   module the port's ``CNNModule`` on the card, each of the first 3
   updates' losses at rtol 1e-4 of a CPU learner started from the card
   learner's state on the same batch and permutations; after ``stop()``
   a runner call raises ``ActorDiedError``. (c)
   ``test_impala_cnn_learns_pixel_catch``'s program: 0.5 within 60
   iterations, one sample in flight a runner after every ``train()``.
   (d) APPO on Catch, DQN (uniform, then prioritized) on CartPole and SAC
   on Pendulum, 3 iterations past ``learning_starts``: finite losses, the
   learners' parameters on the card, the priorities moved by the TD
   errors. (e) ``MultiAgentPPO`` on Coordination-v0, two policies, one
   trained: the frozen one's weights equal bit for bit after 3
   iterations, the trained one's moved. (f) DreamerV3 on CartPole (8
   envs, ``learning_starts`` 256, 3 iterations of 32 steps): every
   ``act`` and update on the card, finite metrics. Each iteration's ms
   and its split (the weights' host copy, the updates, sampling and the
   rest), env steps/s; DreamerV3's ms an ``act`` and an update. No
   attention kernel launches; the card's free memory is back after
   ``shutdown()``; the phase prints its seconds.
20. cluster mode on the card's host (``ray_tpu_torch.core.cluster``): a
   GCS and two node servers, node A with CPUs only and node B given the
   card (``Cluster.add_node(gpus=1)``), stores of 2.25 GiB. (a) a driver
   connects with ``init(address=...)``: ``GPU`` 1.0 cluster-wide and on
   node B alone, a CPU task on each node sees ``CUDA_VISIBLE_DEVICES=""``,
   the GCS and node servers map no torch or CUDA library. (b) a named
   ``num_gpus=1`` actor lands on node B, builds phase 3's bf16 Llama-3-8B
   (32 layers, seed 0) on its card, loads phase 3's prompts from an
   object a task on node A put (a cross-node fetch) and serves them
   through the dense and then the paged engine: phase 3's tokens 8 of 8
   and launches; TTFT and ITL beside phase 14's. (c) the actor puts a 1
   GiB bf16 tensor made on its card; the driver gets it through its home
   node A's chunked pull, a view into node A's store, and a task on node
   A reads it: both bit for bit (sha256); the pull's GB/s beside 14(b)'s
   put. (e) a subprocess through ``init("ray://...")`` and a
   ``ClientProxyServer`` gets the named actor and receives phase 3's
   paged tokens for the first wave (q0 among them). (d) node A is
   SIGKILLed while a task with lineage runs there: its object is rebuilt
   on node B and the actor keeps answering; node B is SIGKILLed: a call
   raises ``ActorDiedError`` and the card's free memory is back within 1
   GiB within 30 s. (f) ``tests/test_rllib.py::test_policy_server_
   external_client_process``'s program: a CPU client process drives
   CartPole over ``PolicyClient``, an ``ImpalaLearner`` on the card
   consumes the batches and pushes its weights, and the return rises
   past the test's bar. The phase prints its seconds.
21. cluster mode above the substrate: a fresh ``Cluster``, node A the
   head (``add_node(head=True)``: the job agent) with CPUs only, node B
   given the card. (a) ``ray_tpu_torch.state``: two ALIVE nodes, ``GPU``
   1.0 cluster-wide, workers of both nodes in its lists and the summary.
   (b) Llama-3-8B bf16 (32 layers, seed 0) served by a
   ``PipelineDeployment`` of ``LLMPipeline``'s three stages, tokenize and
   detokenize on node A, generate on node B's card: both cross-node
   edges socket channels, 17(d)'s replies to 17(d)'s prompt, the
   generate stage's flash launches one a layer a request; ms a request
   beside 17(d)'s, and a small value's round trip over socket edges
   beside 17(c)'s shm edge. (c) a one-worker NCCL gang on node B, driven
   from node A, meets in rank 0's ``TCPStore`` and takes phase 15's
   GPT-2 steps (losses within 2e-2 of phase 7's, the flash forward, dQ
   and dK/dV launched); a two-worker gloo gang ``SPREAD`` over both
   nodes: its ``torch`` backend's sums equal the ``host`` backend's. (d)
   a job through ``JobSubmissionClient`` to node A's agent starts a
   ``num_gpus=1`` actor on node B, which prints the digest of a seeded
   GEMM on the card: the job SUCCEEDED with the driver's digest in its
   logs. The phase prints its seconds.

Phases 2, 4, 8 and 9(a) (fp32) check that every flash forward, dQ and
dK/dV launch took the 3xTF32 kernels.

The second line from the end is the kernel table as JSON, one row per
kernel and instance route (launches of the serving kernels from phases
3 and 6, of the backward kernels from phases 5 and 7's Gemma run, of
the fp32 kernels from phase 2's Llama dense engine and phase 4's
Llama and Gemma runs; the d-128 wgmma rows add phase 11's sharded
runs and phase 13's training, losses and predictor, phase 15's gang
worker and phase 16's gang worker and predictor actor, the d-128
forward and G-4 paged rows phase 12's and phase 14's engines, the G-4
paged row phase 13's, phase 17's replicas and generate stage the d-128
wgmma and 3xTF32 forward and the G-4 paged rows, phase 18's trial
actors and gang workers the d-64/128 wgmma rows, phase 20's GPU actor
the d-128 forward and G-4 paged rows, phase 21's generate stage and
gang worker the d-128 and d-64 wgmma rows; the scalar bf16 rows
phase 8's, 0 there: the tiny presets are fp32; phase 19 launches no
attention kernel);
the last line is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the ray_tpu_torch package beside it, the script exits non-zero
before any result.
"""

from __future__ import annotations

import gc
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import time


def _bytecode_cache() -> None:
    """Write and read compiled bytecode under the checkout's
    ``ray_tpu_torch/_build/pycache``. Where the environment sets
    ``PYTHONDONTWRITEBYTECODE`` and torch's installation holds no
    ``__pycache__``, every process the script starts compiles torch's
    Python source anew: seconds for ``import torch`` and as many again
    for the ``torch._dynamo`` that an optimizer's first step imports, in
    each GPU actor, gang worker and trial (phase 0 prints this process's
    ``import torch``). With the cache only the first process compiles.
    Set before torch is imported, for this process and, through the
    environment, for every process it starts."""
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "ray_tpu_torch")):
        return
    prefix = os.path.join(here, "ray_tpu_torch", "_build", "pycache")
    os.makedirs(prefix, exist_ok=True)
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)


if __name__ == "__main__":
    _bytecode_cache()
_IMPORT_T0 = time.perf_counter()

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

_IMPORT_S = time.perf_counter() - _IMPORT_T0

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# fp32 work in 3xTF32 on the tensor cores: three TF32 products (495
# TFLOP/s dense) for each fp32 one; the floor of the 3xTF32 kernels
TF32X3_FLOPS = 495e12 / 3

# config.json values of the published models phases 4 and 6 build
# (Qwen/Qwen2-7B, google/gemma-7b), written out so that the configs build
# without transformers or a download; llama_config_from_hf reads them as
# attributes
PUBLISHED = {
    "Qwen2-7B": dict(vocab_size=152064, hidden_size=3584,
                     intermediate_size=18944, num_hidden_layers=28,
                     num_attention_heads=28, num_key_value_heads=4,
                     max_position_embeddings=131072, rope_theta=1000000.0,
                     rms_norm_eps=1e-6, tie_word_embeddings=False,
                     use_sliding_window=False, hidden_act="silu"),
    "Gemma-7B": dict(vocab_size=256000, hidden_size=3072,
                     intermediate_size=24576, num_hidden_layers=28,
                     num_attention_heads=16, num_key_value_heads=16,
                     head_dim=256, max_position_embeddings=8192,
                     rope_theta=10000.0, rms_norm_eps=1e-6,
                     tie_word_embeddings=True,
                     hidden_activation="gelu_pytorch_tanh"),
}


def published_config(model: str):
    """The port's LlamaConfig of a ``PUBLISHED`` model, through
    ``llama_config_from_hf``: Qwen2 with its q/k/v biases; Gemma with the
    deltas ``gemma_from_hf`` applies (GeGLU, sqrt(hidden) embed scale,
    tied head; its norms' +1 lives in the weights)."""
    import math
    import types
    from dataclasses import replace

    from ray_tpu_torch.models.hf_weights import llama_config_from_hf

    attrs = types.SimpleNamespace(**PUBLISHED[model])
    cfg = llama_config_from_hf(attrs, attn_qkv_bias=model == "Qwen2-7B")
    if model == "Gemma-7B":
        cfg = replace(cfg, mlp_act="gelu_tanh",
                      embed_scale=math.sqrt(attrs.hidden_size))
    return cfg


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one ``fn`` call by CUDA events, each call
    after a 512 MB write that evicts the 50 MB L2: the serving path
    finds its inputs cold, behind other layers' weights. The write keeps
    the card busy for longer than the host takes to enqueue a call, so
    the events time the call's launches back to back on the card, not
    the host's Python between them."""
    flush = torch.empty(128 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def kernel_ms(fn, names, iters: int = 10) -> dict:
    """Mean device time of each named kernel over ``iters`` calls of
    ``fn`` (which may launch several kernels), from ``torch.profiler``,
    each call after the same L2-evicting write as ``time_ms``."""
    flush = torch.empty(128 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(names, 0.0)
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for n in names:
            if n in evt.name:
                us[n] += evt.time_range.elapsed_us()
    for n in names:
        check(us[n] > 0, f"the profiler saw no {n} launch")
    return {n: us[n] / 1e3 / iters for n in names}


def bound_ms(nbytes: float, flops: float, dtype, rate=None) -> tuple:
    """The larger of the bytes' time at the HBM rate and the operations'
    at ``rate`` (default: the dtype's peak), with which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (rate or PEAK_FLOPS[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fp32_bounds(nbytes: float, flops: float) -> tuple:
    """(SIMT bound, 3xTF32 floor, bound_by) of fp32 work: at 67 TFLOP/s of
    fp32 FMAs, and at 495 / 3 on the tensor cores; the floor is the row's
    ``bound_ms``."""
    simt, _ = bound_ms(nbytes, flops, torch.float32)
    floor, by = bound_ms(nbytes, flops, torch.float32, TF32X3_FLOPS)
    return simt, floor, by


def close(got: torch.Tensor, want: torch.Tensor, atol: float,
          rtol: float) -> tuple:
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return ok, float(diff.max()) if diff.numel() else 0.0


# ---------------------------------------------------------------- phase 0

# the wgmma kernels and their instances (d 64 and 128, or d 256 alone):
# their SASS must hold HGMMA (warpgroup MMA) instructions
WGMMA_KERNELS = {"flash_fwd_sm90_kernel": 2, "flash_bwd_dq_sm90_kernel": 2,
                 "flash_bwd_dkv_sm90_kernel": 2,
                 "flash_fwd_sm90_d256_kernel": 1,
                 "flash_bwd_dq_sm90_d256_kernel": 1,
                 "flash_bwd_dkv_sm90_d256_kernel": 1}
# the kernels that must build without a spill
NO_SPILL_KERNELS = ("flash_fwd_sm90_d256_kernel",
                    "flash_bwd_dq_sm90_d256_kernel",
                    "flash_bwd_dkv_sm90_d256_kernel")
# the 3xTF32 kernels and their instances (d 16, 32, 64, 128, 256): their
# SASS must hold HMMA (mma.sync) instructions, and the instances at d <=
# 128 must build without a spill
TF32X3_KERNELS = {"flash_fwd_tf32x3_kernel": 5,
                  "flash_bwd_dq_tf32x3_kernel": 5,
                  "flash_bwd_dkv_tf32x3_kernel": 5}


def head_dim_of(name: str) -> int:
    """The head-dim template argument of a mangled kernel name."""
    m = re.search(r"ILi(\d+)E", name)
    return int(m.group(1)) if m else 0


def ptxas_usage(log: str) -> dict:
    """{mangled kernel name: (registers, spill stores, spill loads)} from
    the ``-Xptxas=-v`` lines of the build log."""
    usage, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line and name:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spills = (nums[1], nums[2])
        elif "Used" in line and "registers" in line and name:
            regs = int(line.split("Used")[1].split()[0])
            usage[name] = (regs, *spills)
            name, spills = None, (0, 0)
    return usage


def sass_counts(lib_path, opcodes) -> dict:
    """{opcode: {mangled kernel name: instructions}} for every kernel in
    the built library, from ``cuobjdump -sass``."""
    from ray_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, name = {op: {} for op in opcodes}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            for op in opcodes:
                counts[op][name] = 0
        elif name:
            for op in opcodes:
                if re.search(rf"\b{op}\.", line):
                    counts[op][name] += 1
    return counts


def build_phase() -> None:
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"  kernels built in {_build.last_build_seconds:.1f} s "
          f"(load {time.perf_counter() - t0:.1f} s): "
          f"{_build.library_path().name}", flush=True)
    log_path = _build.BUILD_DIR / "build.log"
    if log_path.exists():
        log = log_path.read_text()
        usage = ptxas_usage(log)
        for name, (regs, st, ld) in usage.items():
            print(f"  ptxas: {name}: {regs} registers, spill stores {st} "
                  f"bytes, spill loads {ld} bytes", flush=True)
        for line in log.splitlines():
            if "warning" in line.lower():
                print(f"  ptxas: {line.strip()}", flush=True)
        for kernel in NO_SPILL_KERNELS:
            found = {n: u for n, u in usage.items() if kernel in n}
            check(len(found) == 1 and all(u[1] == u[2] == 0
                                          for u in found.values()),
                  f"{kernel}: want one instance without spills, ptxas "
                  f"reported {found}")
        for kernel in TF32X3_KERNELS:
            spilled = {n: u for n, u in usage.items() if kernel in n
                       and head_dim_of(n) <= 128 and (u[1] or u[2])}
            check(not spilled, f"{kernel}: instances at d <= 128 spill: "
                  f"{spilled}")
    sass = sass_counts(_build.library_path(), ("HGMMA", "HMMA"))
    for op, kernels in (("HGMMA", WGMMA_KERNELS), ("HMMA", TF32X3_KERNELS)):
        for kernel, want in kernels.items():
            found = {n: c for n, c in sass[op].items() if kernel in n}
            check(len(found) == want, f"{kernel}: want {want} instance(s) "
                  f"in the SASS, found {sorted(found)}")
            for n, c in sorted(found.items()):
                print(f"  sass: {n}: {c} {op} instructions", flush=True)
                check(c > 0, f"{n} has no {op} instruction")


# ---------------------------------------------------------------- phase 1


def _ragged_cases(dts):
    """(b, sq, sk, d, causal, dt) cases beyond the serving and training
    shapes: lengths that are not multiples of the tiles, and d 64."""
    return [(b, sq, sk, d, c, dt) for dt in dts
            for b, sq, sk, d in ((1, 100, 100, 128), (1, 1000, 1000, 128),
                                 (2, 128, 300, 128), (2, 512, 512, 64),
                                 (1, 128, 300, 64), (1, 1000, 1000, 64))
            for c in (True, False)]


def flash_phase(dev) -> list:
    from ray_tpu_torch.ops.attention import flash_forward, flash_forward_plain

    H, KVH = 32, 8
    g = torch.Generator(device=dev).manual_seed(1)
    worst = worst_fp32 = 0.0   # bf16 (the wgmma kernel), fp32 (3xTF32)
    dts = (torch.float32, torch.bfloat16)
    cases = [(b, s, s, 128, c, dt) for dt in dts
             for b in (1, 8) for s in (128, 512) for c in (True, False)]
    cases += [(b, sq, sk, 128, c, dt) for dt in dts
              for b, sq, sk, c in ((2, 128, 512, True), (1, 2048, 2048, True),
                                   (1, 2048, 2048, False))]
    cases += _ragged_cases(dts)
    n_bf16 = sum(dt == torch.bfloat16 for *_, dt in cases)
    before = counters()
    for b, sq, sk, D, causal, dt in cases:
        q = torch.randn(b, sq, H, D, generator=g, device=dev).to(dt)
        k = torch.randn(b, sk, KVH, D, generator=g, device=dev).to(dt)
        v = torch.randn(b, sk, KVH, D, generator=g, device=dev).to(dt)
        o, lse = flash_forward(q, k, v, causal)
        o_ref, lse_ref = flash_forward_plain(q.float(), k.float(),
                                             v.float(), causal)
        torch.cuda.synchronize()
        tol = (1e-4, 0.0) if dt == torch.float32 else (2e-2, 2e-2)
        ok_o, err_o = close(o, o_ref, *tol)
        ok_l, err_l = close(lse, lse_ref, *tol)
        print(f"  flash b={b} sq={sq} sk={sk} d={D} causal={causal} "
              f"{str(dt)[6:]}: max|dO|={err_o:.3e} max|dlse|={err_l:.3e}",
              flush=True)
        check(ok_o and ok_l, f"flash kernel disagrees with its plain "
              f"version (b={b} sq={sq} sk={sk} d={D} causal={causal} {dt})")
        if dt == torch.float32:
            worst_fp32 = max(worst_fp32, err_o, err_l)
        else:
            worst = max(worst, err_o, err_l)
    n = {key: c - before[key] for key, c in counters().items()}
    n_fp32 = len(cases) - n_bf16
    check(n["fwd_sm90"] == n_bf16 and n["fwd_tf32x3"] == n_fp32,
          f"flash forward routes: want {n_bf16} bf16 launches on the wgmma "
          f"kernel and {n_fp32} fp32 on the 3xTF32 one, got {n}")

    # timing at the dense engine's largest prefill: 8 prompts in the
    # 512 bucket, causal; bf16 (the wgmma kernel, the row below) and fp32
    # (the 3xTF32 kernel of the fp32 engines, phase 2)
    D = 128
    b, s = 8, 512
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = s * (s + 1) // 2                        # visible (q, k) pairs
    flops = 4.0 * b * H * pairs * D
    timed = {}
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn(b, s, H, D, generator=g, device=dev).to(dt)
        k = torch.randn(b, s, KVH, D, generator=g, device=dev).to(dt)
        v = torch.randn(b, s, KVH, D, generator=g, device=dev).to(dt)
        ms = time_ms(lambda: flash_forward(q, k, v, True))
        plain_ms = time_ms(lambda: flash_forward_plain(q, k, v, True),
                           iters=5)
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
        lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
        size = q.element_size()
        nbytes = ((2 * b * s * H * D + 2 * b * s * KVH * D) * size
                  + b * H * s * 4)
        if dt == torch.float32:
            simt, bnd, by = fp32_bounds(nbytes, flops)
            what = (f"SIMT bound {simt:.4f} ms, 3xTF32 floor {bnd:.4f} ms "
                    f"({by})")
        else:
            bnd, by = bound_ms(nbytes, flops, dt)
            what = f"bound {bnd:.4f} ms ({by})"
        print(f"  flash timing b={b} s={s} causal {str(dt)[6:]}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
              f"{what}", flush=True)
        timed[dt] = (ms, plain_ms, lib_ms, bnd, by)
    fp32_row = dict(zip(("ms", "plain_ms", "library_ms", "bound_ms",
                         "bound_by"), timed[torch.float32]))
    fp32_row.update(name="flash_attention_fwd_tf32x3_d128", route="cuda",
                    source="ray_tpu_torch/csrc/flash_fwd_tf32x3.cu",
                    replaces="ray_tpu/ops/attention.py:78",
                    max_abs_err=worst_fp32)
    ms, plain_ms, lib_ms, bnd, by = timed[torch.bfloat16]
    dt = torch.bfloat16
    # and at the training shape, checked and timed; the table's row keeps
    # the serving shape's time
    b, s = 4, 2048
    q = torch.randn(b, s, H, D, generator=g, device=dev).to(dt)
    k = torch.randn(b, s, KVH, D, generator=g, device=dev).to(dt)
    v = torch.randn(b, s, KVH, D, generator=g, device=dev).to(dt)
    o, lse = flash_forward(q, k, v, True)
    o_ref, lse_ref = flash_forward_plain(q.float(), k.float(), v.float(),
                                         True)
    torch.cuda.synchronize()
    ok_o, err_o = close(o, o_ref, 2e-2, 2e-2)
    ok_l, err_l = close(lse, lse_ref, 2e-2, 2e-2)
    print(f"  flash b={b} sq={s} sk={s} causal=True bfloat16: "
          f"max|dO|={err_o:.3e} max|dlse|={err_l:.3e}", flush=True)
    check(ok_o and ok_l, f"flash kernel disagrees with its plain version "
          f"at the training shape (b={b} s={s} bf16)")
    worst = max(worst, err_o, err_l)
    del o, lse, o_ref, lse_ref
    t_ms = time_ms(lambda: flash_forward(q, k, v, True), iters=10)
    t_plain = time_ms(lambda: flash_forward_plain(q, k, v, True), iters=3)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
    t_lib = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), iters=10)
    pairs = s * (s + 1) // 2
    t_bnd, t_by = bound_ms(
        (2 * b * s * H * D + 2 * b * s * KVH * D) * 2 + b * H * s * 4,
        4.0 * b * H * pairs * D, dt)
    print(f"  flash timing b={b} s={s} causal bf16 (training shape): kernel "
          f"{t_ms:.4f} ms, plain {t_plain:.4f} ms, sdpa {t_lib:.4f} ms, "
          f"bound {t_bnd:.4f} ms ({t_by})", flush=True)
    return [{"name": "flash_attention_fwd", "route": "cuda",
             "source": "ray_tpu_torch/csrc/flash_fwd_sm90.cu",
             "replaces": "ray_tpu/ops/attention.py:78",
             "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms},
            fp32_row]


def flash_bwd_phase(dev) -> list:
    from ray_tpu_torch.ops.attention import (flash_backward,
                                             flash_backward_plain,
                                             flash_forward_plain)

    H, KVH = 32, 8
    g = torch.Generator(device=dev).manual_seed(4)

    def inputs(b, sq, sk, D, causal, dt):
        q = torch.randn(b, sq, H, D, generator=g, device=dev).to(dt)
        k = torch.randn(b, sk, KVH, D, generator=g, device=dev).to(dt)
        v = torch.randn(b, sk, KVH, D, generator=g, device=dev).to(dt)
        do = torch.randn(b, sq, H, D, generator=g, device=dev).to(dt)
        o, lse = flash_forward_plain(q.float(), k.float(), v.float(), causal)
        return q, k, v, o.to(dt).contiguous(), lse, do

    dts = (torch.float32, torch.bfloat16)
    worst = {(k, dt): 0.0 for k in ("dq", "dkv") for dt in dts}
    cases = [(b, s, s, 128, c, dt) for dt in dts
             for b in (1, 4) for s in (128, 512, 2048) for c in (True, False)]
    cases += [(4, 128, 512, 128, True, dt) for dt in dts]
    cases += _ragged_cases(dts)
    # 4096 keys: 1,536 truncating adds into one dQ accumulator at G 4
    # without its restart every 512 keys
    cases += [(1, 4096, 4096, 128, True, torch.float32)]
    n_bf16 = sum(dt == torch.bfloat16 for *_, dt in cases)
    before = counters()
    for b, sq, sk, D, causal, dt in cases:
        q, k, v, o, lse, do = inputs(b, sq, sk, D, causal, dt)
        got = flash_backward(q, k, v, o, lse, do, causal)
        want = flash_backward_plain(q.float(), k.float(), v.float(),
                                    o.float(), lse, do.float(), causal)
        torch.cuda.synchronize()
        tol = (1e-4, 1e-4) if dt == torch.float32 else (2e-2, 2e-2)
        res = [close(a, w, *tol) for a, w in zip(got, want)]
        print(f"  flash bwd b={b} sq={sq} sk={sk} d={D} causal={causal} "
              f"{str(dt)[6:]}: max|ddq|={res[0][1]:.3e} "
              f"max|ddk|={res[1][1]:.3e} max|ddv|={res[2][1]:.3e} "
              f"(max|dq| {float(want[0].abs().max()):.3e})",
              flush=True)
        check(all(ok for ok, _ in res), f"flash backward kernels disagree "
              f"with their plain version (b={b} sq={sq} sk={sk} d={D} "
              f"causal={causal} {dt})")
        worst["dq", dt] = max(worst["dq", dt], res[0][1])
        worst["dkv", dt] = max(worst["dkv", dt], res[1][1], res[2][1])
        del q, k, v, o, lse, do, got, want
    n = {key: c - before[key] for key, c in counters().items()}
    n_fp32 = len(cases) - n_bf16
    check(n["dq_sm90"] == n["dkv_sm90"] == n_bf16
          and n["dq_tf32x3"] == n["dkv_tf32x3"] == n_fp32
          and n["dq"] == n["dkv"] == len(cases),
          f"flash backward routes: want {n_bf16} bf16 dQ and dK/dV launches "
          f"on the wgmma kernels and {n_fp32} fp32 dQ and dK/dV on the "
          f"3xTF32 ones, got {n}")

    # timing at the training shape: b 4, s 2048, causal; bf16 (the wgmma
    # kernels) and fp32 (the fp32 gradients' kernels, phase 4: the 3xTF32
    # dQ and dK/dV)
    b, s, D = 4, 2048, 128
    G = H // KVH
    pairs = s * (s + 1) // 2                        # visible (q, k) pairs
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        fp32 = dt == torch.float32
        q, k, v, o, lse, do = inputs(b, s, s, D, True, dt)
        keys = (("flash_bwd_dq_tf32x3_kernel", "flash_bwd_dkv_tf32x3_kernel")
                if fp32 else
                ("flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel"))
        ks = kernel_ms(lambda: flash_backward(q, k, v, o, lse, do, True),
                       keys)
        plain_ms = time_ms(lambda: flash_backward_plain(q, k, v, o, lse, do,
                                                        True), iters=3)
        qt = q.transpose(1, 2).detach().requires_grad_()
        kt = k.repeat_interleave(G, dim=2).transpose(1, 2).detach()
        vt = v.repeat_interleave(G, dim=2).transpose(1, 2).detach()
        kt.requires_grad_()
        vt.requires_grad_()
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), iters=10)
        del out
        size = q.element_size()
        ins = ((2 * b * s * H * D + 2 * b * s * KVH * D) * size
               + 2 * b * H * s * 4)
        names = (("flash_attention_bwd_dq_tf32x3_d128",
                  "flash_bwd_dq_tf32x3.cu"),
                 ("flash_attention_bwd_dkv_tf32x3_d128",
                  "flash_bwd_dkv_tf32x3.cu")) if fp32 else (
                 ("flash_attention_bwd_dq", "flash_bwd_dq_sm90.cu"),
                 ("flash_attention_bwd_dkv", "flash_bwd_dkv_sm90.cu"))
        for kind, key, flops, outs, src_line, (name, src) in (
                ("dq", keys[0], 6.0 * b * H * pairs * D, b * s * H * D * size,
                 207, names[0]),
                ("dkv", keys[1], 8.0 * b * H * pairs * D,
                 2 * b * s * KVH * D * size, 253, names[1])):
            bnd, by = bound_ms(ins + outs, flops, dt)
            what = f"bound {bnd:.4f} ms ({by})"
            if fp32:
                simt, bnd, by = fp32_bounds(ins + outs, flops)
                what = (f"SIMT bound {simt:.4f} ms, 3xTF32 floor {bnd:.4f} "
                        f"ms ({by})")
            print(f"  {name} timing b={b} s={s} causal {str(dt)[6:]}: "
                  f"kernel {ks[key]:.4f} ms, {what}; plain dq+dk+dv "
                  f"{plain_ms:.4f} ms, sdpa backward dq+dk+dv {lib_ms:.4f} ms",
                  flush=True)
            rows.append({"name": name, "route": "cuda",
                         "source": f"ray_tpu_torch/csrc/{src}",
                         "replaces": f"ray_tpu/ops/attention.py:{src_line}",
                         "max_abs_err": worst[kind, dt], "ms": ks[key],
                         "plain_ms": plain_ms, "bound_ms": bnd,
                         "bound_by": by, "library_ms": lib_ms})
        if fp32:
            pair = rows[-2]["ms"] + rows[-1]["ms"]
            print(f"  fp32 dQ + dK/dV pair b={b} s={s}: {pair:.4f} ms, "
                  f"sdpa fp32 backward {lib_ms:.4f} ms ({pair / lib_ms:.3f}x)",
                  flush=True)
        else:
            # both kernels recompute S and dP: one fused backward would do
            # 10*d FLOPs a visible pair and query head, not the pair's 6*d
            # + 8*d
            fused, fused_by = bound_ms(
                ins + b * s * H * D * size + 2 * b * s * KVH * D * size,
                10.0 * b * H * pairs * D, dt)
            split = rows[0]["bound_ms"] + rows[1]["bound_ms"]
            pair = rows[0]["ms"] + rows[1]["ms"]
            print(f"  flash backward floor b={b} s={s}: {fused:.4f} ms "
                  f"({fused_by}) for one fused kernel, {split:.4f} ms for "
                  f"the dQ and dK/dV pair; the pair measured {pair:.4f} ms",
                  flush=True)
        del q, k, v, o, lse, do, qt, kt, vt
    return rows


def _paged_inputs(dev, dt, g, ctx, KVH=8, G=4, hd=128, page=64, maxp=16):
    S = len(ctx)
    P = S * maxp + 8
    q = torch.randn(S, KVH, G, hd, generator=g, device=dev).to(dt)
    kp = torch.randn(P, KVH, page, hd, generator=g, device=dev).to(dt)
    vp = torch.randn(P, KVH, page, hd, generator=g, device=dev).to(dt)
    ids = torch.randperm(P, generator=torch.Generator().manual_seed(2))
    bt = torch.full((S, maxp), 2 ** 30, dtype=torch.int32)  # never read
    used = 0
    for s, c in enumerate(ctx):
        n = -(-c // page)
        bt[s, :n] = ids[used:used + n].to(torch.int32)
        used += n
    bt_plain = torch.where(bt == 2 ** 30, 0, bt)   # the plain gather
    ctx_t = torch.tensor(ctx, dtype=torch.int32)
    return (q, kp, vp, bt.to(dev), bt_plain.to(dev), ctx_t.to(dev))


def _paged_check(what, got, want, ctx, tol) -> float:
    """Holds the kernel's (acc, m, l) to the plain version's: each of the
    three, the normalised output of live slots, and the exact ctx-0
    triple. Returns max |d out|."""
    acc, m, l = got
    ra, rm, rl = want
    oks = [close(acc, ra, *tol), close(m, rm, *tol), close(l, rl, *tol)]
    live = ctx > 0
    ok_n, err = close(acc[live] / l[live][..., None],
                      ra[live] / rl[live][..., None], *tol)
    empty_ok = (bool((acc[~live] == 0).all()) and
                bool((l[~live] == 0).all()) and
                bool((m[~live] == -1e30).all()))
    print(f"  paged {what}: max|d out|={err:.3e} max|d acc,m,l|="
          f"{max(e for _, e in oks):.3e} ctx0 exact={empty_ok}", flush=True)
    check(all(o for o, _ in oks) and ok_n and empty_ok,
          f"paged kernel disagrees with its plain version ({what})")
    return err


def paged_phase(dev, ctx_main) -> dict:
    from ray_tpu_torch.ops.paged_attention import (paged_attention,
                                                   paged_attention_reference,
                                                   split_pages)

    g = torch.Generator(device=dev).manual_seed(3)
    worst = 0.0
    ctx_check = [0, 1, 63, 64, 65, 300, 517, 1024]   # 1024 = full MAXP
    for dt in (torch.float32, torch.bfloat16):
        tol = (1e-4, 1e-5) if dt == torch.float32 else (2e-2, 2e-2)
        name = str(dt)[6:]
        q, kp, vp, bt, bt_plain, ctx = _paged_inputs(dev, dt, g, ctx_check)
        got = paged_attention(q, kp, vp, bt, ctx)
        want = paged_attention_reference(q.float(), kp.float(), vp.float(),
                                         bt_plain, ctx)
        torch.cuda.synchronize()
        worst = max(worst, _paged_check(f"ctx={ctx_check} {name}", got,
                                        want, ctx, tol))
        # two calls on the same inputs agree bit for bit: the splits merge
        # in order, with no float atomics
        again = paged_attention(q, kp, vp, bt, ctx)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"  paged {name}: two calls bit-identical: {same}", flush=True)
        check(same, f"two paged calls on the same inputs differ ({dt})")
        # ids outside the pool below ctx are read as clamp_page_ids reads
        # them (negative from the end, the rest clamped), by both versions
        P = kp.shape[0]
        bad = bt.clone()
        bad[1, 0], bad[5, 1], bad[6, 2], bad[7, 15] = -1, P + 7, -P - 5, 2 ** 30
        got = paged_attention(q, kp, vp, bad, ctx)
        want = paged_attention_reference(q.float(), kp.float(), vp.float(),
                                         bad, ctx)
        torch.cuda.synchronize()
        worst = max(worst, _paged_check(f"out-of-pool ids below ctx {name}",
                                        got, want, ctx, tol))
        # a 64-page table: contexts on the split boundaries of the grid
        maxp, page = 64, 64
        pps, n_split = split_pages(5, 8, maxp)
        run = pps * page                       # tokens of one split
        ctx_split = [1, run - 1, run, run + 1, maxp * page]
        q, kp, vp, bt, bt_plain, ctx = _paged_inputs(dev, dt, g, ctx_split,
                                                     maxp=maxp)
        got = paged_attention(q, kp, vp, bt, ctx)
        want = paged_attention_reference(q.float(), kp.float(), vp.float(),
                                         bt_plain, ctx)
        torch.cuda.synchronize()
        worst = max(worst, _paged_check(
            f"MAXP {maxp}, {pps} pages x {n_split} splits, ctx={ctx_split} "
            f"{name}", got, want, ctx, tol))
        del q, kp, vp, got, want, again
        # the other instances the kernel is built for: G 1, 2 and 8, hd 64
        for kvh, grp, hd in ((2, 1, 128), (8, 2, 64), (4, 8, 128)):
            q, kp, vp, bt, bt_plain, ctx = _paged_inputs(
                dev, dt, g, ctx_check, KVH=kvh, G=grp, hd=hd)
            got = paged_attention(q, kp, vp, bt, ctx)
            want = paged_attention_reference(q.float(), kp.float(),
                                             vp.float(), bt_plain, ctx)
            torch.cuda.synchronize()
            worst = max(worst, _paged_check(
                f"KVH {kvh} G {grp} hd {hd} {name}", got, want, ctx, tol))

    ms, plain_ms, bnd, by = _paged_timing(dev, torch.bfloat16, g, ctx_main)
    return {"name": "paged_attention", "route": "cuda",
            "source": "ray_tpu_torch/csrc/paged_attention.cu",
            "replaces": "ray_tpu/ops/paged_attention.py:83",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": None}


def _paged_timing(dev, dt, g, ctx_main, KVH=8, G=4, hd=128, what=""):
    """The wrapper's two launches (split and merge) together at the paged
    engine's decode shape: (ms, plain ms, bound ms, bound by)."""
    from ray_tpu_torch.ops.paged_attention import (paged_attention,
                                                   paged_attention_reference,
                                                   split_pages)

    q, kp, vp, bt, bt_plain, ctx = _paged_inputs(dev, dt, g, ctx_main,
                                                 KVH=KVH, G=G, hd=hd)
    ms = time_ms(lambda: paged_attention(q, kp, vp, bt, ctx), iters=50)
    plain_ms = time_ms(lambda: paged_attention_reference(
        q, kp, vp, bt_plain, ctx), iters=20)
    S = q.shape[0]
    page = kp.shape[2]
    size = q.element_size()
    tok = sum(ctx_main)
    pages = sum(-(-c // page) for c in ctx_main)
    nbytes = (q.numel() * size + 2 * tok * KVH * hd * size + pages * 4
              + S * 4 + S * KVH * G * (hd + 2) * 4)
    flops = 4.0 * tok * KVH * G * hd
    bnd, by = bound_ms(nbytes, flops, dt)
    pps, n_split = split_pages(S, KVH, bt.shape[1])
    print(f"  paged timing {what}S={S} KVH={KVH} G={G} hd={hd} "
          f"ctx={ctx_main} {str(dt)[6:]} ({pps} page(s) x {n_split} "
          f"splits): split + merge {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bnd:.4f} ms ({by})", flush=True)
    return ms, plain_ms, bnd, by


# (model, kv heads, query rows per kv head, head dim) of the published
# configurations the paged kernel's new instances serve
PAGED_FAMILIES = (("Qwen2-7B", 4, 7, 128), ("Qwen2-0.5B", 2, 7, 64),
                  ("Gemma-7B", 16, 1, 256), ("Gemma-2B", 1, 8, 256))


def paged_families_phase(dev, ctx_main) -> list:
    """The paged kernel at the GQA groups and head dims of Qwen2 and
    Gemma, fp32 and bf16: the old contexts (ctx 0 among them) and a
    64-page table, each against the plain version; then timed at the
    decode shape in both dtypes. Rows for the Qwen2-7B (G 7 under the
    row maximum 8) and Gemma-7B (hd 256) instances, which the served
    models launch; the errors of Qwen2-0.5B's (G 7, hd 64) and Gemma-2B's
    (G 8, hd 256) instances join those rows."""
    from ray_tpu_torch.ops.paged_attention import (paged_attention,
                                                   paged_attention_reference,
                                                   split_pages)

    g = torch.Generator(device=dev).manual_seed(5)
    ctx_check = [0, 1, 63, 64, 65, 300, 517, 1024]
    rows = {}
    for model, kvh, grp, hd in PAGED_FAMILIES:
        worst = 0.0
        for dt in (torch.float32, torch.bfloat16):
            tol = (1e-4, 1e-5) if dt == torch.float32 else (2e-2, 2e-2)
            name = f"{model} KVH {kvh} G {grp} hd {hd} {str(dt)[6:]}"
            maxp = 64
            pps, n_split = split_pages(5, kvh, maxp)
            run = pps * 64
            for ctxs, mp in ((ctx_check, 16),
                             ([1, run - 1, run, run + 1, maxp * 64], maxp)):
                q, kp, vp, bt, bt_plain, ctx = _paged_inputs(
                    dev, dt, g, ctxs, KVH=kvh, G=grp, hd=hd, maxp=mp)
                got = paged_attention(q, kp, vp, bt, ctx)
                want = paged_attention_reference(q.float(), kp.float(),
                                                 vp.float(), bt_plain, ctx)
                torch.cuda.synchronize()
                worst = max(worst, _paged_check(
                    f"{name} MAXP {mp} ctx={ctxs}", got, want, ctx, tol))
                del q, kp, vp, got, want
        times = {dt: _paged_timing(dev, dt, g, ctx_main, KVH=kvh, G=grp,
                                   hd=hd, what=f"{model} ")
                 for dt in (torch.float32, torch.bfloat16)}
        rows[model] = (worst, times[torch.bfloat16])
    out = []
    for model, key, also in (("Qwen2-7B", "gm8_hd128", "Qwen2-0.5B"),
                             ("Gemma-7B", "gm1_hd256", "Gemma-2B")):
        worst, (ms, plain_ms, bnd, by) = rows[model]
        worst = max(worst, rows[also][0])
        out.append({"name": f"paged_attention_{key}", "route": "cuda",
                    "source": "ray_tpu_torch/csrc/paged_attention.cu",
                    "replaces": "ray_tpu/ops/paged_attention.py:83",
                    "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bnd, "bound_by": by, "library_ms": None})
    return out


def flash_d256_phase(dev) -> list:
    """The flash forward, dQ and dK/dV at head dim 256 (Gemma's), fp32 and
    bf16, 16/16 heads, each against its plain version, with masks on
    ragged lengths and sq < sk: every bf16 launch on the wgmma route,
    every fp32 launch on the 3xTF32 route. Timed at the Gemma serving
    prefill (b 8 x s 512)
    and, for the backward, at b 2 x s 2048, beside
    scaled_dot_product_attention and its backward."""
    from ray_tpu_torch.ops.attention import (flash_backward,
                                             flash_backward_plain,
                                             flash_forward,
                                             flash_forward_plain)

    H = KVH = 16
    D = 256
    g = torch.Generator(device=dev).manual_seed(6)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def inputs(b, sq, sk, dt):
        return [torch.randn(b, n, H, D, generator=g, device=dev).to(dt)
                for n in (sq, sk, sk, sq)]

    worst = {(k, dt): 0.0 for k in ("fwd", "dq", "dkv")
             for dt in (torch.float32, torch.bfloat16)}
    dts = (torch.float32, torch.bfloat16)
    before = counters()
    n_calls = {dt: 0 for dt in dts}
    for b, sq, sk, causal in ((8, 512, 512, True), (1, 100, 100, True),
                              (2, 128, 300, True), (1, 512, 512, False),
                              (2, 2048, 2048, True)):
        for dt in dts:
            q, k, v, do = inputs(b, sq, sk, dt)
            o, lse = flash_forward(q, k, v, causal)
            o_ref, lse_ref = flash_forward_plain(q.float(), k.float(),
                                                 v.float(), causal)
            got = flash_backward(q, k, v, o, lse, do, causal)
            want = flash_backward_plain(q.float(), k.float(), v.float(),
                                        o.float(), lse, do.float(), causal)
            torch.cuda.synchronize()
            n_calls[dt] += 1
            fp32 = dt == torch.float32
            tol_f = (1e-4, 0.0) if fp32 else (2e-2, 2e-2)
            tol_b = (1e-4, 1e-4) if fp32 else (2e-2, 2e-2)
            res = [close(o, o_ref, *tol_f), close(lse, lse_ref, *tol_f)]
            res += [close(a, w, *tol_b) for a, w in zip(got, want)]
            print(f"  flash d=256 b={b} sq={sq} sk={sk} causal={causal} "
                  f"{str(dt)[6:]}: max|dO|={res[0][1]:.3e} "
                  f"max|dlse|={res[1][1]:.3e} max|ddq|={res[2][1]:.3e} "
                  f"max|ddk|={res[3][1]:.3e} max|ddv|={res[4][1]:.3e}",
                  flush=True)
            check(all(ok for ok, _ in res), f"d-256 flash kernels disagree "
                  f"with their plain versions (b={b} sq={sq} sk={sk} "
                  f"causal={causal} {dt})")
            worst["fwd", dt] = max(worst["fwd", dt], res[0][1], res[1][1])
            worst["dq", dt] = max(worst["dq", dt], res[2][1])
            worst["dkv", dt] = max(worst["dkv", dt], res[3][1], res[4][1])
            del q, k, v, do, o, lse, o_ref, lse_ref, got, want
    n = {key: c - before[key] for key, c in counters().items()}
    n_bf16 = n_calls[torch.bfloat16]
    total = sum(n_calls.values())
    n_fp32 = total - n_bf16
    print(f"  d=256 launches: forward {n['fwd']} (wgmma {n['fwd_sm90']}, "
          f"3xTF32 {n['fwd_tf32x3']}), dQ {n['dq']} (wgmma {n['dq_sm90']}, "
          f"3xTF32 {n['dq_tf32x3']}), dK/dV {n['dkv']} (wgmma "
          f"{n['dkv_sm90']}, 3xTF32 {n['dkv_tf32x3']})", flush=True)
    check(n["fwd"] == n["dq"] == n["dkv"] == total
          and n["fwd_sm90"] == n["dq_sm90"] == n["dkv_sm90"] == n_bf16
          and n["fwd_tf32x3"] == n["dq_tf32x3"] == n["dkv_tf32x3"] == n_fp32,
          f"d-256 routes: want the {n_bf16} bf16 launches of each kernel "
          f"on wgmma and every fp32 launch on 3xTF32, got {n}")

    rows = {}
    # the forward at the Gemma serving prefill: 8 prompts of 512, causal
    b, s = 8, 512
    for dt in dts:
        q, k, v, _ = inputs(b, s, s, dt)
        ms = time_ms(lambda: flash_forward(q, k, v, True), iters=10)
        plain_ms = time_ms(lambda: flash_forward_plain(q, k, v, True),
                           iters=3)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), iters=10)
        size = q.element_size()
        fp32 = dt == torch.float32
        nbytes = 4 * b * s * H * D * size + b * H * s * 4
        flops = 4.0 * b * H * (s * (s + 1) // 2) * D
        if fp32:
            simt, bnd, by = fp32_bounds(nbytes, flops)
            what = (f"SIMT bound {simt:.4f} ms, 3xTF32 floor {bnd:.4f} ms "
                    f"({by})")
        else:
            bnd, by = bound_ms(nbytes, flops, dt)
            what = f"bound {bnd:.4f} ms ({by})"
        print(f"  flash d=256 timing b={b} s={s} causal {str(dt)[6:]}: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
              f"{lib_ms:.4f} ms, {what}", flush=True)
        name, src = (("flash_attention_fwd_tf32x3_d256",
                      "flash_fwd_tf32x3.cu") if fp32
                     else ("flash_attention_fwd_sm90_d256",
                           "flash_fwd_sm90_d256.cu"))
        rows[name] = {"name": name, "route": "cuda",
                      "source": f"ray_tpu_torch/csrc/{src}",
                      "replaces": "ray_tpu/ops/attention.py:78",
                      "max_abs_err": worst["fwd", dt], "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                      "library_ms": lib_ms}
        del q, k, v, qt, kt, vt
    # the backward at b 2 x s 2048, causal: bf16 runs the two wgmma
    # kernels, fp32 the two 3xTF32 ones
    b, s = 2, 2048
    pairs = s * (s + 1) // 2
    for dt in dts:
        fp32 = dt == torch.float32
        q, k, v, do = inputs(b, s, s, dt)
        o, lse = flash_forward_plain(q.float(), k.float(), v.float(), True)
        o = o.to(dt).contiguous()
        dq_kernel, dkv_kernel = (
            ("flash_bwd_dq_tf32x3_kernel", "flash_bwd_dkv_tf32x3_kernel")
            if fp32 else
            ("flash_bwd_dq_sm90_d256_kernel",
             "flash_bwd_dkv_sm90_d256_kernel"))
        ks = kernel_ms(lambda: flash_backward(q, k, v, o, lse, do, True),
                       (dq_kernel, dkv_kernel))
        plain_ms = time_ms(lambda: flash_backward_plain(q, k, v, o, lse, do,
                                                        True), iters=3)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        out = sdpa(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), iters=10)
        del out
        size = q.element_size()
        ins = 4 * b * s * H * D * size + 2 * b * H * s * 4
        (dq_name, dq_src), (dkv_name, dkv_src) = (
            (("flash_attention_bwd_dq_tf32x3_d256",
              "flash_bwd_dq_tf32x3.cu"),
             ("flash_attention_bwd_dkv_tf32x3_d256",
              "flash_bwd_dkv_tf32x3.cu")) if fp32 else
            (("flash_attention_bwd_dq_sm90_d256",
              "flash_bwd_dq_sm90_d256.cu"),
             ("flash_attention_bwd_dkv_sm90_d256",
              "flash_bwd_dkv_sm90_d256.cu")))
        for name, key, flops, outs, line, src, kind in (
                (dq_name, dq_kernel, 6.0 * b * H * pairs * D,
                 b * s * H * D * size, 207, dq_src, "dq"),
                (dkv_name, dkv_kernel, 8.0 * b * H * pairs * D,
                 2 * b * s * KVH * D * size, 253, dkv_src, "dkv")):
            bnd, by = bound_ms(ins + outs, flops, dt)
            what = f"bound {bnd:.4f} ms ({by})"
            if fp32:
                simt, bnd, by = fp32_bounds(ins + outs, flops)
                what = (f"SIMT bound {simt:.4f} ms, 3xTF32 floor {bnd:.4f} "
                        f"ms ({by})")
            print(f"  {name} d=256 timing b={b} s={s} causal "
                  f"{str(dt)[6:]}: kernel {ks[key]:.4f} ms, {what}; plain "
                  f"dq+dk+dv {plain_ms:.4f} ms, sdpa backward dq+dk+dv "
                  f"{lib_ms:.4f} ms", flush=True)
            rows[name] = {"name": name, "route": "cuda",
                          "source": f"ray_tpu_torch/csrc/{src}",
                          "replaces": f"ray_tpu/ops/attention.py:{line}",
                          "max_abs_err": worst[kind, dt], "ms": ks[key],
                          "plain_ms": plain_ms, "bound_ms": bnd,
                          "bound_by": by, "library_ms": lib_ms}
        if fp32:
            pair = rows[dq_name]["ms"] + rows[dkv_name]["ms"]
            print(f"  fp32 dQ + dK/dV pair d=256 b={b} s={s}: {pair:.4f} ms, "
                  f"sdpa fp32 backward {lib_ms:.4f} ms ({pair / lib_ms:.3f}x)",
                  flush=True)
        else:
            # the d-256 dK/dV kernel computes S^T and dP^T in both consumer
            # warpgroups: 12*d FLOPs a visible pair, not the function's 8*d
            own, _ = bound_ms(ins + 2 * b * s * KVH * D * size,
                              12.0 * b * H * pairs * D, dt)
            print(f"  flash_attention_bwd_dkv_sm90_d256: its own bound "
                  f"(12*d FLOPs a visible pair) {own:.4f} ms", flush=True)
        del q, k, v, do, o, lse, qt, kt, vt
    return list(rows.values())


def flash_small_d_phase(dev) -> list:
    """The tiny presets' head dims 16 and 32, fp32 and bf16, 4/2 heads:
    the flash forward, dQ and dK/dV (bf16 on the scalar route, fp32 on the
    3xTF32 route) causal, non-causal, ragged
    and sq < sk, and the paged kernel under each row maximum (G 1, 2, 4
    and 8) on the old contexts, each against its plain version. Then the
    scalar kernels (``flash_fwd.cu``, ``flash_bwd.cu``) timed at the tiny
    engines' shape: returns their rows of the kernel table."""
    from ray_tpu_torch.ops.attention import (flash_backward,
                                             flash_backward_plain,
                                             flash_forward,
                                             flash_forward_plain)
    from ray_tpu_torch.ops.paged_attention import (paged_attention,
                                                   paged_attention_reference)

    H, KVH = 4, 2
    g = torch.Generator(device=dev).manual_seed(8)
    before = counters()
    n_calls = 0
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}   # bf16: the scalar route
    for D in (16, 32):
        for dt in (torch.float32, torch.bfloat16):
            fp32 = dt == torch.float32
            for b, sq, sk, causal in ((2, 128, 128, True),
                                      (2, 128, 128, False),
                                      (1, 100, 100, True),
                                      (2, 128, 300, True)):
                q, do = (torch.randn(b, sq, H, D, generator=g, device=dev)
                         .to(dt) for _ in range(2))
                k, v = (torch.randn(b, sk, KVH, D, generator=g, device=dev)
                        .to(dt) for _ in range(2))
                o, lse = flash_forward(q, k, v, causal)
                o_ref, lse_ref = flash_forward_plain(q.float(), k.float(),
                                                     v.float(), causal)
                got = flash_backward(q, k, v, o, lse, do, causal)
                want = flash_backward_plain(q.float(), k.float(), v.float(),
                                            o.float(), lse, do.float(),
                                            causal)
                torch.cuda.synchronize()
                n_calls += 1
                tol_f = (1e-4, 0.0) if fp32 else (2e-2, 2e-2)
                tol_b = (1e-4, 1e-4) if fp32 else (2e-2, 2e-2)
                res = [close(o, o_ref, *tol_f), close(lse, lse_ref, *tol_f)]
                res += [close(a, w, *tol_b) for a, w in zip(got, want)]
                print(f"  flash d={D} b={b} sq={sq} sk={sk} causal={causal}"
                      f" {str(dt)[6:]}: max err O, lse, dq, dk, dv "
                      f"{', '.join(f'{e:.3e}' for _, e in res)}", flush=True)
                check(all(ok for ok, _ in res), f"d-{D} flash kernels "
                      f"disagree with their plain versions (b={b} sq={sq} "
                      f"sk={sk} causal={causal} {dt})")
                if not fp32:
                    errs = [e for _, e in res]
                    worst["fwd"] = max(worst["fwd"], *errs[:2])
                    worst["dq"] = max(worst["dq"], errs[2])
                    worst["dkv"] = max(worst["dkv"], *errs[3:])
            ctx_check = [0, 1, 63, 64, 65, 300, 517, 1024]
            tol = (1e-4, 1e-5) if fp32 else (2e-2, 2e-2)
            for grp in (1, 2, 4, 8):
                q, kp, vp, bt, bt_plain, ctx = _paged_inputs(
                    dev, dt, g, ctx_check, KVH=2, G=grp, hd=D)
                got = paged_attention(q, kp, vp, bt, ctx)
                want = paged_attention_reference(q.float(), kp.float(),
                                                 vp.float(), bt_plain, ctx)
                torch.cuda.synchronize()
                _paged_check(f"KVH 2 G {grp} hd {D} {str(dt)[6:]}", got,
                             want, ctx, tol)
    n = {key: c - before[key] for key, c in counters().items()}
    check(n["fwd"] == n["dq"] == n["dkv"] == n_calls
          and n["fwd_sm90"] == n["dq_sm90"] == n["dkv_sm90"] == 0
          and n["fwd_tf32x3"] == n["dq_tf32x3"] == n["dkv_tf32x3"]
          == n_calls // 2 and n["paged"] == n["paged_merge"] == 16,
          f"d-16/32 launches: want {n_calls} of each flash kernel, the "
          f"fp32 half on the 3xTF32 route, the rest scalar, and 16 paged "
          f"calls, got {n}")
    return _scalar_rows(dev, worst)


def _scalar_rows(dev, worst: dict) -> list:
    """The scalar bf16 kernels timed at the tiny presets' shape, 4 slots
    of the 128 bucket (b 4 x s 128, 4/2 heads, head dim 16, causal): the
    forward by CUDA events, dQ and dK/dV by the profiler, each beside its
    plain version, SDPA (forward; backward for the pair) and its bound."""
    from ray_tpu_torch.ops.attention import (flash_backward,
                                             flash_backward_plain,
                                             flash_forward,
                                             flash_forward_plain)

    H, KVH, D, b, s = 4, 2, 16, 4, 128
    G = H // KVH
    dt = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(16)
    q, do = (torch.randn(b, s, H, D, generator=g, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn(b, s, KVH, D, generator=g, device=dev).to(dt)
            for _ in range(2))
    o, lse = flash_forward_plain(q.float(), k.float(), v.float(), True)
    o = o.to(dt).contiguous()
    pairs = s * (s + 1) // 2
    ins = (2 * b * s * H * D + 2 * b * s * KVH * D) * 2
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).detach()
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).detach()
    kt.requires_grad_()
    vt.requires_grad_()
    before = counters()
    fwd_ms = time_ms(lambda: flash_forward(q, k, v, True))
    ks = kernel_ms(lambda: flash_backward(q, k, v, o, lse, do, True),
                   ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"))
    n = {key: c - before[key] for key, c in counters().items()}
    check(n["fwd"] > 0 and n["fwd_sm90"] == n["fwd_tf32x3"] == 0
          and n["dq"] > 0 and n["dq_sm90"] == n["dq_tf32x3"] == 0,
          f"the bf16 d-16 timing left the scalar route: {n}")
    plain_fwd = time_ms(lambda: flash_forward_plain(q, k, v, True))
    plain_bwd = time_ms(lambda: flash_backward_plain(q, k, v, o, lse, do,
                                                     True))
    with torch.no_grad():
        lib_fwd = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    out = sdpa(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    rows = []
    for name, src, line, ms, plain, lib, nbytes, flops, err in (
            ("flash_attention_fwd_scalar_d16", "flash_fwd.cu", 78, fwd_ms,
             plain_fwd, lib_fwd, ins + b * H * s * 4,
             4.0 * b * H * pairs * D, worst["fwd"]),
            ("flash_attention_bwd_dq_scalar_d16", "flash_bwd.cu", 207,
             ks["flash_bwd_dq_kernel"], plain_bwd, lib_bwd,
             ins + 2 * b * H * s * 4 + b * s * H * D * 2,
             6.0 * b * H * pairs * D, worst["dq"]),
            ("flash_attention_bwd_dkv_scalar_d16", "flash_bwd.cu", 253,
             ks["flash_bwd_dkv_kernel"], plain_bwd, lib_bwd,
             ins + 2 * b * H * s * 4 + 2 * b * s * KVH * D * 2,
             8.0 * b * H * pairs * D, worst["dkv"])):
        bnd, by = bound_ms(nbytes, flops, dt)
        print(f"  {name} timing b={b} s={s} d={D} causal bf16 (scalar): "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms"
              f"{' (backward, dq+dk+dv)' if 'bwd' in name else ''}, bound "
              f"{bnd:.4f} ms ({by})", flush=True)
        rows.append({"name": name, "route": "cuda",
                     "source": f"ray_tpu_torch/csrc/{src}",
                     "replaces": f"ray_tpu/ops/attention.py:{line}",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": bnd, "bound_by": by, "library_ms": lib})
    return rows


def flash_tf32x3_phase(dev) -> None:
    """The 3xTF32 kernels (the fp32 forward, dQ and dK/dV) at every head
    dim they are built for (16, 32, 64, 128, 256) and GQA groups 1, 4, 7
    and 8 (2 kv heads), causal and not, at a length ragged to the
    kernels' tiles (sq = sk = 200): O and lse at atol 1e-4, dQ, dK and dV
    at atol/rtol 1e-4, each against its plain version."""
    from ray_tpu_torch.ops.attention import (flash_backward,
                                             flash_backward_plain,
                                             flash_forward,
                                             flash_forward_plain)

    KVH, s = 2, 200
    g = torch.Generator(device=dev).manual_seed(9)
    before = counters()
    n_calls, worst = 0, [0.0] * 5
    for D in (16, 32, 64, 128, 256):
        for grp in (1, 4, 7, 8):
            for causal in (True, False):
                H = KVH * grp
                q, do = (torch.randn(1, s, H, D, generator=g, device=dev)
                         for _ in range(2))
                k, v = (torch.randn(1, s, KVH, D, generator=g, device=dev)
                        for _ in range(2))
                o, lse = flash_forward(q, k, v, causal)
                o_ref, lse_ref = flash_forward_plain(q, k, v, causal)
                got = flash_backward(q, k, v, o, lse, do, causal)
                want = flash_backward_plain(q, k, v, o, lse, do, causal)
                torch.cuda.synchronize()
                n_calls += 1
                res = [close(o, o_ref, 1e-4, 0.0),
                       close(lse, lse_ref, 1e-4, 0.0)]
                res += [close(a, w, 1e-4, 1e-4) for a, w in zip(got, want)]
                worst = [max(w, e) for w, (_, e) in zip(worst, res)]
                check(all(ok for ok, _ in res), f"3xTF32 flash kernels "
                      f"disagree with their plain versions (d={D} G={grp} "
                      f"causal={causal}): max err O, lse, dq, dk, dv "
                      f"{', '.join(f'{e:.3e}' for _, e in res)}")
    n = {key: c - before[key] for key, c in counters().items()}
    print(f"  3xTF32 d 16-256 x G 1/4/7/8 x causal/not ({n_calls} calls): "
          f"worst err O, lse, dq, dk, dv "
          f"{', '.join(f'{e:.3e}' for e in worst)}", flush=True)
    check(n["fwd"] == n["fwd_tf32x3"] == n["dkv"] == n["dkv_tf32x3"]
          == n["dq"] == n["dq_tf32x3"] == n_calls,
          f"3xTF32 phase routes: want {n_calls} forward, dQ and dK/dV "
          f"launches on 3xTF32, got {n}")


# ------------------------------------------------------------ phases 2, 3


def drain(engine, reqs, timeout_s: float) -> dict:
    for rid, prompt in reqs:
        engine.submit(rid, prompt)
    out = {}
    deadline = time.monotonic() + timeout_s
    while len(out) < len(reqs) and time.monotonic() < deadline:
        check(engine._thread.is_alive(), "engine thread died")
        out.update(engine.collect())
        time.sleep(0.005)
    for rid, _ in reqs:
        check(rid in out, f"request {rid} timed out")
        check(not isinstance(out[rid], Exception),
              f"request {rid} failed: {out[rid]!r}")
    return out


def stop(engine) -> None:
    engine.shutdown()
    engine._thread.join(timeout=60)
    check(not engine._thread.is_alive(), "engine thread did not stop")


def counters_reset():
    from ray_tpu_torch.ops.attention import flash_backward, flash_forward
    from ray_tpu_torch.ops.paged_attention import paged_attention

    flash_forward.launches = flash_forward.sm90_launches = 0
    flash_forward.tf32x3_launches = 0
    paged_attention.launches = paged_attention.merge_launches = 0
    flash_backward.dq_launches = flash_backward.dq_sm90_launches = 0
    flash_backward.dq_tf32x3_launches = 0
    flash_backward.dkv_launches = flash_backward.dkv_sm90_launches = 0
    flash_backward.dkv_tf32x3_launches = 0


def counters() -> dict:
    """Kernel launches since the last reset: the flash forward (all
    routes, the bf16 wgmma route and the fp32 3xTF32 route), paged (split
    and merge passes), dQ and dK/dV (each: all routes, the wgmma route and
    the 3xTF32 route)."""
    from ray_tpu_torch.ops.attention import flash_backward, flash_forward
    from ray_tpu_torch.ops.paged_attention import paged_attention

    return {"fwd": flash_forward.launches,
            "fwd_sm90": flash_forward.sm90_launches,
            "fwd_tf32x3": flash_forward.tf32x3_launches,
            "paged": paged_attention.launches,
            "paged_merge": paged_attention.merge_launches,
            "dq": flash_backward.dq_launches,
            "dq_sm90": flash_backward.dq_sm90_launches,
            "dq_tf32x3": flash_backward.dq_tf32x3_launches,
            "dkv": flash_backward.dkv_launches,
            "dkv_sm90": flash_backward.dkv_sm90_launches,
            "dkv_tf32x3": flash_backward.dkv_tf32x3_launches}


def _model_config(cfg) -> dict:
    """An engine's ``model_config`` that rebuilds ``cfg`` field by field."""
    from dataclasses import fields

    return {"preset": "llama3_8b",
            **{f.name: getattr(cfg, f.name) for f in fields(cfg)}}


def fp32_phase(dev, cfg, name) -> int:
    """fp32, ``cfg`` at 2 layers: the dense and paged engines' greedy
    transcripts are identical and every token is the argmax of a
    cache-free forward through the reference attention. Returns the dense
    engine's flash forward launches."""
    from dataclasses import replace

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm_engine import LLMEngine
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

    cfg = replace(cfg, num_layers=2, dtype=torch.float32,
                  param_dtype=torch.float32)
    mc = _model_config(cfg)
    params = llama.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(11)
    reqs = [(f"f{i}", [int(t) for t in rng.integers(1, cfg.vocab_size, n)])
            for i, n in enumerate((37, 64, 100, 128))]
    kw = dict(model_config=mc, num_slots=4, max_len=256,
              prefill_buckets=[128], max_new_tokens=16, chunk_steps=8,
              eos_id=-1, params=params, device=dev)
    counters_reset()
    dense = LLMEngine(**kw)
    got_d = {r: v["tokens"] for r, v in drain(dense, reqs, 120).items()}
    stop(dense)
    fl = counters()["fwd"]
    check(fl > 0, "fp32 dense engine never launched the flash kernel")
    check(counters()["fwd_tf32x3"] == fl,
          f"fp32 dense engine: {counters()['fwd_tf32x3']} of {fl} flash "
          f"forward launches on the 3xTF32 kernel")
    counters_reset()
    paged = PagedLLMEngine(page_size=64, **kw)
    got_p = {r: v["tokens"] for r, v in drain(paged, reqs, 120).items()}
    stop(paged)
    check(counters()["fwd_tf32x3"] == counters()["fwd"],
          f"fp32 paged engine: flash forward launches off the 3xTF32 "
          f"kernel: {counters()}")
    pa2 = counters()["paged"]
    check(pa2 > 0, "fp32 paged engine never launched the paged kernel")
    check(counters()["paged_merge"] == pa2,
          "fp32 paged engine: split and merge launches differ")
    print(f"  fp32 2-layer {name}: dense flash launches {fl}, paged "
          f"launches {pa2}; transcripts identical: {got_d == got_p}",
          flush=True)
    check(got_d == got_p, f"fp32 dense and paged transcripts differ:\n"
          f"{got_d}\n{got_p}")
    # teacher-forced check against the cache-free forward pass through
    # the reference attention (independent of the flash kernel the dense
    # engine ran): every generated token is its argmax (up to a 1e-3
    # near-tie)
    oracle = replace(cfg, attn_impl="reference")
    for rid, prompt in reqs:
        seq = prompt + got_d[rid]
        with torch.no_grad():
            logits = llama.forward(oracle, params,
                                   torch.tensor([seq], device=dev))
        lg = logits[0, len(prompt) - 1:len(seq) - 1]
        chosen = lg.gather(1, torch.tensor(got_d[rid], device=dev)[:, None])
        gap = float((lg.max(dim=1).values - chosen[:, 0]).max())
        check(torch.isfinite(logits).all().item(), "non-finite logits")
        check(gap <= 1e-3, f"{rid}: engine token is not the reference "
              f"argmax (logit gap {gap})")
    print(f"  fp32 2-layer {name}: transcripts agree with llama.forward",
          flush=True)
    return fl


# ------------------------------------------------------------ phases 4, 5


def grad_phase(dev, cfg, mod=None, seq: int = 256) -> dict:
    """fp32 gradients of ``cfg`` (2 layers, batch 2 x ``seq``) through the
    flash kernels against the reference attention's and against no
    remat; ``mod`` (default ``models.llama``) gives ``init_params`` and
    ``loss_fn``. Returns the launch counts of the flash run."""
    from dataclasses import replace

    from ray_tpu_torch.models import llama

    mod = mod or llama
    cfg = replace(cfg, num_layers=2, dtype=torch.float32,
                  param_dtype=torch.float32, attn_impl="flash", remat=True)
    params = mod.init_params(cfg, seed=0, device=dev)
    leaves = llama.param_leaves(params)
    for _, leaf in leaves:
        leaf.requires_grad_()
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (2, seq + 1))).to(dev)

    def loss_and_grads(c):
        for _, leaf in leaves:
            leaf.grad = None
        loss = mod.loss_fn(c, params, {"tokens": toks})
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), [leaf.grad for _, leaf in leaves]

    counters_reset()
    l_flash, g_flash = loss_and_grads(cfg)
    n = counters()
    check(n["dq"] == n["dkv"] == cfg.num_layers,
          f"flash gradients took {n['dq']} dQ and {n['dkv']} dK/dV "
          f"launches, want {cfg.num_layers} each")
    check(n["fwd_sm90"] == n["dq_sm90"] == n["dkv_sm90"] == 0
          and n["fwd_tf32x3"] == n["fwd"] and n["dq_tf32x3"] == n["dq"]
          and n["dkv_tf32x3"] == n["dkv"],
          f"fp32 gradients: want every forward, dQ and dK/dV launch on the "
          f"3xTF32 kernels, got {n}")
    runs = {"reference attention": replace(cfg, attn_impl="reference"),
            "no remat": replace(cfg, remat=False)}
    for what, c in runs.items():
        l_other, g_other = loss_and_grads(c)
        worst = 0.0
        for (name, _), a, b in zip(leaves, g_flash, g_other):
            check(bool(torch.isfinite(a).all()), f"non-finite grad {name}")
            ratio = float((a - b).abs().max() / b.abs().max().clamp_min(
                1e-30))
            worst = max(worst, ratio)
            check(ratio <= 1e-4, f"flash vs {what}: grad {name} max|dg| = "
                  f"{ratio:.3e} max|g|")
        dl = abs(l_flash - l_other)
        print(f"  fp32 2-layer grads, flash vs {what}: loss {l_flash:.6f} "
              f"vs {l_other:.6f} (|d| {dl:.2e}); worst leaf max|dg|/max|g| "
              f"{worst:.3e} over {len(leaves)} leaves", flush=True)
        check(dl <= 1e-4 * abs(l_other), f"flash vs {what}: loss differs")
        del g_other
    return n


def _scalar_launches(n: dict) -> dict:
    """Launches of the scalar route (all routes less wgmma and 3xTF32),
    by kernel-table row."""
    return {f"flash_attention_{k}_scalar_d16":
            n[kk] - n[f"{kk}_sm90"] - n[f"{kk}_tf32x3"]
            for k, kk in (("fwd", "fwd"), ("bwd_dq", "dq"),
                          ("bwd_dkv", "dkv"))}


def tiny_phase(dev) -> dict:
    """The tiny presets (head dim 16) on the card: both engines with
    their defaults (Llama tiny, fp32) on prompts that pad to the 128
    bucket give identical greedy transcripts, each token the argmax of a
    cache-free forward through the reference attention; fp32 gradients
    of the Llama, GPT-2 and Mixtral tiny presets through the kernels
    match the reference attention's. The d-16 flash kernels and the
    hd-16 paged kernel must have run. Returns the scalar route's
    launches (the presets are fp32: the 3xTF32 kernels serve them)."""
    scalar = dict.fromkeys(_scalar_launches(counters()), 0)
    from dataclasses import replace

    from ray_tpu_torch.models import gpt2, llama, mixtral
    from ray_tpu_torch.serve.llm_engine import LLMEngine
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

    rng = np.random.default_rng(14)
    reqs = [(f"t{i}", [int(t) for t in rng.integers(1, 256, m)])
            for i, m in enumerate((70, 90, 110, 127))]
    got = {}
    for name, make in (("dense", LLMEngine), ("paged", PagedLLMEngine)):
        counters_reset()
        eng = make(device=dev)
        got[name] = {r: v["tokens"]
                     for r, v in drain(eng, reqs, 120).items()}
        cfg, params = eng._cfg, eng._params
        stop(eng)
        n = counters()
        for k, c in _scalar_launches(n).items():
            scalar[k] += c
        print(f"  tiny {name} engine (head dim {cfg.head_dim_}, "
              f"{str(cfg.dtype)[6:]}): flash launches {n['fwd']} (3xTF32 "
              f"{n['fwd_tf32x3']}), paged launches {n['paged']} (merges "
              f"{n['paged_merge']})", flush=True)
        check(n["fwd_tf32x3"] == n["fwd"],
              f"tiny {name} engine: fp32 flash launches off the 3xTF32 "
              f"kernel: {n}")
        if name == "dense":
            check(n["fwd"] > 0, "tiny dense engine: no flash launch")
        else:
            check(n["paged"] > 0 and n["paged_merge"] == n["paged"],
                  "tiny paged engine: no paged split and merge launches")
    check(got["dense"] == got["paged"], f"tiny dense and paged transcripts "
          f"differ:\n{got['dense']}\n{got['paged']}")
    oracle = replace(cfg, attn_impl="reference")
    for rid, prompt in reqs:
        seq = prompt + got["dense"][rid]
        with torch.no_grad():
            logits = llama.forward(oracle, params,
                                   torch.tensor([seq], device=dev))
        lg = logits[0, len(prompt) - 1:len(seq) - 1]
        chosen = lg.gather(1, torch.tensor(got["dense"][rid],
                                           device=dev)[:, None])
        gap = float((lg.max(dim=1).values - chosen[:, 0]).max())
        check(gap <= 1e-3, f"tiny {rid}: engine token is not the reference "
              f"argmax (logit gap {gap})")
    print("  tiny engines: transcripts identical and agree with "
          "llama.forward", flush=True)
    for name, mod, cfg in (("Llama", llama, llama.LlamaConfig.tiny()),
                           ("GPT-2", gpt2, gpt2.GPT2Config.tiny()),
                           ("Mixtral", mixtral,
                            mixtral.MixtralConfig.tiny())):
        n = grad_phase(dev, cfg, mod, seq=128)
        for k, c in _scalar_launches(n).items():
            scalar[k] += c
        print(f"  tiny {name} gradients: flash forward {n['fwd']}, dQ "
              f"{n['dq']}, dK/dV {n['dkv']} launches (all 3xTF32)",
              flush=True)
    print(f"  tiny presets: scalar-route launches {scalar}", flush=True)
    return scalar


def train_phase(dev) -> dict:
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.tools import profile_train as run

    L, steps, b, s = run.LAYERS, 5, run.BATCH, run.SEQ
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  device memory allocated before: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    cfg, params, opt, toks = run.build_train_run(dev)
    check(cfg.remat and cfg.remat_policy == "full" and
          cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32,
          "training config is not fp32 params, bf16 compute, full remat")
    n = llama.num_params(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    counters_reset()
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = run.train_step(cfg, params, opt, toks)
        losses.append(loss.item())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    runs = counters()
    fwd, dq, dkv = runs["fwd"], runs["dq"], runs["dkv"]
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(walls[1:])
    tok = b * s
    qdim = cfg.num_heads * cfg.head_dim_
    flops = 6.0 * n * tok + 3.0 * 2.0 * 2.0 * 0.5 * L * s * tok * qdim
    print(f"  {n / 1e9:.3f}e9 params; losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}", flush=True)
    print(f"  step {step_s * 1e3:.1f} ms (median of steps 2-{steps}; first "
          f"{walls[0] * 1e3:.1f} ms), {tok / step_s:.1f} tokens/s, MFU "
          f"{flops / step_s / PEAK_FLOPS[torch.bfloat16]:.4f} of 989 "
          f"TFLOP/s, peak memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"  training launches: flash forward {fwd} (wgmma route "
          f"{runs['fwd_sm90']}), dQ {dq} (wgmma route {runs['dq_sm90']}), "
          f"dK/dV {dkv} (wgmma route {runs['dkv_sm90']})", flush=True)
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(fwd == 2 * L * steps, f"flash forward launched {fwd} times, want "
          f"{2 * L * steps} (twice a layer a step under remat)")
    check(dq == dkv == L * steps, f"dQ/dK/dV launched {dq}/{dkv} times, "
          f"want {L * steps} each")
    check(runs["fwd_sm90"] == fwd and runs["dq_sm90"] == dq
          and runs["dkv_sm90"] == dkv,
          f"bf16 training took the wgmma kernels for {runs['fwd_sm90']} of "
          f"{fwd} forward, {runs['dq_sm90']} of {dq} dQ and "
          f"{runs['dkv_sm90']} of {dkv} dK/dV launches")
    del params, opt, loss
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention_fwd": runs["fwd_sm90"],
            "flash_attention_bwd_dq": runs["dq_sm90"],
            "flash_attention_bwd_dkv": runs["dkv_sm90"],
            "losses": losses, "step_ms": step_s * 1e3}


# phase 3's engine settings and requests, which phase 9 serves again
SERVE_8B = dict(model_config={"preset": "llama3_8b", "dtype": "bfloat16",
                              "param_dtype": "bfloat16"},
                num_slots=8, max_len=1024, prefill_buckets=[128, 512],
                chunk_steps=8, max_new_tokens=32, eos_id=-1)
SERVE_8B_LENS = (100, 157, 214, 271, 328, 385, 442, 500)


def serve_8b_requests(vocab_size: int) -> tuple:
    """Phase 3's 8 prompts (seed 12): the first 7, then the last, which
    shares prompt 1's first 128 tokens (2 full pages of 64 that prompt 1
    publishes to the prefix cache when it finishes)."""
    rng = np.random.default_rng(12)
    prompts = [[int(t) for t in rng.integers(1, vocab_size, m)]
               for m in SERVE_8B_LENS]
    prompts[7] = prompts[1][:128] + prompts[7][128:]
    return ([(f"q{i}", prompts[i]) for i in range(7)],
            [("q7", prompts[7])])


def serve_8b_overflow(vocab_size: int) -> list:
    """Phase 3's ninth prompt (seed 13, 700 tokens), served by the dense
    engine alone after the 8: longer than the last listed bucket, so it
    takes the overflow bucket ``max_len - 1``."""
    rng = np.random.default_rng(13)
    return [int(t) for t in rng.integers(1, vocab_size, 700)]


def serve_8b_phase(dev) -> tuple:
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm_engine import LLMEngine
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

    t0 = time.perf_counter()
    cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                      param_dtype=torch.bfloat16)
    params = llama.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n = llama.num_params(params)
    print(f"  Llama-3-8B bf16: {n / 1e9:.3f}e9 params on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    first, last = serve_8b_requests(cfg.vocab_size)
    kw = dict(SERVE_8B, params=params, device=dev)
    result = {}
    for name, make in (("dense", lambda: LLMEngine(**kw)),
                       ("paged", lambda: PagedLLMEngine(page_size=64, **kw))):
        counters_reset()
        eng = make()
        t1 = time.perf_counter()
        out = drain(eng, first, 300)
        out.update(drain(eng, last, 120))
        wall = time.perf_counter() - t1
        over_fwd = 0
        if name == "dense":
            # a prompt past the last listed bucket (512) takes the dense
            # engine's overflow bucket, max_len - 1 = 1023: the flash
            # forward at a length that is no multiple of its tiles. Its
            # launches join the kernel line, not ``launches``, which
            # later phases compare with their own 8 requests'
            fwd8 = counters()["fwd"]
            over = drain(eng, [("over", serve_8b_overflow(cfg.vocab_size))],
                         120)["over"]["tokens"]
            over_fwd = counters()["fwd"] - fwd8
            check(len(over) == 32
                  and all(0 <= t < cfg.vocab_size for t in over),
                  f"dense: the 700-token prompt (bucket 1023) gave {over}")
            check(over_fwd == cfg.num_layers,
                  f"dense: the 700-token prompt's prefill launched the "
                  f"flash forward {over_fwd} times, want {cfg.num_layers}")
            print(f"  8B dense: a 700-token prompt through the overflow "
                  f"bucket 1023 gave {len(over)} tokens, {over_fwd} flash "
                  f"launches", flush=True)
        st = eng.stats()
        stop(eng)
        n = counters()
        launches = (n["fwd"] - over_fwd, n["paged"])
        check(n["paged_merge"] == n["paged"],
              f"{name}: {n['paged']} paged split launches but "
              f"{n['paged_merge']} merges")
        check(n["fwd_sm90"] == n["fwd"],
              f"{name}: {n['fwd_sm90']} of {n['fwd']} bf16 flash launches "
              f"took the wgmma kernel")
        del eng
        torch.cuda.empty_cache()
        for rid, res in out.items():
            check(len(res["tokens"]) == 32,
                  f"{name} {rid}: {len(res['tokens'])} tokens, want 32")
            check(all(0 <= t < cfg.vocab_size for t in res["tokens"]),
                  f"{name} {rid}: token out of vocabulary")
        ttft = statistics.median(r["ttft_s"] for r in out.values()) * 1e3
        itl = statistics.median((r["latency_s"] - r["ttft_s"]) / 31
                                for r in out.values()) * 1e3
        print(f"  8B {name}: 8 requests x 32 tokens in {wall:.2f} s; "
              f"TTFT p50 {ttft:.2f} ms, ITL p50 {itl:.3f} ms; flash "
              f"launches {launches[0]}, paged launches {launches[1]}",
              flush=True)
        if name == "paged":
            print(f"  8B paged: prefix_hit_tokens "
                  f"{st['prefix_hit_tokens']}", flush=True)
            check(st["prefix_hit_tokens"] >= 128,
                  "the shared 128-token prefix did not hit the cache")
        result[name] = {"tokens": {r: v["tokens"] for r, v in out.items()},
                        "launches": launches, "lat": _latency_ms(out),
                        "overflow_fwd": over_fwd}
    check(result["dense"]["launches"][0] > 0,
          "dense engine never launched the flash kernel")
    check(result["paged"]["launches"][1] > 0,
          "paged engine never launched the paged kernel")
    same = sum(result["dense"]["tokens"][r] == result["paged"]["tokens"][r]
               for r in result["dense"]["tokens"])
    print(f"  8B bf16: dense and paged transcripts identical for {same}/8 "
          f"requests (not required in bf16)", flush=True)
    return ({"flash_attention_fwd": result["dense"]["launches"][0]
             + result["dense"]["overflow_fwd"],
             "paged_attention": result["paged"]["launches"][1]}, result)


# ------------------------------------------------------------ phases 6, 7


def _counted(eng):
    """Count the engine's prefill batches (dense engine) and dispatched
    decode steps, by wrapping its two dispatch methods."""
    n = {"prefill_batches": 0, "decode_steps": 0}
    if hasattr(eng, "_prefill_batch"):
        prefill = eng._prefill_batch

        def counted_prefill(*a):
            n["prefill_batches"] += 1
            return prefill(*a)
        eng._prefill_batch = counted_prefill
    run_chunk = eng._run_chunk

    def counted_chunk(act, k, *a):
        n["decode_steps"] += k
        return run_chunk(act, k, *a)
    eng._run_chunk = counted_chunk
    return n


def serve_family_phase(dev, model) -> dict:
    """A published model at full width, bf16 random weights from seed 0,
    through the dense and then the paged engine with phase 3's request
    mix. The flash forward must launch once a layer a prefill batch (and
    on the route its head dim takes), the paged kernel once a layer a
    decode step. Returns the launches of its kernels."""
    from dataclasses import replace

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm_engine import LLMEngine
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

    t0 = time.perf_counter()
    cfg = replace(published_config(model), dtype=torch.bfloat16,
                  param_dtype=torch.bfloat16, max_seq_len=1024)
    L = cfg.num_layers
    params = llama.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"  {model} bf16: {llama.num_params(params) / 1e9:.3f}e9 params, "
          f"{L} layers, G {cfg.num_heads // cfg.num_kv_heads}, head_dim "
          f"{cfg.head_dim_}, on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    first, last = serve_8b_requests(cfg.vocab_size)
    kw = dict(SERVE_8B, model_config=_model_config(cfg), params=params,
              device=dev)
    from ray_tpu_torch.ops.attention import flash_route

    sm90 = flash_route(cfg.dtype, cfg.head_dim_, dev, "fwd") == "sm90"
    out_launches = {}
    for name, make in (("dense", lambda: LLMEngine(**kw)),
                       ("paged", lambda: PagedLLMEngine(page_size=64, **kw))):
        counters_reset()
        eng = make()
        n_run = _counted(eng)
        t1 = time.perf_counter()
        out = drain(eng, first, 300)
        out.update(drain(eng, last, 120))
        wall = time.perf_counter() - t1
        st = eng.stats()
        stop(eng)
        n = counters()
        del eng
        torch.cuda.empty_cache()
        for rid, res in out.items():
            check(len(res["tokens"]) == 32,
                  f"{model} {name} {rid}: {len(res['tokens'])} tokens")
            check(all(0 <= t < cfg.vocab_size for t in res["tokens"]),
                  f"{model} {name} {rid}: token out of vocabulary")
        ttft = statistics.median(r["ttft_s"] for r in out.values()) * 1e3
        itl = statistics.median((r["latency_s"] - r["ttft_s"]) / 31
                                for r in out.values()) * 1e3
        print(f"  {model} {name}: 8 requests x 32 tokens in {wall:.2f} s; "
              f"TTFT p50 {ttft:.2f} ms, ITL p50 {itl:.3f} ms; prefill "
              f"batches {n_run['prefill_batches']}, decode steps "
              f"{n_run['decode_steps']}; flash forward launches {n['fwd']} "
              f"(wgmma route {n['fwd_sm90']}), paged launches "
              f"{n['paged']} (merges {n['paged_merge']})", flush=True)
        if name == "dense":
            want = L * n_run["prefill_batches"]
            check(n_run["prefill_batches"] > 0 and n["fwd"] == want,
                  f"{model} dense: {n['fwd']} flash forward launches, want "
                  f"{L} layers x {n_run['prefill_batches']} prefill batches")
            check(n["fwd_sm90"] == (n["fwd"] if sm90 else 0),
                  f"{model} dense: {n['fwd_sm90']} of {n['fwd']} flash "
                  f"launches on the wgmma route, want "
                  f"{'all' if sm90 else 'none (the scalar route)'}")
            out_launches["fwd"] = n["fwd"]
        else:
            want = L * n_run["decode_steps"]
            check(n_run["decode_steps"] > 0 and n["paged"] == want
                  and n["paged_merge"] == want,
                  f"{model} paged: {n['paged']} split and "
                  f"{n['paged_merge']} merge launches, want {L} layers x "
                  f"{n_run['decode_steps']} decode steps")
            print(f"  {model} paged: prefix_hit_tokens "
                  f"{st['prefix_hit_tokens']}", flush=True)
            check(st["prefix_hit_tokens"] >= 128,
                  f"{model}: the shared 128-token prefix did not hit")
            out_launches["paged"] = n["paged"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out_launches


def _train(dev, name, mod, cfg, params, toks, steps, n_active, heads,
           head_dim) -> dict:
    """``steps`` AdamW(3e-4, weight decay 0.01) steps of ``mod.loss_fn``
    on one batch: losses finite and falling, every layer's flash forward
    (twice under remat), dQ and dK/dV each step, each on the route
    ``flash_route`` gives it at ``head_dim``. Prints step time, tokens/s,
    MFU (bench.py's formula on ``n_active`` params a token and heads x
    head dim) and peak memory; returns the launch counts."""
    from ray_tpu_torch.models.llama import param_leaves
    from ray_tpu_torch.ops.attention import flash_route

    routes = {k: flash_route(cfg.dtype, head_dim, dev, k)
              for k in ("fwd", "dq", "dkv")}
    qdim = heads * head_dim

    leaves = [p.requires_grad_() for _, p in param_leaves(params)]
    opt = torch.optim.AdamW(leaves, lr=3e-4, weight_decay=0.01)
    L = cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    counters_reset()
    for _ in range(steps):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = mod.loss_fn(cfg, params, {"tokens": toks})
        loss.backward()
        opt.step()
        losses.append(loss.item())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    runs = counters()
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(walls[1:])
    b, s = toks.shape[0], toks.shape[1] - 1
    tok = b * s
    flops = 6.0 * n_active * tok + 3.0 * 2.0 * 2.0 * 0.5 * L * s * tok \
        * qdim
    print(f"  {name}: losses {' '.join(f'{x:.4f}' for x in losses)}",
          flush=True)
    print(f"  {name}: step {step_s * 1e3:.1f} ms (median of steps 2-{steps};"
          f" first {walls[0] * 1e3:.1f} ms), {tok / step_s:.1f} tokens/s, "
          f"MFU {flops / step_s / PEAK_FLOPS[torch.bfloat16]:.4f} of 989 "
          f"TFLOP/s on {n_active / 1e9:.3f}e9 params a token, peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    print(f"  {name}: launches flash forward {runs['fwd']} (wgmma route "
          f"{runs['fwd_sm90']}), dQ {runs['dq']} (wgmma route "
          f"{runs['dq_sm90']}), dK/dV {runs['dkv']} (wgmma route "
          f"{runs['dkv_sm90']}); routes at head dim {head_dim}: {routes}",
          flush=True)
    check(all(np.isfinite(losses)), f"{name}: non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"{name}: loss did not fall: {losses}")
    for kernel, want in (("fwd", 2 * L * steps), ("dq", L * steps),
                         ("dkv", L * steps)):
        on_sm90 = want if routes[kernel] == "sm90" else 0
        check(runs[kernel] == want and runs[f"{kernel}_sm90"] == on_sm90,
              f"{name}: {runs[kernel]} {kernel} launches "
              f"({runs[f'{kernel}_sm90']} wgmma), want {want} on the "
              f"{routes[kernel]} route")
    del opt, leaves, loss
    return dict(runs, losses=losses, step_ms=step_s * 1e3)


def train_families_phase(dev) -> dict:
    """GPT-2 125M whole (12 layers, head dim 64) on tokens of 1025, so
    that the model sees 1024; then Mixtral-8x7B width (hidden 4096, ffn
    14336, 8 experts top-2, 32/8 heads) cut to 2 layers for memory, batch
    4 x 2048; then Gemma-7B width (hidden 3072, ffn 24576, 16/16 heads,
    head dim 256, GeGLU, vocab 256000, tied) cut to 4 layers for memory,
    batch 2 x 2048. fp32 params, bf16 compute, full remat, 5 steps each."""
    from ray_tpu_torch.models import gpt2, llama, mixtral

    runs = {}
    rng = np.random.default_rng(0)
    cfg = gpt2.GPT2Config.gpt2_125m()
    params = gpt2.init_params(cfg, seed=0, device=dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (8, 1025))).to(dev)
    n = llama.num_params(params)
    print(f"  GPT-2 125M: {n / 1e9:.4f}e9 params, batch 8 x 1024",
          flush=True)
    runs["gpt2"] = _train(dev, "GPT-2 125M", gpt2, cfg, params, toks, 5, n,
                          cfg.num_heads, cfg.head_dim)
    del params, toks
    gc.collect()
    torch.cuda.empty_cache()

    cfg = mixtral.MixtralConfig.mixtral_8x7b(num_layers=2)
    params = mixtral.init_params(cfg, seed=0, device=dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (4, 2049))).to(dev)
    n = llama.num_params(params)
    expert = 3 * cfg.hidden_size * cfg.intermediate_size * cfg.num_layers
    n_active = n - (cfg.num_experts - cfg.top_k) * expert
    print(f"  Mixtral-8x7B width, 2 layers: {n / 1e9:.3f}e9 params "
          f"({n_active / 1e9:.3f}e9 active a token), batch 4 x 2048, "
          f"capacity {mixtral._capacity(cfg, 4 * 2048)} a expert",
          flush=True)
    runs["mixtral"] = _train(dev, "Mixtral-8x7B width", mixtral, cfg, params,
                             toks, 5, n_active, cfg.num_heads, cfg.head_dim_)
    del params, toks
    gc.collect()
    torch.cuda.empty_cache()

    # Gemma-7B width: head dim 256, the wgmma forward, dQ and dK/dV in
    # bf16; profile_train's gemma_7b run, held to the published config
    from dataclasses import replace

    from ray_tpu_torch.tools.profile_train import train_config

    cfg = train_config("gemma_7b")
    check(cfg == replace(published_config("Gemma-7B"), num_layers=4,
                         dtype=torch.bfloat16, param_dtype=torch.float32,
                         remat=True, remat_policy="full"),
          f"profile_train's gemma_7b config is not Gemma-7B's: {cfg}")
    params = llama.init_params(cfg, seed=0, device=dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (2, 2049))).to(dev)
    n = llama.num_params(params)
    print(f"  Gemma-7B width, 4 layers: {n / 1e9:.3f}e9 params, batch 2 x "
          f"2048, head dim {cfg.head_dim_}", flush=True)
    runs["gemma"] = _train(dev, "Gemma-7B width", llama, cfg, params, toks,
                           5, n, cfg.num_heads, cfg.head_dim_)
    del params, toks
    gc.collect()
    torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------- phases 9, 10


def _latency_ms(out: dict) -> dict:
    """TTFT and ITL (per generated token after the first) p50 and p99
    over the requests, in ms."""
    ttft = [r["ttft_s"] * 1e3 for r in out.values()]
    itl = [(r["latency_s"] - r["ttft_s"]) / max(len(r["tokens"]) - 1, 1)
           * 1e3 for r in out.values()]
    return {"ttft_p50": float(np.percentile(ttft, 50)),
            "ttft_p99": float(np.percentile(ttft, 99)),
            "itl_p50": float(np.percentile(itl, 50)),
            "itl_p99": float(np.percentile(itl, 99))}


# the handoff lease of the runs without a fault: long enough that only a
# lost handoff outlives it. Under the 5 s default a handoff that lands
# late expires and is prefilled again locally, which costs latency only
# but reads as a recovery; phase 9(b)'s handoffs reach the decode loop
# seconds after submit, and the host's speed differs 2x between machines.
CLEAN_LEASE_S = 60.0


def _check_disagg(st: dict, n_diverted: int, what: str,
                  recovered: bool = False) -> None:
    check(st["disagg_diverted"] == n_diverted,
          f"{what}: {st['disagg_diverted']} diverted, want {n_diverted}")
    if recovered:
        check(st["disagg_recovered"] >= 1, f"{what}: nothing recovered")
    else:
        check(st["disagg_handoffs"] == n_diverted
              and st["disagg_recovered"] == 0,
              f"{what}: {st['disagg_handoffs']} handoffs, "
              f"{st['disagg_recovered']} recovered; want {n_diverted}, 0")
    check(st["disagg_pending"] == 0, f"{what}: leases still pending")


def _check_pool(eng, what: str) -> None:
    alloc = eng._alloc
    check(len(alloc.free) + len(alloc.lru) == alloc.num_pages,
          f"{what}: {len(alloc.free)} free + {len(alloc.lru)} cached pages "
          f"of {alloc.num_pages}: pages leaked")


def _stop_disagg(eng) -> None:
    stop(eng)
    for th in eng._wthreads:
        check(not th.is_alive(), "a prefill worker did not stop")


def _serve_once(make, reqs_first, reqs_last, timeout_s):
    eng = make()
    out = drain(eng, reqs_first, timeout_s)
    out.update(drain(eng, reqs_last, timeout_s))
    return eng, out


def disagg_fp32_phase(dev) -> dict:
    """9(a): fp32 Llama-3-8B width, 2 layers: the disaggregated engine
    (2 prefill workers, divert floor 128) gives the plain paged engine's
    greedy tokens on phase 3's requests, with every prompt of 128 tokens
    or more diverted and handed off, and none lost or leaked under a
    dropped handoff and a killed worker. Returns the paged engine's
    tokens."""
    from dataclasses import replace

    from ray_tpu_torch.core import fault_injection
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.disagg import DisaggPagedEngine
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

    cfg = replace(llama.LlamaConfig.llama3_8b(), num_layers=2,
                  dtype=torch.float32, param_dtype=torch.float32)
    params = llama.init_params(cfg, seed=0, device=dev)
    first, last = serve_8b_requests(cfg.vocab_size)
    n_div = sum(len(p) >= 128 for _, p in first + last)
    kw = dict(SERVE_8B, model_config=_model_config(cfg), params=params,
              device=dev, page_size=64)
    counters_reset()
    eng, out = _serve_once(lambda: PagedLLMEngine(**kw), first, last, 120)
    stop(eng)
    want = {r: v["tokens"] for r, v in out.items()}
    dkw = dict(kw, prefill_workers=2, divert_min_tokens=128)
    runs = (("clean", None, CLEAN_LEASE_S), ("drop", "drop", 0.5),
            ("kill_worker", "kill_worker", 0.5))
    for name, action, timeout in runs:
        if action is not None:
            fault_injection.inject("prefill_handoff", action, times=1)
        eng, out = _serve_once(
            lambda: DisaggPagedEngine(handoff_timeout_s=timeout, **dkw),
            first, last, 120)
        fault_injection.clear()
        got = {r: v["tokens"] for r, v in out.items()}
        st = eng.stats()
        if action == "kill_worker":
            deadline = time.monotonic() + 10
            while (eng.stats()["prefill_workers"] < 2
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            st = eng.stats()
            check(st["prefill_workers"] == 2,
                  f"kill_worker: {st['prefill_workers']} of 2 workers alive")
        _stop_disagg(eng)
        print(f"  fp32 2-layer disagg ({name}): tokens identical to the "
              f"paged engine's: {got == want}; diverted "
              f"{st['disagg_diverted']}, handoffs {st['disagg_handoffs']}, "
              f"recovered {st['disagg_recovered']}, imported pages "
              f"{st['disagg_imported_pages']}, workers alive "
              f"{st['prefill_workers']}", flush=True)
        check(got == want, f"fp32 disagg ({name}) tokens differ from the "
              f"paged engine's:\n{got}\n{want}")
        _check_disagg(st, n_div, f"fp32 disagg ({name})",
                      recovered=action is not None)
        _check_pool(eng, f"fp32 disagg ({name})")
        del eng
    c = counters()
    print(f"  fp32 2-layer disagg runs: flash forward launches {c['fwd']} "
          f"(3xTF32 {c['fwd_tf32x3']}), paged {c['paged']}", flush=True)
    check(c["fwd_tf32x3"] == c["fwd"] and c["dq_tf32x3"] == c["dq"]
          and c["dkv_tf32x3"] == c["dkv"],
          f"fp32 disagg: flash launches off the 3xTF32 kernels: {c}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return want


def disagg_serve_phase(dev) -> dict:
    """9(b): bf16 Llama-3-8B, all 32 layers, phase 3's weights (seed 0)
    and requests: the plain paged engine, then the disaggregated one (2
    prefill workers on their own streams, divert floor 128). Returns the
    latencies and the staging pool's size."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.disagg import DisaggPagedEngine
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine
    from ray_tpu_torch.tools.serve_latency import _log_chunks

    cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                      param_dtype=torch.bfloat16)
    params = llama.init_params(cfg, seed=0, device=dev)
    first, last = serve_8b_requests(cfg.vocab_size)
    n_div = sum(len(p) >= 128 for _, p in first + last)
    kw = dict(SERVE_8B, params=params, device=dev, page_size=64)
    result = {}
    for name in ("paged", "disagg"):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        counters_reset()
        if name == "paged":
            eng = PagedLLMEngine(**kw)
        else:
            eng = DisaggPagedEngine(prefill_workers=2,
                                    divert_min_tokens=128,
                                    handoff_timeout_s=CLEAN_LEASE_S, **kw)
            deadline = time.monotonic() + 30
            while len(eng._wstates) < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            torch.cuda.synchronize()
            check(len(eng._wstates) == 2, "prefill workers did not start")
            streams = [ws["stream"] for ws in eng._wstates.values()]
            check(all(s is not None and s != torch.cuda.default_stream(dev)
                      for s in streams) and streams[0] != streams[1],
                  "prefill workers do not run on streams of their own")
        # each decode chunk's steps and active requests, for 13(c)
        chunks = _log_chunks(eng)
        torch.cuda.synchronize()
        pool_mib = (torch.cuda.memory_allocated() - before) / 2**20
        t1 = time.perf_counter()
        out = drain(eng, first, 300)
        out.update(drain(eng, last, 120))
        wall = time.perf_counter() - t1
        st = eng.stats()
        n = counters()
        log = {}
        if name == "disagg":
            staging = sum(t.numel() * t.element_size()
                          for t in eng._wstates[0]["cache"].values()) / 2**20
            log = eng.prefill_log()
            _stop_disagg(eng)
            _check_disagg(st, n_div, "8B bf16 disagg")
        else:
            stop(eng)
        _check_pool(eng, f"8B bf16 {name}")
        del eng
        torch.cuda.empty_cache()
        for rid, res in out.items():
            check(len(res["tokens"]) == 32,
                  f"{name} {rid}: {len(res['tokens'])} tokens, want 32")
        check(n["paged"] > 0 and n["paged_merge"] == n["paged"],
              f"8B {name}: paged split/merge launches {n['paged']}/"
              f"{n['paged_merge']}")
        lat = _latency_ms(out)
        print(f"  8B bf16 {name}: 8 requests x 32 tokens in {wall:.2f} s; "
              f"TTFT p50 {lat['ttft_p50']:.2f} ms p99 "
              f"{lat['ttft_p99']:.2f} ms; ITL p50 {lat['itl_p50']:.3f} ms "
              f"p99 {lat['itl_p99']:.3f} ms; paged launches {n['paged']}; "
              f"device memory allocated by the engine {pool_mib:.1f} MiB",
              flush=True)
        if name == "disagg":
            print(f"  8B bf16 disagg: diverted {st['disagg_diverted']}, "
                  f"handoffs {st['disagg_handoffs']}, recovered "
                  f"{st['disagg_recovered']}, imported pages "
                  f"{st['disagg_imported_pages']}; staging pool "
                  f"{staging:.1f} MiB per worker (2 workers); prefill worker "
                  f"and staging-cache hit tokens per request: "
                  f"{_prefill_log_line(log)}", flush=True)
        result[name] = {"tokens": {r: v["tokens"] for r, v in out.items()},
                        "chunks": chunks,
                        "latency_ms": lat, "paged": n["paged"],
                        "engine_mib": pool_mib,
                        "staging_hit": st.get("disagg_staging_hit_tokens"),
                        "prefill_log": log}
    same = sum(result["paged"]["tokens"][r] == result["disagg"]["tokens"][r]
               for r in result["paged"]["tokens"])
    print(f"  8B bf16: disagg and paged transcripts identical for {same}/8 "
          f"requests (not required in bf16: the chunk boundaries differ)",
          flush=True)
    result["staging_mib"] = staging
    return result


def _prefill_log_line(log: dict) -> str:
    return " ".join(f"{r}:w{w}/{h}" for r, (w, h) in sorted(log.items()))


def decode_api_phase(dev) -> None:
    """9(c): bf16 Llama-3-8B, 32 layers: ``prefill`` of one 512-token
    prompt launches the flash forward once a layer and agrees with
    ``prefill_batch`` and with the reference attention's ``prefill``;
    ``insert_sequence`` writes its K/V into a dense cache exactly;
    ``init_shapes`` has ``init_params``'s shapes and dtypes."""
    from dataclasses import replace

    from ray_tpu_torch.models import llama, llama_decode

    cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                      param_dtype=torch.bfloat16)
    params = llama.init_params(cfg, seed=0, device=dev)
    shapes = dict(llama.param_leaves(llama.init_shapes(cfg)))
    real = dict(llama.param_leaves(params))
    check(sorted(shapes) == sorted(real) and all(
        shapes[k].is_meta and shapes[k].shape == real[k].shape
        and shapes[k].dtype == real[k].dtype for k in real),
        "init_shapes differs from init_params")
    toks = torch.tensor(np.random.default_rng(15).integers(
        1, cfg.vocab_size, (1, 512)), dtype=torch.int32, device=dev)
    counters_reset()
    logits, kv, x = llama_decode.prefill(cfg, params, toks)
    torch.cuda.synchronize()
    n = counters()
    check(n["fwd"] == cfg.num_layers and n["fwd_sm90"] == n["fwd"],
          f"prefill: {n['fwd']} flash launches ({n['fwd_sm90']} wgmma), "
          f"want {cfg.num_layers} on the wgmma route")
    check(tuple(logits.shape) == (512, cfg.vocab_size)
          and logits.dtype == torch.float32
          and tuple(kv["k"].shape) == (cfg.num_layers, 512, 8, 128)
          and bool(torch.isfinite(logits).all()),
          "prefill: wrong shapes or non-finite logits")
    blog, bkv = llama_decode.prefill_batch(
        cfg, params, toks, torch.tensor([511], device=dev))
    errs = {}
    for what, got, want in (("logits", logits[511], blog[0]),
                            ("k", kv["k"], bkv["k"][:, 0]),
                            ("v", kv["v"], bkv["v"][:, 0])):
        ok, errs[what] = close(got, want, 2e-2, 2e-2)
        check(ok, f"prefill {what} differs from prefill_batch: "
              f"{errs[what]:.3e}")
    # printed, not asserted: the two attentions round differently in
    # bf16 and 32 layers carry the difference on (phase 1 holds the
    # kernel to its plain version)
    rlog, rkv, _ = llama_decode.prefill(
        replace(cfg, prefill_flash=False), params, toks)
    ref_err = {what: close(got, want, 0.0, 0.0)[1]
               for what, got, want in (("logits", logits, rlog),
                                       ("k", kv["k"], rkv["k"]),
                                       ("v", kv["v"], rkv["v"]))}
    cache = llama_decode.init_cache(cfg, 2, 1024, dev)
    llama_decode.insert_sequence(cache, kv, 1)
    check(all(torch.equal(cache[n_][:, 1, :512], kv[n_]) for n_ in "kv")
          and not cache["k"][:, 0].any() and not cache["k"][:, 1,
                                                           512:].any(),
          "insert_sequence did not write the slot exactly")
    print(f"  decode API: prefill of 512 tokens launched the flash forward "
          f"{n['fwd']} times (wgmma {n['fwd_sm90']}); against prefill_batch "
          f"max|d| logits {errs['logits']:.3e} k {errs['k']:.3e} v "
          f"{errs['v']:.3e}; against the reference attention (printed "
          f"only) logits "
          f"{ref_err['logits']:.3e} k {ref_err['k']:.3e} v "
          f"{ref_err['v']:.3e}; insert_sequence exact; init_shapes matches "
          f"{len(real)} leaves", flush=True)
    del params, cache, logits, kv, x, blog, bkv, rlog, rkv
    gc.collect()
    torch.cuda.empty_cache()


# the RL learners of phase 10: name -> (learner factory, batch maker,
# update call, optimizer steps per update, learning rate)
def _rl_cases():
    from ray_tpu_torch.rllib import (appo, dqn, dreamer, impala, learner,
                                     offline, rl_module, sac)

    catch = (10, 10, 1)
    rng = np.random.default_rng(16)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731

    def ppo_batch(n=4096, d=100, a=3):
        return {"obs": f32(n, d), "actions": rng.integers(0, a, n),
                "logp_old": np.full(n, np.log(1 / a), np.float32)
                + 0.1 * f32(n), "advantages": f32(n), "returns": f32(n)}

    def impala_batch(T=32, N=128, d=100, a=3):
        dones = rng.random((T, N)) < 0.05
        return {"obs": f32(T, N, d), "next_obs": f32(T, N, d),
                "actions": rng.integers(0, a, (T, N)),
                "behavior_logits": f32(T, N, a), "rewards": f32(T, N),
                "dones": dones, "terminateds": dones & (rng.random((T, N))
                                                        < 0.5)}

    def q_batch(lead, d=4, a=2):
        return {"obs": f32(*lead, d), "next_obs": f32(*lead, d),
                "actions": rng.integers(0, a, lead), "rewards": f32(*lead),
                "dones": (rng.random(lead) < 0.05).astype(np.float32)}

    def sac_batch(U=4, B=4096):
        return {"obs": f32(U, B, 3), "next_obs": f32(U, B, 3),
                "actions": rng.uniform(-2, 2, (U, B)).astype(np.float32),
                "rewards": f32(U, B),
                "dones": np.zeros((U, B), np.float32)}

    def bc_batch(n=4096):
        b = ppo_batch(n, 4, 2)
        return {"obs": b["obs"], "actions": b["actions"],
                "returns": b["returns"]}

    cnn = lambda: rl_module.CNNModule(catch, 3)   # noqa: E731
    qmlp = lambda: rl_module.QMLPModule(4, 2)     # noqa: E731
    mlp = lambda: rl_module.MLPModule(4, 2)       # noqa: E731
    perm_rng = np.random.default_rng(17)
    ppo_perms = lambda: np.stack([perm_rng.permutation(4096)  # noqa: E731
                                  for _ in range(10)]).reshape(10, 8, 512)
    noise = lambda: rng.normal(size=(4, 2, 4096, 1)).astype(  # noqa: E731
        np.float32)

    def seq_batch(B=8, L=16, d=4, a=2):
        first = (rng.random((B, L)) < 0.05).astype(np.float32)
        first[:, 0] = 1.0
        return {"obs": f32(B, L, d), "actions": rng.integers(0, a, (B, L)),
                "rewards": f32(B, L),
                "dones": (rng.random((B, L)) < 0.05).astype(np.float32),
                "is_first": first}

    def gumbel(*s):
        u = rng.uniform(np.finfo(np.float32).tiny, 1.0, s)
        return (-np.log(-np.log(u))).astype(np.float32)

    # the reference's defaults: 8 x 8 latents, horizon 10, 64 starts
    dreamer_noise = lambda: {  # noqa: E731
        "post": gumbel(16, 8, 8, 8), "act": gumbel(10, 64, 2),
        "prior": gumbel(10, 64, 8, 8), "pick": rng.permutation(128)[:64]}
    return {
        "PPO (CNN, Catch)": (
            lambda d, p: learner.PPOLearner(cnn(), minibatch_size=512,
                                            device=d, params=p),
            ppo_batch, lambda lrn, b, x: lrn.update(b, perms=x), ppo_perms,
            80, 3e-4),
        "IMPALA (CNN, Catch)": (
            lambda d, p: impala.ImpalaLearner(cnn(), device=d, params=p),
            impala_batch, lambda lrn, b, x: lrn.update(b), None, 1, 6e-4),
        "APPO (CNN, Catch)": (
            lambda d, p: appo.AppoLearner(cnn(), lr=3e-4, device=d,
                                          params=p),
            impala_batch, lambda lrn, b, x: lrn.update(b), None, 1, 3e-4),
        "DQN (QMLP, CartPole)": (
            lambda d, p: dqn.DQNLearner(qmlp(), device=d, params=p),
            lambda: q_batch((4, 4096)),
            lambda lrn, b, x: {"loss": lrn.update_many(b)[0]}, None, 4,
            1e-3),
        "CQL (QMLP, CartPole)": (
            lambda d, p: offline.CQLLearner(qmlp(), device=d, params=p),
            lambda: q_batch((4096,)),
            lambda lrn, b, x: {"loss": lrn.update(b)}, None, 1, 1e-3),
        "BC (MLP, CartPole)": (
            lambda d, p: offline.BCLearner(mlp(), device=d, params=p),
            bc_batch, lambda lrn, b, x: {"loss": lrn.update(b)}, None, 1,
            1e-3),
        "MARWIL (MLP, CartPole)": (
            lambda d, p: offline.MARWILLearner(mlp(), device=d, params=p),
            bc_batch, lambda lrn, b, x: {"loss": lrn.update(b)}, None, 1,
            1e-3),
        "SAC (Pendulum)": (
            lambda d, p: sac.SACLearner(
                rl_module.SquashedGaussianModule(3, 1, -2.0, 2.0),
                rl_module.TwinQModule(3, 1), device=d, params=p),
            sac_batch, lambda lrn, b, x: lrn.update_many(b, noise=x), noise,
            4, 3e-4),
        "DreamerV3 (CartPole)": (
            lambda d, p: dreamer.DreamerV3Learner(4, 2, device=d, params=p),
            # imag_return is held out: near 0 it is a cancellation of
            # +-15 bins, whose last bits a relative limit cannot hold
            seq_batch, lambda lrn, b, x: {
                k: v for k, v in lrn.update(b, noise=x).items()
                if k != "imag_return"}, dreamer_noise, 1, 4e-4),
    }


def _rl_params(lrn):
    """A learner's weights as the tree its ``params=`` takes."""
    from ray_tpu_torch.rllib.rl_module import to_numpy

    if hasattr(lrn, "critic"):
        return {"pi": to_numpy(lrn.actor), "q": to_numpy(lrn.critic)}
    if hasattr(lrn, "wm"):
        return {"wm": to_numpy(lrn.wm), "ac": to_numpy(lrn.ac)}
    return to_numpy(lrn.module)


def _rl_state(lrn) -> dict:
    """Every trained tensor of a learner, by dotted path."""
    from ray_tpu_torch.rllib.rl_module import tree_leaves

    state = tree_leaves(_rl_params(lrn))
    for name in ("log_alpha", "ret_lo", "ret_hi"):
        if hasattr(lrn, name):
            state[name] = getattr(lrn, name).detach().cpu().numpy()
    return state


def _rl_copy_state(dst, src) -> None:
    """Set learner ``dst`` to ``src``'s state across devices: every
    network, optimizer (moments and step count), trained tensor and
    counter. The state dicts are copied first, so that the two learners
    share no tensor (a CPU optimizer would otherwise adopt the other's
    step tensor)."""
    import copy

    for name, val in vars(src).items():
        if isinstance(val, (torch.nn.Module, torch.optim.Optimizer)):
            getattr(dst, name).load_state_dict(
                copy.deepcopy(val.state_dict()))
        elif isinstance(val, torch.Tensor):
            with torch.no_grad():
                getattr(dst, name).copy_(val)
        elif isinstance(val, (int, float)) and not isinstance(val, bool):
            setattr(dst, name, val)


def _rl_grads(lrn) -> dict:
    """Attach a hook keeping the first gradients of each kind."""
    from ray_tpu_torch.rllib.rl_module import tree_leaves

    store = {}

    def hook(kind, g):
        store.setdefault(kind, tree_leaves(g))
    lrn.grad_hook = hook
    return store


def rl_phase(dev) -> dict:
    """10: each learner built on the card and on the CPU from the same
    parameters, 3 updates on the same seeded batches (and the same
    permutations or noise): the first gradients agree, and so do the
    parameters after the 3 updates; the losses agree update by update,
    each against a CPU learner that starts that update from the card
    learner's state; ms per update on the card.

    Why the losses are held update by update: two devices round
    differently, and a free-running trajectory amplifies that. A weight
    whose gradient is within rounding of zero takes Adam steps of up to
    lr whose sign the rounding picks, and a PPO sample whose ratio lies
    within rounding of 1 +- clip switches the branch of the clipped
    surrogate. Over PPO's 240 optimizer steps (3 updates of 80) such
    events move its third update's losses past rtol 1e-4 while the
    parameters stay inside their bound; the free-running difference is
    printed beside the held one. cuDNN runs its deterministic
    algorithms here, so that two runs of the phase read the same
    numbers."""
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    for name, (make, make_batch, call, extra, steps, lr) in \
            _rl_cases().items():
        params = _rl_params(make("cpu", None))
        batches = [make_batch() for _ in range(3)]
        extras = [extra() if extra else None for _ in range(3)]
        torch.backends.cudnn.deterministic = True
        lrns = {"card": make(dev, params), "cpu": make("cpu", params)}
        anchor = make("cpu", params)
        grads = {d: _rl_grads(lrns[d]) for d in lrns}
        loss_err = free_err = 0.0
        for u, (b, x) in enumerate(zip(batches, extras)):
            _rl_copy_state(anchor, lrns["card"])
            mc = call(lrns["card"], b, x)
            mp = call(anchor, b, x)
            mf = call(lrns["cpu"], b, x)
            for k in mp:
                loss_err = max(loss_err, abs(mc[k] - mp[k])
                               / max(abs(mp[k]), 1e-30))
                free_err = max(free_err, abs(mc[k] - mf[k])
                               / max(abs(mf[k]), 1e-30))
                check(abs(mc[k] - mp[k]) <= 1e-4 * abs(mp[k]),
                      f"{name}: update {u + 1} {k} {mc[k]} on the card, "
                      f"{mp[k]} on the CPU from the same state")
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = deterministic
        grad_err = 0.0
        for kind in grads["cpu"]:
            for leaf, want in grads["cpu"][kind].items():
                got = grads["card"][kind][leaf]
                d = np.abs(got - want)
                grad_err = max(grad_err, float(d.max()))
                check(bool((d <= 1e-5 + 1e-4 * np.abs(want)).all()),
                      f"{name}: first {kind} gradient {leaf} differs by "
                      f"{float(d.max()):.3e}")
        sc, sp = _rl_state(lrns["card"]), _rl_state(lrns["cpu"])
        bound = 0.2 * lr * steps * 3
        param_err = max(float(np.abs(sc[k] - sp[k]).max()) for k in sp)
        check(param_err <= bound, f"{name}: parameters differ by "
              f"{param_err:.3e} after 3 updates (bound {bound:.3e})")
        # ms per update on the card: median of 10 after 2 warm-ups
        lrn = lrns["card"]
        lrn.grad_hook = None
        times = []
        for i in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(lrn, batches[i % 3], extras[i % 3])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times[2:])
        print(f"  {name}: card vs CPU over 3 updates ({steps} optimizer "
              f"steps each): max rel |d loss| {loss_err:.3e} update by "
              f"update ({free_err:.3e} free-running, printed only), "
              f"first-grad "
              f"max|d| {grad_err:.3e}, params max|d| {param_err:.3e} "
              f"(bound {bound:.3e}); {ms:.3f} ms per update on the card",
              flush=True)
        out[name] = ms
        del lrns, lrn, anchor
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- phase 11

MESH_STEPS = 2   # loss + backward steps of each phase-11 run
# ring at bf16 compute against its mesh-free math: at this shape the bf16
# gradients of two correct attention implementations differ by about 2e-2
# of a leaf's largest value (phase 11 prints the flash kernels' spread
# against ring's math: 2.348e-02 on an H100 80GB HBM3 at 700 W, where ring
# reads 1.818e-02), so the limit sits above that spread
RING_BF16_TOL = 3e-2


def _grad_tree(params) -> dict:
    """Each param leaf's gradient, whole (a DTensor's ``full_tensor()``)."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models.llama import param_leaves

    return {n: (p.grad.full_tensor() if isinstance(p.grad, DTensor)
                else p.grad).detach() for n, p in param_leaves(params)}


def _spread(grads: dict, ref_grads: dict) -> float:
    """The worst leaf's max|dg| / max|g| of two gradient trees."""
    worst = 0.0
    for name, want in ref_grads.items():
        got = grads[name].to(want.device).float()
        scale = float(want.float().abs().max()) or 1.0
        worst = max(worst, float((got - want.float()).abs().max()) / scale)
    return worst


def _mesh_run(what, loss_fn, params, ref=None, tol=2e-2,
              keep=False) -> tuple:
    """``MESH_STEPS`` steps of ``loss_fn().backward()`` on ``params``:
    (last loss, ms a step (median of steps 2 on), the launch counters of
    all steps, and with ``keep`` the last step's gradients on the host).
    With ``ref`` (loss, host gradients of a mesh-free run), the loss and
    every gradient leaf are held to it at atol/rtol ``tol`` (atol scaled
    by the leaf's largest value)."""
    from ray_tpu_torch.models.llama import param_leaves

    leaves = [p for _, p in param_leaves(params)]
    walls = []
    counters_reset()
    for _ in range(MESH_STEPS):
        for p in leaves:
            p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_fn(params)
        loss.backward()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    runs = counters()
    loss = loss.item()
    ms = statistics.median(walls[1:]) * 1e3
    grads = _grad_tree(params)
    line = f"  {what}: loss {loss:.6f}, {ms:.1f} ms a step"
    if ref is not None:
        ref_loss, ref_grads = ref
        ok, _ = close(torch.tensor(loss), torch.tensor(ref_loss), tol, tol)
        check(ok and np.isfinite(loss),
              f"{what}: loss {loss} against the mesh-free {ref_loss}")
        worst = 0.0
        for name, want in ref_grads.items():
            want = want.to(grads[name].device)
            scale = float(want.float().abs().max()) or 1.0
            ok, err = close(grads[name], want, tol * scale, tol)
            check(ok, f"{what}: gradient {name} off by {err} (max "
                      f"{scale})")
            worst = max(worst, err / scale)
        line += (f"; loss - mesh-free {loss - ref_loss:+.3e}, worst gradient "
                 f"leaf max|dg|/max|g| {worst:.3e}")
    grads = {k: v.cpu() for k, v in grads.items()} if keep else None
    for p in leaves:
        p.grad = None
    print(line + f"; launches {runs}", flush=True)
    return loss, ms, runs, grads


def mesh_phase(dev) -> dict:
    """11: the parallel layer at world size 1 over NCCL (one card cannot
    hold two ranks of one communicator), full width: phase 5's Llama-3-8B
    width, 8 layers, 4 x 2048 (fp32 params, bf16 compute, full remat),
    ``loss_fn(mesh={fsdp 1, sp 1, tp 1})`` with Ulysses (the wgmma flash
    kernels on the local heads) and with ring attention, ``loss_fn_pp``
    at pp 1 with 4 microbatches, then Mixtral-8x7B width with 2 layers
    under {dp 1, ep 1}. Each run's loss and gathered gradients are held
    to the mesh-free run on the same weights with the same attention
    math (the flash kernels; for ring, attention in fp32 at fp32 and at
    bf16 compute); ms a step (loss and backward) beside the mesh-free
    step. Returns the sharded runs' flash launches (the Ulysses,
    pipeline and Mixtral runs)."""
    import tempfile
    from dataclasses import replace
    from unittest import mock

    import torch.distributed as dist

    from ray_tpu_torch.models import llama, mixtral
    from ray_tpu_torch.ops.attention import attention_reference
    from ray_tpu_torch.parallel import (MeshSpec, build_mesh,
                                        device_put_sharded,
                                        init_process_group)
    from ray_tpu_torch.tools import profile_train as run

    def place(mod, cfg, params, axes):
        mesh = build_mesh(MeshSpec(axes))
        placed = device_put_sharded(_detached(params),
                                    mod.param_shardings(cfg, mesh))
        for _, p in llama.param_leaves(placed):
            p.requires_grad_()
        return mesh, placed

    total = {"fwd_sm90": 0, "dq_sm90": 0, "dkv_sm90": 0}

    def count(runs, want_fwd, want_bwd, what):
        check(runs["fwd"] == runs["fwd_sm90"] == want_fwd and
              runs["dq"] == runs["dq_sm90"] == want_bwd and
              runs["dkv"] == runs["dkv_sm90"] == want_bwd,
              f"{what}: flash launches {runs}, want {want_fwd} forward and "
              f"{want_bwd} dQ and dK/dV, all on the wgmma route")
        for k in total:
            total[k] += runs[k]

    with tempfile.TemporaryDirectory() as store:
        init_process_group(0, 1, dev, store_path=os.path.join(store, "pg"))
        try:
            cfg, params, opt, toks = run.build_train_run(dev)
            del opt
            L, steps = cfg.num_layers, MESH_STEPS
            batch = {"tokens": toks}
            print(f"  world size {dist.get_world_size()} over "
                  f"{dist.get_backend()}; Llama-3-8B width, {L} layers, "
                  f"batch {toks.shape[0]} x {toks.shape[1] - 1}", flush=True)
            ref_loss, ref_ms, _, grads = _mesh_run(
                "mesh-free", lambda p: llama.loss_fn(cfg, p, batch), params,
                keep=True)
            ref = (ref_loss, grads)
            mesh, placed = place(llama, cfg, params,
                                 {"fsdp": 1, "sp": 1, "tp": 1})
            ucfg = replace(cfg, attn_impl="ulysses")
            _, ms, runs, _ = _mesh_run(
                "ulysses on {fsdp 1, sp 1, tp 1}",
                lambda p: llama.loss_fn(ucfg, p, batch, mesh=mesh), placed,
                ref)
            count(runs, 2 * L * steps, L * steps, "ulysses")
            print(f"  ulysses: {ms:.1f} ms a step against the mesh-free "
                  f"{ref_ms:.1f}", flush=True)
            M = 4
            pmesh, pplaced = place(llama, cfg, params, {"pp": 1})
            _, ms, runs, _ = _mesh_run(
                f"loss_fn_pp at pp 1, {M} microbatches",
                lambda p: llama.loss_fn_pp(cfg, p, batch, pmesh, M), pplaced,
                ref)
            count(runs, 2 * L * M * steps, L * M * steps, "pipeline")
            print(f"  pipeline: {ms:.1f} ms a step against the mesh-free "
                  f"{ref_ms:.1f}", flush=True)
            del pplaced
            # ring keeps its probabilities in fp32, as the reference's ring
            # does (tests/test_torch_seqpar.py holds the two together in
            # bf16), where the flash kernels and attention_reference round
            # them to bf16 for the value product. So ring is held to
            # mesh-free runs of its own math: attention_reference on q/k/v
            # upcast to fp32, its output rounded to the compute dtype; at
            # fp32 compute to 1e-4 of each leaf's largest value (phase 4's
            # limit), at bf16 compute to RING_BF16_TOL, beside the spread
            # between the flash run and that math.
            def fp32_attention(q, k, v, causal=True):
                return attention_reference(q.float(), k.float(), v.float(),
                                           causal).to(q.dtype)

            cfg32 = replace(cfg, dtype=torch.float32)
            for what, rcfg, tol in (("fp32 compute", cfg32, 1e-4),
                                    ("bf16 compute", cfg, RING_BF16_TOL)):
                fcfg = replace(rcfg, attn_impl="reference")
                with mock.patch.object(llama, "attention_reference",
                                       fp32_attention):
                    ref_loss, fref_ms, _, grads = _mesh_run(
                        f"mesh-free, {what}, attention in fp32",
                        lambda p: llama.loss_fn(fcfg, p, batch), params,
                        keep=True)
                if rcfg.dtype == torch.bfloat16:
                    print(f"  flash against attention in fp32, bf16 compute: "
                          f"loss {ref[0] - ref_loss:+.3e}, worst gradient "
                          f"leaf max|dg|/max|g| "
                          f"{_spread(ref[1], grads):.3e}", flush=True)
                rcfg = replace(rcfg, attn_impl="ring")
                _, ms, runs, _ = _mesh_run(
                    f"ring on {{fsdp 1, sp 1, tp 1}}, {what}",
                    lambda p: llama.loss_fn(rcfg, p, batch, mesh=mesh),
                    placed, (ref_loss, grads), tol=tol)
                check(runs["fwd"] == runs["dq"] == 0,
                      f"ring launched flash kernels: {runs}")
                print(f"  ring, {what}: {ms:.1f} ms a step against the "
                      f"mesh-free {fref_ms:.1f} (attention in fp32) and "
                      f"{ref_ms:.1f} (flash)", flush=True)
                del grads
            del placed, params, ref
            gc.collect()
            torch.cuda.empty_cache()

            mcfg = mixtral.MixtralConfig.mixtral_8x7b(num_layers=2)
            mparams = mixtral.init_params(mcfg, seed=0, device=dev)
            for _, p in llama.param_leaves(mparams):
                p.requires_grad_()
            mtoks = torch.from_numpy(np.random.default_rng(0).integers(
                0, mcfg.vocab_size, (4, 2049))).to(dev)
            mbatch = {"tokens": mtoks}
            ref_loss, ref_ms, _, grads = _mesh_run(
                "Mixtral-8x7B width, 2 layers, mesh-free",
                lambda p: mixtral.loss_fn(mcfg, p, mbatch), mparams,
                keep=True)
            ref = (ref_loss, grads)
            mesh, placed = place(mixtral, mcfg, mparams, {"dp": 1, "ep": 1})
            _, ms, runs, _ = _mesh_run(
                "Mixtral on {dp 1, ep 1}",
                lambda p: mixtral.loss_fn(mcfg, p, mbatch, mesh=mesh),
                placed, ref)
            count(runs, 2 * mcfg.num_layers * steps,
                  mcfg.num_layers * steps, "Mixtral")
            print(f"  Mixtral: {ms:.1f} ms a step against the mesh-free "
                  f"{ref_ms:.1f}", flush=True)
            del placed, mparams, ref
        finally:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ------------------------------------------------------------- phase 12


def tp_serve_phase(dev, phase3: dict) -> dict:
    """12: tensor-parallel serving at world size 1 over NCCL (one card
    cannot hold two ranks of one communicator: multi-rank serving is held
    on the CPU by tests/test_torch_tp_serve.py). Phase 3's Llama-3-8B bf16
    weights (seed 0) and requests through both engines with
    ``mesh={tp 1}``: the same greedy tokens as phase 3's mesh-free
    engines request by request, the same kernel launches on the same
    routes, TTFT and ITL beside phase 3's, and the engine's memory on top
    of the weights below a second copy of them. ``LLMEngine(tp=2)`` on
    one card raises the reference's ValueError. Returns the launches."""
    import tempfile

    import torch.distributed as dist

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.parallel import init_process_group
    from ray_tpu_torch.serve.llm_engine import LLMEngine
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

    n = torch.cuda.device_count()
    try:
        LLMEngine(tp=n + 1, device=dev)
        check(False, f"LLMEngine(tp={n + 1}) on {n} card(s) did not raise")
    except ValueError as e:
        want = f"tp={n + 1} needs {n + 1} devices, found {n}"
        check(str(e) == want, f"LLMEngine(tp={n + 1}): {e!r}, want {want!r}")
        print(f"  LLMEngine(tp={n + 1}) on {n} card(s): ValueError({e})",
              flush=True)
    cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                      param_dtype=torch.bfloat16)
    params = llama.init_params(cfg, seed=0, device=dev)
    weights = sum(p.numel() * p.element_size()
                  for _, p in llama.param_leaves(params))
    first, last = serve_8b_requests(cfg.vocab_size)
    out_launches = {}
    with tempfile.TemporaryDirectory() as store:
        init_process_group(0, 1, dev, store_path=os.path.join(store, "pg"))
        try:
            mesh = build_mesh(MeshSpec({"tp": 1}))
            kw = dict(SERVE_8B, params=params, device=dev, mesh=mesh)
            for name, make in (("dense", lambda: LLMEngine(**kw)),
                               ("paged", lambda: PagedLLMEngine(
                                   page_size=64, **kw))):
                torch.cuda.synchronize()
                gc.collect()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                counters_reset()
                eng = make()
                check(hasattr(eng._params["embed"], "placements"),
                      f"{name}: the engine's weights are not DTensors")
                out = drain(eng, first, 300)
                out.update(drain(eng, last, 120))
                stop(eng)
                c = counters()
                peak = torch.cuda.max_memory_allocated() - base
                del eng
                want = phase3[name]
                for rid, res in out.items():
                    check(res["tokens"] == want["tokens"][rid],
                          f"{name} mesh={{tp 1}} {rid}: tokens differ from "
                          f"phase 3's")
                check(c["paged_merge"] == c["paged"]
                      and c["fwd_sm90"] == c["fwd"],
                      f"{name} mesh={{tp 1}}: launches {c}")
                got = (c["fwd"], c["paged"])
                check(got == want["launches"],
                      f"{name} mesh={{tp 1}}: flash and paged launches "
                      f"{got}, phase 3 {want['launches']}")
                check(peak < weights,
                      f"{name} mesh={{tp 1}}: {peak / 2**30:.2f} GiB on top "
                      f"of the weights, a second copy is "
                      f"{weights / 2**30:.2f}")
                lat, ref = _latency_ms(out), want["lat"]
                print(f"  8B {name} mesh={{tp 1}}: tokens equal phase 3's for "
                      f"8/8 requests; flash launches {got[0]} (wgmma "
                      f"{c['fwd_sm90']}), paged launches {got[1]}; TTFT "
                      f"p50/p99 {lat['ttft_p50']:.2f}/{lat['ttft_p99']:.2f} "
                      f"ms (phase 3 {ref['ttft_p50']:.2f}/"
                      f"{ref['ttft_p99']:.2f}), ITL p50/p99 "
                      f"{lat['itl_p50']:.3f}/{lat['itl_p99']:.3f} ms (phase 3 "
                      f"{ref['itl_p50']:.3f}/{ref['itl_p99']:.3f}); peak "
                      f"{peak / 2**30:.2f} GiB on top of the "
                      f"{weights / 2**30:.2f} GiB of weights", flush=True)
                out_launches[name] = got
        finally:
            dist.destroy_process_group()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention_fwd": out_launches["dense"][0],
            "paged_attention": out_launches["paged"][1]}


# ---------------------------------------------------------------- phase 13


def _leaf_sums(tree, prefix="") -> dict:
    """{leaf path: the sum of the leaf's bytes read as integers of its
    element size} of every tensor leaf (the int64 sum of int32 words for
    fp32, of int16 words for bf16)."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_sums(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            words = v.detach().reshape(-1).view(ints[v.element_size()])
            out[prefix + k] = int(words.sum(dtype=torch.int64))
    return out


def _train_state(params, opt) -> dict:
    """Phase 5's run state as one tree: the params and AdamW's moments
    and step counts, keyed by the params' leaf names."""
    from ray_tpu_torch.models import llama

    leaves = llama.param_leaves(params)
    st = opt.state
    return {"params": {n: p.detach() for n, p in leaves},
            "exp_avg": {n: st[p]["exp_avg"] for n, p in leaves},
            "exp_avg_sq": {n: st[p]["exp_avg_sq"] for n, p in leaves},
            "adam_step": {n: st[p]["step"] for n, p in leaves}}


def _tree_bytes(tree) -> int:
    return sum(_tree_bytes(v) if isinstance(v, dict) else
               v.numel() * v.element_size() for v in tree.values()
               if isinstance(v, (dict, torch.Tensor)))


def _nested(flat: dict) -> dict:
    """``{"layers.wq": t}`` -> ``{"layers": {"wq": t}}``."""
    tree: dict = {}
    for name, leaf in flat.items():
        *head, last = name.split(".")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def _empty_like_tree(tree, dev) -> dict:
    return {k: _empty_like_tree(v, dev) if isinstance(v, dict) else
            (torch.empty(v[0], dtype=v[1], device=v[2] if v[2] == "cpu"
                         else dev) if isinstance(v, tuple) else None)
            for k, v in tree.items()}


def _tree_meta(tree) -> dict:
    """(shape, dtype, device type) of every tensor leaf; other leaves as
    they are."""
    return {k: _tree_meta(v) if isinstance(v, dict) else
            ((tuple(v.shape), v.dtype, v.device.type)
             if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


# phase 13(a)'s depth: at phase 5's 8 layers the state is 33.55 GB, and on
# an H100 80GB HBM3 at 700 W its save and restore took 88 s of a whole run
# of 1140.6 s (1200 s allowed); at 2 layers, 17.84 GB and 35 s
CKPT_LAYERS = 1


def checkpoint_phase(dev) -> dict:
    """13(a) and (b): phase 5's run (``profile_train.build_train_run``
    at ``CKPT_LAYERS`` layers, 5 AdamW steps) is saved with ``train.dist_checkpoint.save`` (params
    and AdamW state, or the params alone when the temporary directory
    cannot hold both), freed, and restored into fresh tensors on the
    card: every leaf's checksum and the step-6 loss must be those from
    before the save, bit for bit. Then ``TorchPredictor.from_checkpoint``
    over the same checkpoint (the params restored onto the card) runs
    ``llama.forward`` on 8 x 512 tokens: its argmax equals the in-memory
    forward's, through the wgmma flash forward. Returns the launches."""
    import shutil
    import tempfile

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.tools import profile_train as run
    from ray_tpu_torch.train import dist_checkpoint as dc
    from ray_tpu_torch.train.predictor import TorchPredictor

    gc.collect()
    torch.cuda.empty_cache()
    counters_reset()
    cfg, params, opt, toks = run.build_train_run(
        dev, cfg=llama.LlamaConfig.llama3_8b(num_layers=CKPT_LAYERS))
    for _ in range(5):
        run.train_step(cfg, params, opt, toks)
    opt.zero_grad(set_to_none=True)
    batch = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (8, 512))).to(dev)
    with torch.no_grad():
        loss6 = llama.loss_fn(cfg, params, {"tokens": toks}).item()
        want_argmax = llama.forward(cfg, params, batch).argmax(-1)
    state = _train_state(params, opt)
    state["step"] = 5
    sums = _leaf_sums(state)
    meta = _tree_meta(state)
    state_bytes = _tree_bytes(state)
    param_bytes = _tree_bytes(state["params"])
    tmp = tempfile.mkdtemp(prefix="rtpu_ckpt_")
    free = shutil.disk_usage(tmp).free
    whole = free > 1.1 * state_bytes + (1 << 30)
    print(f"  checkpoint directory {tmp}: {free / 1e9:.1f} GB free; the "
          f"state (params and AdamW) is {state_bytes / 1e9:.2f} GB, the "
          f"params {param_bytes / 1e9:.2f} GB: saving "
          f"{'both' if whole else 'the params alone'}", flush=True)
    check(whole or free > 1.1 * param_bytes + (1 << 30),
          "the temporary directory cannot hold the params")
    if not whole:
        state = {"params": state["params"], "step": 5}
        meta = _tree_meta(state)
        sums = {k: v for k, v in sums.items() if k.startswith("params.")}
    path = os.path.join(tmp, "ck")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dc.save(path, state)
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        del state, params, opt
        gc.collect()
        torch.cuda.empty_cache()
        like = _empty_like_tree(meta, dev)
        like["step"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = dc.restore(path, like=like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got = _leaf_sums(back)
        bad = [k for k in sums if got.get(k) != sums[k]]
        check(not bad and set(got) == set(sums),
              f"restored checksums differ on {len(bad)} leaves: {bad[:4]}")
        check(back["step"] == 5, f"restored step {back['step']!r}")
        restored = _nested(back["params"])
        with torch.no_grad():
            loss6_back = llama.loss_fn(cfg, restored,
                                       {"tokens": toks}).item()
        print(f"  saved {size / 1e9:.2f} GB in {save_s:.2f} s "
              f"({size / 1e9 / save_s:.2f} GB/s), restored in "
              f"{restore_s:.2f} s ({size / 1e9 / restore_s:.2f} GB/s) to "
              f"the card; {len(got)} leaf checksums equal; step-6 loss "
              f"{loss6_back!r} from the restore, {loss6!r} before the save",
              flush=True)
        check(loss6_back == loss6, "the step-6 loss from the restored state "
              "differs from the one before the save")
        del back, like, restored
        gc.collect()
        torch.cuda.empty_cache()
        # (b) the predictor over the same checkpoint
        pmeta = {"params": meta["params"]}

        def load_params(p):
            return _nested(dc.restore(
                p, like=_empty_like_tree(pmeta, dev))["params"])

        pred = TorchPredictor.from_checkpoint(
            path, lambda p, x: llama.forward(cfg, p, x),
            load_params=load_params, device=dev)
        host = {"data": batch.cpu().numpy()}
        pred.predict(host)   # warm-up
        before = counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pred.predict(host)
        predict_s = time.perf_counter() - t0
        c = counters()
        fwd = c["fwd"] - before["fwd"]
        fwd_sm90 = c["fwd_sm90"] - before["fwd_sm90"]
        same = bool(np.array_equal(out["predictions"].argmax(-1),
                                   want_argmax.cpu().numpy()))
        print(f"  TorchPredictor over the checkpoint: 8 x 512 tokens in "
              f"{predict_s * 1e3:.1f} ms (logits to host numpy included); "
              f"argmax equal to the in-memory forward's: {same}; flash "
              f"forward launches {fwd} (wgmma {fwd_sm90})", flush=True)
        check(same, "the predictor's argmax differs from the in-memory "
              "forward's")
        check(fwd == cfg.num_layers and fwd_sm90 == fwd,
              f"predict launched the flash forward {fwd} times, {fwd_sm90} "
              f"on the wgmma route; want {cfg.num_layers}, all wgmma")
        del pred, out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    c = counters()
    check(c["fwd_sm90"] == c["fwd"] and c["dq_sm90"] == c["dq"]
          and c["dkv_sm90"] == c["dkv"], f"phase 13 launches off the wgmma "
          f"route: {c}")
    return {"flash_attention_fwd": c["fwd"],
            "flash_attention_bwd_dq": c["dq"],
            "flash_attention_bwd_dkv": c["dkv"]}


def tp_disagg_phase(dev, phase9a: dict, phase9b: dict) -> dict:
    """13(c): at world size 1 over NCCL, phase 9's disaggregated engine
    (2 workers, divert floor 128) with ``mesh={tp 1}``: in fp32 at 2
    layers it gives phase 9(a)'s paged tokens for 8/8 requests, every
    prompt of 128 tokens or more handed off, no page leaked; in bf16 at
    32 layers (phase 3's weights and requests) TTFT and ITL beside
    9(b)'s, and how many transcripts equal 9(b)'s (printed: bf16
    disaggregated transcripts differ between runs, the two workers
    racing for q7 among the causes). Then q1's pages exported from one
    ``mesh={tp 1}`` bf16 paged engine and imported into another, where
    q7 hits them (128 tokens) and decodes the exporter's q7 tokens.
    Returns the paged launches."""
    import tempfile
    from dataclasses import replace

    import torch.distributed as dist

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.parallel import init_process_group
    from ray_tpu_torch.serve.disagg import DisaggPagedEngine
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine
    from ray_tpu_torch.tools.serve_latency import _log_chunks, _parting

    paged = 0
    with tempfile.TemporaryDirectory() as store:
        init_process_group(0, 1, dev, store_path=os.path.join(store, "pg"))
        try:
            mesh = build_mesh(MeshSpec({"tp": 1}))
            dkw = dict(prefill_workers=2, divert_min_tokens=128,
                       handoff_timeout_s=CLEAN_LEASE_S, device=dev,
                       mesh=mesh, page_size=64)
            cfg = replace(llama.LlamaConfig.llama3_8b(), num_layers=2,
                          dtype=torch.float32, param_dtype=torch.float32)
            params = llama.init_params(cfg, seed=0, device=dev)
            first, last = serve_8b_requests(cfg.vocab_size)
            n_div = sum(len(p) >= 128 for _, p in first + last)
            counters_reset()
            eng = DisaggPagedEngine(**dict(SERVE_8B, **dkw,
                                           model_config=_model_config(cfg),
                                           params=params))
            out = drain(eng, first, 120)
            out.update(drain(eng, last, 120))
            st = eng.stats()
            _stop_disagg(eng)
            _check_disagg(st, n_div, "fp32 disagg mesh={tp 1}")
            _check_pool(eng, "fp32 disagg mesh={tp 1}")
            del eng, params
            paged += counters()["paged"]
            equal = sum(out[r]["tokens"] == phase9a[r] for r in phase9a)
            print(f"  fp32 2-layer disagg mesh={{tp 1}}: tokens equal phase "
                  f"9(a)'s paged engine's for {equal}/{len(phase9a)} "
                  f"requests; diverted {st['disagg_diverted']}, handoffs "
                  f"{st['disagg_handoffs']}", flush=True)
            check(equal == len(phase9a), "fp32 disagg mesh={tp 1}: tokens "
                  "differ from phase 9(a)'s paged engine's")
            gc.collect()
            torch.cuda.empty_cache()
            cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                              param_dtype=torch.bfloat16)
            params = llama.init_params(cfg, seed=0, device=dev)
            kw = dict(SERVE_8B, params=params, device=dev, mesh=mesh,
                      page_size=64)
            counters_reset()
            eng = DisaggPagedEngine(params=params, **dict(SERVE_8B, **dkw))
            chunks = _log_chunks(eng)
            out = drain(eng, first, 300)
            out.update(drain(eng, last, 120))
            st = eng.stats()
            log = eng.prefill_log()
            _stop_disagg(eng)
            _check_disagg(st, n_div, "8B bf16 disagg mesh={tp 1}")
            _check_pool(eng, "8B bf16 disagg mesh={tp 1}")
            del eng
            c = counters()
            check(c["paged"] > 0 and c["paged_merge"] == c["paged"],
                  f"disagg mesh={{tp 1}}: paged launches {c}")
            check(all(len(r["tokens"]) == 32 for r in out.values()),
                  "disagg mesh={tp 1}: a request got fewer than 32 tokens")
            paged += c["paged"]
            want = phase9b["disagg"]
            equal = sum(out[r]["tokens"] == want["tokens"][r] for r in out)
            lat, ref = _latency_ms(out), want["latency_ms"]
            print(f"  8B bf16 disagg mesh={{tp 1}}: tokens equal phase "
                  f"9(b)'s disaggregated ones for {equal}/8 requests "
                  f"(printed, not required in bf16; staging-cache reuse "
                  f"{st['disagg_staging_hit_tokens']} tokens, 9(b) "
                  f"{want['staging_hit']}); prefill worker/hit tokens "
                  f"{_prefill_log_line(log)} (9(b) "
                  f"{_prefill_log_line(want['prefill_log'])}); TTFT p50/p99 "
                  f"{lat['ttft_p50']:.2f}/{lat['ttft_p99']:.2f} ms (9(b) "
                  f"{ref['ttft_p50']:.2f}/{ref['ttft_p99']:.2f}), ITL "
                  f"p50/p99 {lat['itl_p50']:.3f}/{lat['itl_p99']:.3f} ms "
                  f"(9(b) {ref['itl_p50']:.3f}/{ref['itl_p99']:.3f}); "
                  f"paged launches {c['paged']}", flush=True)
            # where each other transcript parts from 9(b)'s, and the
            # decode chunk that produced that token in each run
            got = {"tokens": {r: v["tokens"] for r, v in out.items()},
                   "chunks": chunks}
            for r in sorted(out):
                if out[r]["tokens"] != want["tokens"][r]:
                    print(f"  8B bf16 disagg mesh={{tp 1}}: "
                          f"{_parting(want, got, r)}", flush=True)
            # export from one mesh={tp 1} engine, import into another
            counters_reset()
            src = PagedLLMEngine(**kw)
            drain(src, first[1:2], 120)
            alloc = src._alloc
            q1 = first[1][1]
            pages, hashes, _ = alloc.match_prefix(q1, len(q1))
            k, v = src.export_pages(pages)
            for pg in pages:
                alloc.release(pg)
            want_q7 = drain(src, last, 120)["q7"]["tokens"]
            hit_src = src._prefix_hit_tokens
            stop(src)
            dst = PagedLLMEngine(**kw)
            n_imp = dst.import_pages(k, v, hashes)
            got_q7 = drain(dst, last, 120)["q7"]["tokens"]
            hit_dst = dst._prefix_hit_tokens
            stop(dst)
            _check_pool(dst, "import mesh={tp 1}")
            c = counters()
            paged += c["paged"]
            print(f"  export/import mesh={{tp 1}}: {len(pages)} pages of q1 "
                  f"({tuple(k.shape)} each of k, v) imported {n_imp}; q7's "
                  f"prefix hit {hit_dst} tokens (exporter {hit_src}); tokens "
                  f"equal the exporter's: {got_q7 == want_q7}", flush=True)
            check(n_imp == len(pages) == 2 and hit_dst == hit_src == 128,
                  "export/import mesh={tp 1}: no prefix hit")
            check(got_q7 == want_q7, "export/import mesh={tp 1}: q7's tokens "
                  "differ from the exporter's")
        finally:
            dist.destroy_process_group()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"paged_attention": paged}


# ---------------------------------------------------------------- phase 14


class EngineReplica:
    """Phase 14's GPU actor: one of the port's engines on the card its
    worker was given (``num_gpus=1``: ``CUDA_VISIBLE_DEVICES`` names it),
    driven through actor calls, submit per request and then polls of
    ``collect``, as a replica's router drives one. ``submit`` with
    ``hold`` keeps a request until ``flush`` hands the held wave to the
    engine at once: the dense engine batches what has arrived when it
    wakes (every 2 ms when idle), so requests one actor call apart can
    split phase 3's wave over more prefill batches, whose other GEMM
    shapes round bf16 differently and change tokens. Without ``hold`` a
    request enters the engine as its call arrives. The kernel launch
    counters live in this process, so ``stop`` reports them."""

    def __init__(self, cfg, serve_kw: dict, seed: int, device=None):
        t0 = time.perf_counter()
        from ray_tpu_torch.models import llama

        # device None: the engine's own default, the card or a raise
        self.dev = llama.resolve_device(device)
        self.params = llama.init_params(cfg, seed=seed, device=self.dev)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        self.kw = serve_kw
        self.device = device
        self.eng = self.runs = None
        self.held = []
        self.init_s = time.perf_counter() - t0

    def info(self) -> dict:
        cuda = self.dev.type == "cuda"
        return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "gpu_ids": os.environ.get("RTPU_GPU_IDS"),
                "device_count": torch.cuda.device_count() if cuda else 0,
                "name": torch.cuda.get_device_name(0) if cuda else "cpu",
                "init_s": self.init_s}

    def ping(self) -> int:
        return os.getpid()

    def start(self, kind: str) -> None:
        from ray_tpu_torch.serve.llm_engine import LLMEngine
        from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

        counters_reset()
        kw = dict(self.kw, params=self.params, device=self.device)
        self.eng = (LLMEngine(**kw) if kind == "dense"
                    else PagedLLMEngine(page_size=64, **kw))
        self.runs = _counted(self.eng)

    def submit(self, rid: str, prompt: list, hold: bool = True) -> None:
        if hold:
            self.held.append((rid, prompt))
        else:
            self.eng.submit(rid, prompt)

    def flush(self) -> None:
        for rid, prompt in self.held:
            self.eng.submit(rid, prompt)
        self.held = []

    def collect(self) -> dict:
        if not self.eng._thread.is_alive():
            raise RuntimeError("engine thread died")
        return self.eng.collect()

    def stop(self) -> tuple:
        from ray_tpu_torch.ops import _build

        st = dict(self.eng.stats(), **self.runs)
        self.eng.shutdown()
        self.eng._thread.join(timeout=60)
        if self.eng._thread.is_alive():
            raise RuntimeError("engine thread did not stop")
        self.eng = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return counters(), st, _build.last_build_seconds


def _actor_drain(rt, replica, reqs, timeout_s: float,
                 hold: bool = True) -> dict:
    """Submit each request with its own actor call, flush the wave into
    the engine (``hold``; else each request enters the engine as its
    call arrives), then poll the replica's ``collect`` until every
    request is back."""
    for rid, prompt in reqs:
        replica.submit.remote(rid, prompt, hold)
    if hold:
        rt.get(replica.flush.remote(), timeout=timeout_s)
    out = {}
    deadline = time.monotonic() + timeout_s
    while len(out) < len(reqs) and time.monotonic() < deadline:
        out.update(rt.get(replica.collect.remote(), timeout=timeout_s))
        time.sleep(0.005)
    for rid, _ in reqs:
        check(rid in out, f"request {rid} timed out")
        check(not isinstance(out[rid], Exception),
              f"request {rid} failed: {out[rid]!r}")
    return out


def _in_store(t: torch.Tensor) -> bool:
    import ctypes

    from ray_tpu_torch.core import runtime_context

    mv = runtime_context.get_core().store._mv
    base = ctypes.addressof(ctypes.c_uint8.from_buffer(mv))
    return base <= t.data_ptr() and \
        t.data_ptr() + t.numel() * t.element_size() <= base + mv.nbytes


def runtime_phase(dev, phase3: dict) -> dict:
    """14: the port's own runtime on the card. (a) ``init`` reports the
    card as ``{"GPU": 1}``; a CPU task sees no card; two one-GPU bundles
    stay pending, a two-GPU bundle can never fit, ``num_gpus`` on a task
    raises the actor-scoped ValueError. (b) a 1 GiB bf16 CPU tensor
    through ``put``/``get`` bit for bit, the ``get`` a view into the
    store; a CUDA tensor arrives as a CPU tensor with its bits. (c) an
    actor with ``num_gpus=1`` builds phase 3's weights (seed 0) on its
    card and serves phase 3's requests through the dense and then the
    paged engine, driven through actor calls: phase 3's tokens and
    launches. (d) after ``shutdown`` the card's free memory is back.
    Returns the actor's launches. On the CPU (a rehearsal, with
    ``LlamaConfig.llama3_8b`` and ``SERVE_8B`` patched small) the actor
    runs there and the put moves 64 MiB."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import runtime_context
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.util import placement_group, remove_placement_group

    cuda = dev.type == "cuda"
    cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                      param_dtype=torch.bfloat16)
    first, last = serve_8b_requests(cfg.vocab_size)
    put_bytes = (1 << 30) if cuda else (64 << 20)
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free0 = torch.cuda.mem_get_info()[0]
    shm = os.statvfs("/dev/shm")
    shm_free = shm.f_bavail * shm.f_frsize
    store_bytes = 2 * put_bytes
    print(f"  /dev/shm free {shm_free / 2**30:.2f} GiB; store "
          f"{store_bytes / 2**30:.2f} GiB", flush=True)
    check(shm_free > store_bytes, "/dev/shm cannot hold the object store")
    t0 = time.perf_counter()
    rt.init(num_workers=2, object_store_memory=store_bytes)
    try:
        init_s = time.perf_counter() - t0
        total = runtime_context.get_core().state_summary()[
            "resources"]["total"]
        want_gpus = float(torch.cuda.device_count()) if cuda else None
        check(total.get("GPU") == want_gpus,
              f"init() reports {total}, want GPU {want_gpus}")

        @rt.remote
        def cpu_probe():
            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    torch.cuda.is_available())

        seen = rt.get(cpu_probe.remote(), timeout=120)
        check(seen == ("", False), f"a CPU task sees {seen}")
        if cuda:
            pg = placement_group([{"GPU": 1}, {"GPU": 1}])
            check(not pg.wait(2), "two one-GPU bundles fit one card")
            remove_placement_group(pg)
            try:
                placement_group([{"GPU": 2}])
                check(False, "a two-GPU bundle was accepted on one card")
            except ValueError as e:
                check("never fit" in str(e), f"{{GPU: 2}}: {e!r}")
        try:
            cpu_probe.options(num_gpus=1).remote()
            check(False, "a task with num_gpus=1 was accepted")
        except ValueError as e:
            check("actor-scoped" in str(e), f"num_gpus task: {e!r}")
        print(f"  (a) init in {init_s:.2f} s: {total}; a CPU task sees "
              f"CUDA_VISIBLE_DEVICES={seen[0]!r}, cuda available "
              f"{seen[1]}; GPU bundles beyond the card pend or never fit; "
              f"num_gpus on a task raises", flush=True)

        # (b) objects: random bits (NaN patterns included), compared as
        # int16
        g = torch.Generator().manual_seed(14)
        big = torch.randint(-2**15, 2**15, (put_bytes // 2,),
                            dtype=torch.int16, generator=g)
        t1 = time.perf_counter()
        ref = rt.put(big.view(torch.bfloat16))
        put_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        got = rt.get(ref)
        get_s = time.perf_counter() - t1
        check(got.dtype == torch.bfloat16 and torch.equal(
            got.view(torch.int16), big), "1 GiB bf16: bits differ")
        check(_in_store(got), "1 GiB bf16: the get is not a view into "
                              "the store")
        del got
        rt.free(ref)
        PHASE14_PUT["gbps"] = put_bytes / put_s / 1e9
        line = (f"  (b) {put_bytes / 2**30:.2f} GiB bf16 CPU tensor: put "
                f"{put_s * 1e3:.1f} ms ({put_bytes / put_s / 1e9:.2f} "
                f"GB/s), get {get_s * 1e3:.3f} ms (a view into the store), "
                f"bit for bit")
        if cuda:
            small = big[: 64 << 20].view(torch.bfloat16).to(dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ref = rt.put(small)
            back = rt.get(ref)
            cuda_s = time.perf_counter() - t1
            check(back.device.type == "cpu" and torch.equal(
                back.view(torch.int16), small.cpu().view(torch.int16)),
                "a CUDA tensor did not arrive as a CPU tensor with its "
                "bits")
            nb = small.numel() * 2
            line += (f"; a {nb / 2**20:.0f} MiB CUDA tensor arrives as a "
                     f"CPU tensor, bit for bit, put+get {cuda_s * 1e3:.1f} "
                     f"ms ({nb / cuda_s / 1e9:.2f} GB/s)")
            del small, back
            rt.free(ref)
        del big
        print(line, flush=True)

        # (c) the slice: a GPU actor serving phase 3's requests
        t1 = time.perf_counter()
        # device None on the card: the engine's own default, the card
        # its worker was given, or a raise
        replica = rt.remote(EngineReplica).options(
            num_gpus=1 if cuda else 0).remote(cfg, SERVE_8B, 0,
                                              None if cuda else "cpu")
        info = rt.get(replica.info.remote(), timeout=900)
        ready_s = time.perf_counter() - t1
        if cuda:
            check(info["gpu_ids"] == info["visible"]
                  and len(info["visible"].split(",")) == 1
                  and info["device_count"] == 1,
                  f"the GPU actor's worker sees {info}")
        rtt = []
        for _ in range(200):
            t1 = time.perf_counter()
            rt.get(replica.ping.remote())
            rtt.append((time.perf_counter() - t1) * 1e3)
        print(f"  (c) GPU actor ready in {ready_s:.2f} s (spawn, import, "
              f"weights; {info['init_s']:.2f} s of it building the weights "
              f"on its card): CUDA_VISIBLE_DEVICES={info['visible']!r}, "
              f"{info['name']}; actor-call round trip p50 "
              f"{statistics.median(rtt):.3f} ms, p99 "
              f"{float(np.percentile(rtt, 99)):.3f} ms (200 calls)",
              flush=True)
        # dense and paged with each wave held until flush (phase 3's
        # batching, so phase 3's tokens); the dense engine a second time
        # in the now warm process, to split its cold TTFT; the paged
        # engine once more with each request entering as its call
        # arrives (its tokens printed: arrival order may change batching)
        launches = {"dense": (0, 0), "paged": (0, 0)}
        for kind, hold, label in (("dense", True, "dense"),
                                  ("dense", True, "dense again (warm)"),
                                  ("paged", True, "paged"),
                                  ("paged", False, "paged per request")):
            rt.get(replica.start.remote(kind), timeout=300)
            t1 = time.perf_counter()
            out = _actor_drain(rt, replica, first, 300, hold)
            out.update(_actor_drain(rt, replica, last, 120, hold))
            wall = time.perf_counter() - t1
            n, st, build_s = rt.get(replica.stop.remote(), timeout=120)
            want = phase3[kind]
            same = sum(out[r]["tokens"] == want["tokens"][r] for r in out)
            check(same == len(out) or not hold,
                  f"{label} in the GPU actor: tokens equal phase 3's for "
                  f"{same}/{len(out)} requests")
            got = (n["fwd"], n["paged"])
            check(got == tuple(want["launches"]) or not hold,
                  f"{label} in the GPU actor: flash and paged launches "
                  f"{got}, phase 3 {want['launches']}")
            # once a layer a prefill batch (dense) and a decode step
            # (paged), every flash launch on the wgmma route and every
            # paged split pass with its merge
            layers = cfg.num_layers
            want_n = ((layers * st["prefill_batches"], 0) if kind == "dense"
                      else (0, layers * st["decode_steps"]))
            check(got == want_n,
                  f"{label} in the GPU actor: flash and paged launches "
                  f"{got}, want {want_n} ({st['prefill_batches']} prefill "
                  f"batches, {st['decode_steps']} decode steps)")
            check(n["fwd_sm90"] == n["fwd"] and
                  n["paged_merge"] == n["paged"],
                  f"{label} in the GPU actor: launches {n}")
            check(build_s == 0.0, f"the GPU actor rebuilt the kernels "
                                  f"({build_s:.1f} s)")
            if kind == "paged":
                check(st["prefix_hit_tokens"] >= 128,
                      "the shared 128-token prefix did not hit the cache")
            lat, ref_lat = _latency_ms(out), want["lat"]
            if kind == "paged" and hold:
                PHASE14_LAT.update(lat)
            note = ("" if hold else
                    " (each request enters as its call arrives; tokens "
                    "printed, not required)")
            equal = ", equal to phase 3's" if hold else ""
            print(f"  (c) {label} in the GPU actor{note}: tokens equal "
                  f"phase 3's for {same}/{len(out)} requests; flash "
                  f"launches {got[0]} (wgmma {n['fwd_sm90']}; "
                  f"{st['prefill_batches']} prefill batches), paged "
                  f"launches {got[1]} ({st['decode_steps']} decode "
                  f"steps){equal}; wall {wall:.2f} s; TTFT p50 {lat['ttft_p50']:.2f} ms "
                  f"(phase 3 {ref_lat['ttft_p50']:.2f}), ITL p50 "
                  f"{lat['itl_p50']:.3f} ms (phase 3 "
                  f"{ref_lat['itl_p50']:.3f})", flush=True)
            launches[kind] = tuple(a + b for a, b in
                                   zip(launches[kind], got))
    finally:
        rt.shutdown()
    if cuda:
        # (d) the actor's process is gone and its context with it
        deadline = time.monotonic() + 60
        while True:
            free = torch.cuda.mem_get_info()[0]
            if free >= free0 - (1 << 30) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        check(free >= free0 - (1 << 30),
              f"after shutdown() the card has {free / 2**30:.2f} GiB free, "
              f"{free0 / 2**30:.2f} before the runtime")
        print(f"  (d) after shutdown(): {free / 2**30:.2f} GiB free on the "
              f"card, {free0 / 2**30:.2f} before the runtime", flush=True)
    return {"flash_attention_fwd": launches["dense"][0],
            "paged_attention": launches["paged"][1]}


# ---------------------------------------------------------------- phase 15

# phase 7's GPT-2 run: batch and sequence
GANG_GPT2 = (8, 1024)


def _gang_gpt2_loop(config) -> None:
    """15(b)'s gang worker: phase 7's GPT-2 run (params from seed 0,
    tokens from numpy seed 0, AdamW(3e-4, weight decay 0.01)), resumed
    from ``train.get_checkpoint()`` when there is one (params and AdamW
    state through ``dist_checkpoint``); after each step it saves a
    checkpoint and reports it, with the kernel launches of its process
    and the store its default group met in (phase 21). The first attempt
    exits after step 1's report (behind the sentinel file)."""
    import shutil
    import tempfile

    from ray_tpu_torch import train as tr
    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.tools.train_gang import average_grads
    from ray_tpu_torch.train import backend as _train_backend
    from ray_tpu_torch.train import dist_checkpoint as dc

    dev = torch.device(config.get("device") or
                       f"cuda:{torch.cuda.current_device()}")
    cfg, b, s = config["cfg"], config["batch"], config["seq"]
    params = gpt2.init_params(cfg, seed=0, device=dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s + 1))).to(dev)
    leaves = llama.param_leaves(params)
    for _, p in leaves:
        p.requires_grad_()
    opt = torch.optim.AdamW([p for _, p in leaves], lr=3e-4,
                            weight_decay=0.01)

    def state(step):
        st = opt.state
        return {"params": {n: p.detach() for n, p in leaves},
                "exp_avg": {n: st[p]["exp_avg"] for n, p in leaves},
                "exp_avg_sq": {n: st[p]["exp_avg_sq"] for n, p in leaves},
                "adam_step": {n: st[p]["step"] for n, p in leaves},
                "step": step}

    start = 0
    ckpt = tr.get_checkpoint()
    if ckpt is not None:
        # AdamW's state laid out first, then the checkpoint loaded into it
        for _, p in leaves:
            opt.state[p] = {"step": torch.tensor(0.0),
                            "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": torch.zeros_like(p)}
        with ckpt.as_directory() as d:
            start = dc.restore(d, like=state(None))["step"] + 1
    for step in range(start, int(config["steps"])):
        opt.zero_grad(set_to_none=True)
        loss = gpt2.loss_fn(cfg, params, {"tokens": toks})
        loss.backward()
        average_grads(opt)
        opt.step()
        value = loss.item()
        d = tempfile.mkdtemp(prefix="rtpt_gpt2_")
        t0 = time.perf_counter()
        dc.save(d, state(step))
        tr.report({"step": step, "loss": value, "resumed_at": start,
                   "save_s": time.perf_counter() - t0, "pid": os.getpid(),
                   "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                   "node": os.environ.get("RTPU_NODE_ID"),
                   "backend": torch.distributed.get_backend(),
                   "rendezvous": type(_train_backend._COORDINATOR.get(
                       "store")).__name__, "launches": counters()},
                  checkpoint=tr.Checkpoint.from_directory(d))
        shutil.rmtree(d, ignore_errors=True)
        if step == 1 and not os.path.exists(config["sentinel"]):
            open(config["sentinel"], "w").close()
            os._exit(1)


def _rel(got, want) -> float:
    return float(np.max(np.abs(np.array(got) - np.array(want))
                        / np.abs(np.array(want))))


def train_gang_phase(dev, phase5: dict, gpt2_losses: list) -> tuple:
    """15: the Train gang on the card. (a) ``TorchTrainer`` with one
    ``use_gpu`` worker and ``TorchConfig(distributed=True)`` (NCCL at
    world size 1) runs ``tools/train_gang.py``'s ``gang_loop``: phase 5's
    run for 3 AdamW steps, every gradient averaged over the group; its
    losses are phase 5's first three (rtol 2e-2), its launches 2 x 8 x 3
    forward and 8 x 3 dQ and dK/dV, all wgmma; the worker sees one card
    and loads the kernel library without building it. (b) phase 7's
    GPT-2 run through ``_gang_gpt2_loop`` with ``max_failures=1``: the
    first worker exits after step 1; the restarted gang (a new process,
    the same card) resumes at step 2 from the checkpoint, and steps 0-3
    give phase 7's losses (rtol 2e-2); the GPU is free again after. (c)
    two one-GPU workers on one card raise PlacementGroupError within a
    5 s ``train_pg_ready_timeout_s``; ``TorchConfig(device=None)``
    without ``use_gpu`` raises ValueError. (d) after ``shutdown()`` the
    card's free memory is back. Returns (a)'s launches and its step
    time. On the CPU (a
    rehearsal, with ``LlamaConfig.llama3_8b``, ``profile_train.RUNS``,
    ``GPT2Config.gpt2_125m`` and ``GANG_GPT2`` patched small) the gang
    trains on the CPU over gloo."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import train as tr
    from ray_tpu_torch.core import runtime_context
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.exceptions import PlacementGroupError
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.tools import profile_train as run
    from ray_tpu_torch.tools.train_gang import fit as gang_fit

    cuda = dev.type == "cuda"
    device = None if cuda else "cpu"
    L, b, s = run.RUNS["llama3_8b"]
    steps = 3
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free0 = torch.cuda.mem_get_info()[0]
        print(f"  card memory before the gang: {free0 / 2**30:.2f} GiB free;"
              f" the driver holds {torch.cuda.memory_allocated() / 2**30:.2f}"
              f" GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f}"
              f" GiB reserved", flush=True)
    rt.init(num_workers=2, object_store_memory=256 << 20)
    storage = tempfile.mkdtemp(prefix="rtpt_gang_")
    try:
        # (a) phase 5's run from a gang worker
        t0 = time.perf_counter()
        res = gang_fit(1, steps, storage, use_gpu=cuda, device=device,
                       cfg=run.train_config(), batch=b, seq=s)
        fit_s = time.perf_counter() - t0
        check(res.error is None, f"15(a): the gang failed: {res.error!r}")
        hist = res.metrics_history
        losses = [m["loss"] for m in hist]
        want = phase5["losses"][:steps]
        rel = _rel(losses, want)
        n = hist[-1]["launches"]
        step_ms = statistics.median(m["step_ms"] for m in hist[1:])
        print(f"  (a) {L} layers at Llama-3-8B width, {b} x {s}, {steps} "
              f"AdamW steps in a gang worker ({hist[0]['backend']} world "
              f"{hist[0]['world']}, {hist[0]['device']}, "
              f"CUDA_VISIBLE_DEVICES={hist[0]['visible']!r}): losses "
              f"{' '.join(f'{x:.4f}' for x in losses)} against phase 5's "
              f"{' '.join(f'{x:.4f}' for x in want)} (largest relative "
              f"difference {rel:.3e}; bit for bit {losses == want}); step "
              f"{step_ms:.1f} ms (median of steps 2-{steps}; first "
              f"{hist[0]['step_ms']:.1f}) against phase 5's "
              f"{phase5['step_ms']:.1f} ms; peak {hist[-1]['peak_gib']:.2f}"
              f" GiB; launches {n}; kernel build in the worker "
              f"{hist[-1]['build_s']:.1f} s; fit {fit_s:.1f} s; "
              f"{smi_line() if cuda else 'cpu'}", flush=True)
        check(rel <= 2e-2, f"15(a): losses {losses} are not phase 5's "
                           f"{want} at rtol 2e-2")
        check(hist[0]["world"] == 1 and
              hist[0]["backend"] == ("nccl" if cuda else "gloo"),
              f"15(a): the gang's group is {hist[0]['backend']} world "
              f"{hist[0]['world']}")
        check(n["fwd"] == n["fwd_sm90"] == 2 * L * steps
              and n["dq"] == n["dq_sm90"] == L * steps
              and n["dkv"] == n["dkv_sm90"] == L * steps,
              f"15(a): launches {n}, want {2 * L * steps} forward and "
              f"{L * steps} dQ and dK/dV, all wgmma")
        check(cuda and len((hist[0]["visible"] or "").split(",")) == 1
              and hist[0]["visible"] != "",
              f"15(a): the worker sees CUDA_VISIBLE_DEVICES="
              f"{hist[0]['visible']!r}")
        check(hist[-1]["build_s"] == 0.0, f"15(a): the gang worker built "
              f"the kernels ({hist[-1]['build_s']:.1f} s)")

        # (b) the restart drill at GPT-2 125M
        gcfg = gpt2.GPT2Config.gpt2_125m()
        gb, gs = GANG_GPT2
        t0 = time.perf_counter()
        res = tr.TorchTrainer(
            _gang_gpt2_loop,
            train_loop_config={"cfg": gcfg, "batch": gb, "seq": gs,
                               "steps": 4, "device": device,
                               "sentinel": os.path.join(storage, "crashed")},
            torch_config=tr.TorchConfig(device=device, distributed=True,
                                        timeout_s=600.0),
            scaling_config=tr.ScalingConfig(num_workers=1, use_gpu=cuda),
            run_config=tr.RunConfig(
                storage_path=storage, name="gpt2",
                failure_config=tr.FailureConfig(max_failures=1),
                checkpoint_config=tr.CheckpointConfig(num_to_keep=2))).fit()
        drill_s = time.perf_counter() - t0
        check(res.error is None, f"15(b): the drill failed: {res.error!r}")
        hist = res.metrics_history
        got = {m["step"]: m for m in hist}
        pids = [m["pid"] for m in hist]
        first, second = hist[:2], hist[2:]
        glosses = [got[k]["loss"] for k in sorted(got)]
        grel = _rel(glosses, gpt2_losses[:4])
        saves = [m["save_s"] for m in hist]
        print(f"  (b) GPT-2 125M, {gb} x {gs}: steps "
              f"{[m['step'] for m in hist]}, pids {pids}, "
              f"CUDA_VISIBLE_DEVICES {[m['visible'] for m in hist]}, "
              f"resumed at {[m['resumed_at'] for m in hist]}; losses "
              f"{' '.join(f'{x:.4f}' for x in glosses)} against phase 7's "
              f"{' '.join(f'{x:.4f}' for x in gpt2_losses[:4])} (largest "
              f"relative difference {grel:.3e}; bit for bit "
              f"{glosses == gpt2_losses[:4]}); checkpoint saves "
              f"{' '.join(f'{x:.2f}' for x in saves)} s; fit "
              f"{drill_s:.1f} s", flush=True)
        check([m["step"] for m in hist] == [0, 1, 2, 3],
              f"15(b): reported steps {[m['step'] for m in hist]}")
        check(len(set(m["pid"] for m in first)) == 1 and
              len(set(m["pid"] for m in second)) == 1 and
              first[0]["pid"] != second[0]["pid"],
              f"15(b): the restart did not start a new worker: {pids}")
        check([m["resumed_at"] for m in hist] == [0, 0, 2, 2],
              "15(b): the restarted gang did not resume at step 2")
        check(len({m["visible"] for m in hist}) == 1,
              f"15(b): the restarted gang got another card: "
              f"{[m['visible'] for m in hist]}")
        check(grel <= 2e-2, f"15(b): losses {glosses} are not phase 7's")
        avail = runtime_context.get_core().state_summary()["resources"][
            "available"]
        check(avail.get("GPU") == (1.0 if cuda else None),
              f"15(b): after fit() the node has {avail} available")

        # (c) refusals
        os.environ["RTPU_TRAIN_PG_READY_TIMEOUT_S"] = "5"
        config.reload()
        t0 = time.perf_counter()
        try:
            tr.TorchTrainer(
                _gang_gpt2_loop, torch_config=tr.TorchConfig(),
                scaling_config=tr.ScalingConfig(num_workers=2, use_gpu=True),
                run_config=tr.RunConfig(storage_path=storage,
                                        name="two")).fit()
            check(False, "15(c): two one-GPU workers started on one card")
        except PlacementGroupError as e:
            pg_s = time.perf_counter() - t0
            check("'GPU': 1.0" in str(e) and pg_s < 30,
                  f"15(c): {e!r} after {pg_s:.1f} s")
        finally:
            os.environ.pop("RTPU_TRAIN_PG_READY_TIMEOUT_S", None)
            config.reload()
        try:
            tr.TorchTrainer(
                _gang_gpt2_loop,
                scaling_config=tr.ScalingConfig(num_workers=1),
                run_config=tr.RunConfig(storage_path=storage,
                                        name="cpu")).fit()
            check(False, "15(c): TorchConfig(device=None) without GPUs ran")
        except ValueError as e:
            check("use_gpu=True" in str(e), f"15(c): {e!r}")
        print(f"  (c) two one-GPU workers on one card: PlacementGroupError "
              f"after {pg_s:.1f} s (train_pg_ready_timeout_s 5); "
              f"TorchConfig(device=None) without use_gpu: ValueError",
              flush=True)
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    if cuda:
        # (d) the gang's processes are gone and their contexts with them
        deadline = time.monotonic() + 60
        while True:
            free = torch.cuda.mem_get_info()[0]
            if free >= free0 - (1 << 30) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        check(free >= free0 - (1 << 30),
              f"15(d): after shutdown() the card has {free / 2**30:.2f} GiB "
              f"free, {free0 / 2**30:.2f} before the gang")
        print(f"  (d) after shutdown(): {free / 2**30:.2f} GiB free on the "
              f"card, {free0 / 2**30:.2f} before the gang", flush=True)
    return ({"flash_attention_fwd": n["fwd_sm90"],
             "flash_attention_bwd_dq": n["dq_sm90"],
             "flash_attention_bwd_dkv": n["dkv_sm90"]}, {"step_ms": step_ms})


# ---------------------------------------------------------------- phase 16

# 16(a)'s dataset: rows x [row shape] float32 (2048 x [128, 1024]: 1 GiB),
# fed in batches of ``DATA_BATCH`` rows (64 rows: 32 MiB)
DATA_ROWS, DATA_ROW_SHAPE, DATA_BATCH = 2048, (128, 1024), 64
# 16(c): rows of tokens predicted in one batch
PREDICT_ROWS, PREDICT_SEQ = 8, 512
# phase 16's object store (the 1 GiB dataset is one block in it)
DATA_STORE_BYTES = 3 << 30


def _draw_8b_params(path):
    """16(c)'s ``load_params``: phase 3's bf16 Llama-3-8B weights (seed 0)
    drawn on the caller's card (``path`` is unused: nothing is read)."""
    from ray_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                      param_dtype=torch.bfloat16)
    return llama.init_params(cfg, seed=0, device=llama.resolve_device(None))


def _argmax_forward(params, tokens):
    """16(c)'s apply function: Llama-3-8B's greedy next token at every
    position."""
    from ray_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                      param_dtype=torch.bfloat16)
    return llama.forward(cfg, params, tokens).argmax(-1)


def _counted_predictor():
    """``TorchPredictor`` that also reports, per batch, its process's
    flash launches during ``predict``, the predict time, the time of the
    same predict again (warm: the first in a fresh actor is cold) and
    when it was ready (wall clock), so 16(c) reads what ran in the
    pool's actor."""
    from ray_tpu_torch.train.predictor import TorchPredictor

    class CountedPredictor(TorchPredictor):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            if self._device.type == "cuda":
                torch.cuda.synchronize()
            self.ready_at = time.time()

        def predict(self, batch):
            before = counters()
            t0 = time.perf_counter()
            out = super().predict(batch)
            ms = (time.perf_counter() - t0) * 1e3
            c = counters()
            t0 = time.perf_counter()
            super().predict(batch)
            warm_ms = (time.perf_counter() - t0) * 1e3
            n = len(out["predictions"])
            out.update({
                "fwd": np.full(n, c["fwd"] - before["fwd"]),
                "fwd_sm90": np.full(n, c["fwd_sm90"] - before["fwd_sm90"]),
                "predict_ms": np.full(n, ms),
                "warm_ms": np.full(n, warm_ms),
                "ready_at": np.full(n, self.ready_at),
                "visible": np.asarray(
                    [os.environ.get("CUDA_VISIBLE_DEVICES", "")] * n)})
            return out

    return CountedPredictor


def _feed_pass(ds, dev, gemm=None, reps: int = 0, take=None) -> float:
    """One pass of ``iter_torch_batches`` over ``ds`` (the card unless
    ``dev`` is the CPU), running ``reps`` GEMMs on each batch's stream;
    seconds, synchronised."""
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in ds.iter_torch_batches(batch_size=DATA_BATCH,
                                   device=None if cuda else "cpu"):
        for _ in range(reps):
            gemm()
    if cuda:
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def _host_pass(ds, pinned) -> tuple:
    """The feed's host half alone: one pass of numpy batches read from
    the store (no prefetch thread, no card), each copied with
    ``np.copyto`` into ``pinned`` as the staging ring copies it. Seconds
    of the pass, and of the copies within it."""
    buf = pinned.numpy()
    copy_s = 0.0
    t0 = time.perf_counter()
    for b in ds.iter_batches(batch_size=DATA_BATCH, batch_format="numpy",
                             prefetch_batches=0):
        v = np.ascontiguousarray(b["data"])
        t1 = time.perf_counter()
        np.copyto(buf[:v.nbytes].view(v.dtype).reshape(v.shape), v)
        copy_s += time.perf_counter() - t1
    return time.perf_counter() - t0, copy_s


def data_phase(dev, phase5: dict, gang: dict) -> dict:
    """16: Data on the card (``ray_tpu_torch.data``; the runtime started
    afresh with a store of 3 GiB). (a) The feed alone: ``from_numpy`` of
    2048 x [128, 1024] float32 rows (1 GiB, seed 0) through
    ``iter_torch_batches()`` in 32 MiB batches: every staged batch equals
    the host batch bit for bit (compared on the card with a synchronous
    copy); the feed's GB/s beside a bare pinned and a pageable ``copy_``
    of 32 MiB; a pass with a bf16 GEMM of about one batch's feed time per
    batch against the feed and the GEMMs alone (overlap printed); after a
    ``break`` at the second batch the prefetch thread ends, the pinned
    ring is released and the card's allocated memory is back. (b) Phase
    15(a)'s one-worker NCCL gang with ``datasets={"train": ds}``: ``ds``
    holds phase 5's token rows three times in order and ``gang_loop``
    reads ``iter_torch_batches(batch_size=4)`` of its shard: 3 steps whose
    losses equal phase 5's first three bit for bit, 48 forward and 24 dQ
    and dK/dV launches, all wgmma; step time beside phase 15(a)'s. (c)
    ``predict_batches`` of ``TorchPredictor`` at Llama-3-8B full width
    (bf16, phase 3's seed-0 weights drawn on the actor's card) with a
    ``num_gpus=1``, ``concurrency=1`` actor pool over 8 rows of 512
    tokens, ``batch_size=8``: the argmax equals ``TorchPredictor.predict``
    in this process on the same weights and batch, 32 wgmma forward
    launches in the actor; ms a batch and the actor's ready time. (d)
    ``train_offline`` of BC on the card from a JSON sample-batch file
    (``shuffle=False``): the losses of direct ``update`` calls on the same
    batches in order. Returns the launches. On the CPU (a rehearsal, with
    the sizes, ``LlamaConfig.llama3_8b`` and ``profile_train.RUNS``
    patched small) everything runs on the CPU and the launch checks
    fail."""
    import shutil
    import tempfile
    import threading

    import ray_tpu_torch as rt
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.data import iterator as feed
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.rllib import offline, rl_module
    from ray_tpu_torch.tools import profile_train as run
    from ray_tpu_torch.tools.train_gang import fit as gang_fit
    from ray_tpu_torch.train.predictor import TorchPredictor, predict_batches

    cuda = dev.type == "cuda"
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free0 = torch.cuda.mem_get_info()[0]
    launches = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
                "flash_attention_bwd_dkv": 0}
    t_phase = time.perf_counter()
    rt.init(num_workers=2, object_store_memory=DATA_STORE_BYTES)
    storage = tempfile.mkdtemp(prefix="rtpt_data_")
    try:
        # (a) the feed alone
        t0 = time.perf_counter()
        arr = np.random.default_rng(0).standard_normal(
            (DATA_ROWS, *DATA_ROW_SHAPE), dtype=np.float32)
        ds = rd.from_numpy(arr)
        make_s = time.perf_counter() - t0
        batch_bytes = DATA_BATCH * arr[0].nbytes
        n_batches = -(-DATA_ROWS // DATA_BATCH)
        equal = 0
        for i, b in enumerate(ds.iter_torch_batches(
                batch_size=DATA_BATCH, device=None if cuda else "cpu")):
            t = b["data"]
            want = torch.from_numpy(
                arr[i * DATA_BATCH:(i + 1) * DATA_BATCH]).to(t.device)
            equal += bool(t.device.type == dev.type and t.dtype ==
                          torch.float32 and torch.equal(t, want))
        check(equal == n_batches, f"16(a): {equal}/{n_batches} staged "
                                  f"batches equal their host batches")
        feed_s = min(_feed_pass(ds, dev) for _ in range(2))
        feed_gbs = arr.nbytes / feed_s / 1e9
        if cuda:
            pinned = torch.empty(batch_bytes, dtype=torch.uint8,
                                 pin_memory=True)
            pageable = torch.empty(batch_bytes, dtype=torch.uint8)
            dst = torch.empty(batch_bytes, dtype=torch.uint8, device=dev)
            pin_ms = time_ms(lambda: dst.copy_(pinned, non_blocking=True))
            page_ms = time_ms(lambda: dst.copy_(pageable))
            host_s, copy_s = min(_host_pass(ds, pinned) for _ in range(2))
            n = 8192
            a = torch.randn(n, n, device=dev, dtype=torch.bfloat16)
            c = torch.empty_like(a)

            def gemm():
                torch.mm(a, a, out=c)

            gemm_ms = time_ms(gemm)
            reps = max(1, round(feed_s / n_batches * 1e3 / gemm_ms))
            gemm_s = n_batches * reps * gemm_ms / 1e3
            both_s = _feed_pass(ds, dev, gemm, reps)
            del a, c, dst, pinned, pageable
            print(f"  (a) 1 GiB float32 ({DATA_ROWS} x {list(DATA_ROW_SHAPE)}"
                  f", made and put in {make_s:.1f} s): {n_batches} batches of"
                  f" {batch_bytes / 2**20:.0f} MiB staged on the card, "
                  f"{equal}/{n_batches} bit for bit; feed {feed_gbs:.2f} GB/s "
                  f"({feed_s * 1e3 / n_batches:.2f} ms a batch); a bare "
                  f"copy_ of {batch_bytes / 2**20:.0f} MiB: pinned "
                  f"{pin_ms:.3f} ms ({batch_bytes / pin_ms / 1e6:.2f} GB/s), "
                  f"pageable {page_ms:.3f} ms "
                  f"({batch_bytes / page_ms / 1e6:.2f} GB/s); the host "
                  f"half alone (batches read from the store and np.copyto "
                  f"into pinned memory, no card): "
                  f"{arr.nbytes / host_s / 1e9:.2f} GB/s, the copies within "
                  f"it {arr.nbytes / copy_s / 1e9:.2f} GB/s; with {reps} "
                  f"bf16 GEMM(s) of {n} ({gemm_ms:.3f} ms each) per batch: "
                  f"{both_s:.3f} s against feed + GEMMs "
                  f"{feed_s + gemm_s:.3f} s (feed {feed_s:.3f}, GEMMs "
                  f"{gemm_s:.3f}; overlap {feed_s + gemm_s - both_s:.3f} s); "
                  f"{smi_line()}", flush=True)
        else:
            print(f"  (a) {arr.nbytes / 2**20:.0f} MiB on the CPU: "
                  f"{equal}/{n_batches} batches equal; feed {feed_gbs:.2f} "
                  f"GB/s", flush=True)
        # a break after two batches: the thread ends, the ring and the
        # card memory come back
        gc.collect()
        if cuda:
            torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated() if cuda else 0
        it = ds.iter_torch_batches(batch_size=DATA_BATCH,
                                   device=None if cuda else "cpu")
        for i, b in enumerate(it):
            if i == 1:
                break
        held = feed.pinned_ring_bytes()
        del b
        it.close()
        del it
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and any(
                t.name == "rtpt-data-prefetch"
                for t in threading.enumerate()):
            time.sleep(0.01)
        gc.collect()
        if cuda:
            torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated() if cuda else 0
        threads = sum(t.name == "rtpt-data-prefetch"
                      for t in threading.enumerate())
        print(f"  (a) break after 2 batches: pinned ring {held / 2**20:.0f} "
              f"MiB while iterating, {feed.pinned_ring_bytes()} bytes after;"
              f" prefetch threads left {threads}; card memory allocated "
              f"{mem0 / 2**20:.1f} MiB before, {mem1 / 2**20:.1f} after",
              flush=True)
        check(feed.pinned_ring_bytes() == 0 and threads == 0 and
              mem1 == mem0, "16(a): an abandoned iterator kept its thread, "
                            "its pinned ring or card memory")
        check(not cuda or held >= 2 * batch_bytes,
              f"16(a): the pinned ring held {held} bytes")
        del ds, arr
        gc.collect()

        # (b) phase 5's run from a Dataset shard in a gang worker
        cfg = run.train_config()
        L, b_rows, s = run.RUNS["llama3_8b"]
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                 (b_rows, s + 1))
        ds = rd.from_items([{"tokens": r} for r in np.concatenate(
            [toks] * 3)], parallelism=1)
        steps = 3
        t0 = time.perf_counter()
        res = gang_fit(1, steps, storage, use_gpu=cuda,
                       device=None if cuda else "cpu", cfg=cfg,
                       batch=b_rows, seq=s, datasets={"train": ds})
        fit_s = time.perf_counter() - t0
        check(res.error is None, f"16(b): the gang failed: {res.error!r}")
        hist = res.metrics_history
        losses = [m["loss"] for m in hist]
        want = phase5["losses"][:steps]
        n = hist[-1]["launches"]
        step_ms = statistics.median(m["step_ms"] for m in hist[1:])
        print(f"  (b) {L} layers at Llama-3-8B width, {b_rows} x {s} tokens "
              f"a step from a Dataset shard (12 rows, phase 5's batch three "
              f"times), {steps} AdamW steps in a gang worker "
              f"({hist[0]['backend']} world {hist[0]['world']}): losses "
              f"{' '.join(f'{x:.4f}' for x in losses)} against phase 5's "
              f"{' '.join(f'{x:.4f}' for x in want)} (bit for bit "
              f"{losses == want}); step {step_ms:.1f} ms (median of steps "
              f"2-{steps}, the batch's wait included; first "
              f"{hist[0]['step_ms']:.1f}) against phase 15(a)'s "
              f"{gang['step_ms']:.1f} ms; launches {n}; fit {fit_s:.1f} s",
              flush=True)
        check(losses == want, f"16(b): losses {losses} are not phase 5's "
                              f"{want} bit for bit")
        check(n["fwd"] == n["fwd_sm90"] == 2 * L * steps
              and n["dq"] == n["dq_sm90"] == L * steps
              and n["dkv"] == n["dkv_sm90"] == L * steps,
              f"16(b): launches {n}, want {2 * L * steps} forward and "
              f"{L * steps} dQ and dK/dV, all wgmma")
        launches["flash_attention_fwd"] += n["fwd_sm90"]
        launches["flash_attention_bwd_dq"] += n["dq_sm90"]
        launches["flash_attention_bwd_dkv"] += n["dkv_sm90"]
        del ds
        gc.collect()

        # (c) Llama-3-8B predictions over a Dataset on a GPU actor pool
        pcfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                           param_dtype=torch.bfloat16)
        ptoks = np.random.default_rng(0).integers(
            0, pcfg.vocab_size, (PREDICT_ROWS, PREDICT_SEQ))
        ds = rd.from_items([{"tokens": r} for r in ptoks], parallelism=1)
        t0 = time.time()
        out = predict_batches(
            ds, _counted_predictor(), batch_size=PREDICT_ROWS,
            concurrency=1, num_gpus=1 if cuda else 0,
            predictor_kwargs={
                "checkpoint": storage, "apply_fn": _argmax_forward,
                "load_params": _draw_8b_params, "input_column": "tokens",
                "device": None if cuda else "cpu"}).take_batch(PREDICT_ROWS)
        wall_s = time.time() - t0
        params = _draw_8b_params(None) if cuda else llama.init_params(
            pcfg, seed=0, device="cpu")
        local = TorchPredictor(params, _argmax_forward,
                               input_column="tokens",
                               device=None if cuda else "cpu")
        want = local.predict({"tokens": ptoks})["predictions"]
        del local, params
        gc.collect()
        same = bool(np.array_equal(out["predictions"], want))
        fwd, fwd_sm90 = int(out["fwd"][0]), int(out["fwd_sm90"][0])
        print(f"  (c) predict_batches, Llama-3-8B bf16 (32 layers) on a "
              f"num_gpus=1 actor (CUDA_VISIBLE_DEVICES="
              f"{out['visible'][0]!r}): {PREDICT_ROWS} x {PREDICT_SEQ} tokens "
              f"in one batch, {float(out['predict_ms'][0]):.1f} ms a batch "
              f"(the actor's first forward; the same batch again "
              f"{float(out['warm_ms'][0]):.1f} ms); "
              f"actor ready {float(out['ready_at'][0]) - t0:.2f} s after "
              f"the call (weights drawn on its card), the whole map "
              f"{wall_s:.2f} s; argmax equal to TorchPredictor.predict in "
              f"the driver: {same}; flash forward launches in the actor "
              f"{fwd} (wgmma {fwd_sm90})", flush=True)
        check(same, "16(c): the predictions over the Dataset differ from "
                    "the driver's")
        check(fwd == fwd_sm90 == pcfg.num_layers,
              f"16(c): the actor launched {fwd} forward kernels, {fwd_sm90} "
              f"wgmma; want {pcfg.num_layers}, all wgmma")
        launches["flash_attention_fwd"] += fwd_sm90
        del ds, out
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # (d) offline BC on the card from a JSON sample-batch file
        rng = np.random.default_rng(0)
        batches = [{"obs": rng.standard_normal((64, 4)).astype(np.float32),
                    "actions": rng.integers(0, 2, 64).astype(np.int64),
                    "returns": rng.standard_normal(64).astype(np.float32)}
                   for _ in range(4)]
        path = os.path.join(storage, "bc.jsonl")
        offline.write_sample_batch_json(batches, path)
        lrn = offline.BCLearner(rl_module.MLPModule(4, 2), device=dev)
        twin = offline.BCLearner(rl_module.MLPModule(4, 2), device=dev,
                                 params=lrn.get_weights())
        fed, losses = [], []

        class Recorder:
            def update(self, batch):
                fed.append({k: np.array(v) for k, v in batch.items()})
                losses.append(lrn.update(batch))
                return losses[-1]

        last = offline.train_offline(
            Recorder(), offline.read_sample_batch_json(path), num_epochs=2,
            batch_size=96, shuffle=False)
        direct = [twin.update(bt) for bt in fed]
        print(f"  (d) train_offline, BC on the card from JSON lines "
              f"({len(fed)} batches over 2 epochs): losses "
              f"{' '.join(f'{x:.6f}' for x in losses)}; direct updates on "
              f"the same batches {' '.join(f'{x:.6f}' for x in direct)} "
              f"(equal: {losses == direct})", flush=True)
        check(len(fed) == 6 and last == losses[-1] and losses == direct,
              "16(d): train_offline's losses differ from direct updates")
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    if cuda:
        deadline = time.monotonic() + 60
        while True:
            free = torch.cuda.mem_get_info()[0]
            if free >= free0 - (1 << 30) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        print(f"  after shutdown(): {free / 2**30:.2f} GiB free on the card,"
              f" {free0 / 2**30:.2f} before the phase; phase 16 took "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        check(free >= free0 - (1 << 30), f"16: after shutdown() the card "
              f"has {free / 2**30:.2f} GiB free, {free0 / 2**30:.2f} before")
    return launches


# ---------------------------------------------------------------- phase 17

# phase 14's paged TTFT and ITL (the wave held until flush), for 17(a)
PHASE14_LAT: dict = {}
# 17(c): one Llama-3-8B request's KV, K and V: [layers, KV heads, tokens,
# head dim] in bf16 (2 x 32 x 8 x 512 x 128 x 2 B = 64 MiB)
LANE_KV_SHAPE = (32, 8, 512, 128)
# 17(c): hops timed per channel kind, and small-value round trips
LANE_HOPS, LANE_RTT_CALLS = 20, 200
# 17(d): the pipeline's model, new tokens a request, and requests timed
DAG_MODEL_CONFIG = {"preset": "llama3_8b", "dtype": "bfloat16",
                    "param_dtype": "bfloat16"}
DAG_MAX_NEW, DAG_REQUESTS = 16, 5
# phase 17's object store: the shm hop's three 136 MiB channels fit
SERVE_STORE_BYTES = 1 << 30
# 17(d)'s reply and ms a request, 17(c)'s shm round trip (phase 21 prints
# its socket edges beside them)
PHASE17_DAG: dict = {}


def _served_engine(kind: str):
    """Phase 17's replica body: the port's paged (``kind="paged"``) or
    dense engine, reporting its process's kernel launches, its prefill
    batches and decode steps, its page pool and its pid. Made in a
    function, so the class is pickled by value into the replica."""
    from ray_tpu_torch.serve.llm_engine import LLMEngine
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

    base = PagedLLMEngine if kind == "paged" else LLMEngine

    class Served(base):
        def __init__(self, **kw):
            from ray_tpu_torch.ops import _build

            counters_reset()
            super().__init__(**kw)
            self.runs = _counted(self)
            self.built_s = _build.last_build_seconds

        def launches(self) -> dict:
            return dict(counters(), **self.runs)

        def pool(self) -> tuple:
            a = self._alloc
            return len(a.free), len(a.lru), a.num_pages

        def info(self) -> dict:
            cuda = self._device.type == "cuda"
            return {"pid": os.getpid(),
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "name": (torch.cuda.get_device_name(0) if cuda
                             else "cpu"),
                    "built_s": self.built_s}

    return Served


def _served_counted_pipeline():
    """17(d)'s deployment: ``LLMPipeline`` whose generate stage also
    reports its process's kernel launches. The stage list is
    ``LLMPipeline``'s own; only its generate class is a subclass with a
    ``launches`` method."""
    from ray_tpu_torch.serve import dag_mode

    class CountedGenerate(dag_mode._Generate):
        def launches(self) -> dict:
            return counters()

    class CountedPipeline(dag_mode.LLMPipeline):
        def __init__(self, **kw):
            plain, dag_mode._Generate = dag_mode._Generate, CountedGenerate
            try:
                super().__init__(**kw)
            finally:
                dag_mode._Generate = plain

        def generate_launches(self) -> dict:
            import ray_tpu_torch

            return ray_tpu_torch.get(self._actors[1].launches.remote(),
                                     timeout=60)

    return CountedPipeline


def _lane_actor():
    """17(c)'s actor: K and V of one Llama-3-8B request on its card, a
    producer method that hands them on, and a consumer that reports
    whether it got the same tensors (``data_ptr``), their values, where
    they lie and how long the hop took (one process, one clock)."""

    class Lane:
        def __init__(self, shape):
            from ray_tpu_torch.models import llama

            dev = llama.resolve_device(None if torch.cuda.is_available()
                                       else "cpu")
            g = torch.Generator(device=dev).manual_seed(17)
            self.kv = tuple(torch.randn(shape, generator=g, device=dev,
                                        dtype=torch.float32).to(
                                            torch.bfloat16)
                            for _ in range(2))
            self.host = tuple(t.cpu().view(torch.int16) for t in self.kv)
            self.t_made = 0.0

        def make(self, i):
            self.t_made = time.perf_counter()
            return self.kv

        def take(self, kv):
            hop = time.perf_counter() - self.t_made
            same = all(a.data_ptr() == b.data_ptr()
                       for a, b in zip(kv, self.kv))
            equal = all(torch.equal(a.cpu().view(torch.int16), h)
                        for a, h in zip(kv, self.host))
            return same, equal, kv[0].device.type, hop

        def step(self, x):
            return x

    return Lane


def _route_wave(handle, reqs, timeout_s: float) -> tuple:
    """Each request through ``handle.remote`` at once; returns the
    engine's results and, per request, the client's wall time from the
    call to the result."""
    t0 = {}
    futs = {}
    for rid, prompt in reqs:
        t0[rid] = time.perf_counter()
        futs[rid] = handle.remote(prompt)
    out, wall = {}, {}
    for rid, fut in futs.items():
        out[rid] = fut.result(timeout=timeout_s)
        wall[rid] = time.perf_counter() - t0[rid]
    return out, wall


def _sse_tokens(port: int, name: str, prompt: list) -> tuple:
    import urllib.request

    def post(body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/{name}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=300)

    unary = json.loads(post({"args": [prompt]}).read())["result"]["tokens"]
    events = []
    with post({"args": [prompt], "stream": True}) as resp:
        for line in resp:
            line = line.decode().strip()
            if line.startswith("data: "):
                body = line[len("data: "):]
                if body == "[DONE]":
                    break
                events.append(json.loads(body))
    return unary, [t for e in events for t in e["tokens"]]


def serve_plane_phase(dev, phase3: dict, phase9a: dict) -> dict:
    """17: the serving plane (``ray_tpu_torch.serve``) and compiled DAGs
    on the card, the runtime started afresh. (a) Llama-3-8B bf16 through
    ``serve.run`` from a ``num_gpus=1`` paged replica: phase 3's
    requests, a stream and the HTTP proxy (unary and SSE); (b) the fp32
    2-layer dense replica against 9(a)'s tokens; (c) the DAG device lane
    against shm; (d) DAG mode (``LLMPipeline``) at full width; (e) a
    replica SIGKILLed mid-stream; (f) the card's memory given back.
    Returns its kernel launches. On the CPU (a rehearsal, with
    ``LlamaConfig.llama3_8b`` patched small in the driver and in the
    replicas' ``model_config``) every replica runs there."""
    import signal as _signal
    from dataclasses import replace

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.dag import (InputNode, bind, compile_dag,
                                   compile_pipeline)
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve import http_proxy
    from ray_tpu_torch.serve.dag_mode import _Generate, _Tokenize

    cuda = dev.type == "cuda"
    gpus = 1 if cuda else 0
    device = None if cuda else "cpu"   # the replicas' own default: the card
    t_phase = time.perf_counter()
    cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                      param_dtype=torch.bfloat16)
    layers = cfg.num_layers
    first, last = serve_8b_requests(cfg.vocab_size)
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free0 = torch.cuda.mem_get_info()[0]
    rt.init(num_workers=2, object_store_memory=SERVE_STORE_BYTES)
    launches = {"flash_attention_fwd": 0, "paged_attention": 0,
                "flash_attention_fwd_tf32x3_d128": 0}
    try:
        # (a) Llama-3-8B bf16, 32 layers, paged, from a GPU replica
        t1 = time.perf_counter()
        kw = dict(SERVE_8B, page_size=64, device=device)
        handle = serve.run(
            serve.deployment(name="llama8b", engine=True, num_gpus=gpus)(
                _served_engine("paged")).bind(**kw), timeout=900)
        info = handle.info.remote().result(timeout=60)
        ready_s = time.perf_counter() - t1
        if cuda:
            check(info["visible"] is not None
                  and len(info["visible"].split(",")) == 1,
                  f"17(a): the replica's worker sees "
                  f"CUDA_VISIBLE_DEVICES={info['visible']!r}")
        check(info["built_s"] == 0.0,
              f"17(a): the replica rebuilt the kernels "
              f"({info['built_s']:.1f} s)")
        t1 = time.perf_counter()
        out, wall = _route_wave(handle, first, 300)
        more, wall2 = _route_wave(handle, last, 120)
        out.update(more)
        wall.update(wall2)
        wave_s = time.perf_counter() - t1
        for rid, res in out.items():
            check(len(res["tokens"]) == 32,
                  f"17(a) {rid}: {len(res['tokens'])} tokens, want 32")
        same3 = sum(out[r]["tokens"] == phase3["paged"]["tokens"][r]
                    for r in out)
        # one prompt again: unary, streamed, and through the proxy (unary
        # and SSE), each alone in the engine with the same cached prefix
        prompt = first[0][1]
        unary = handle.remote(prompt).result(timeout=120)["tokens"]
        t1 = time.perf_counter()
        chunks, first_chunk_s = [], None
        for c in handle.stream(prompt):
            if first_chunk_s is None:
                first_chunk_s = time.perf_counter() - t1
            chunks.append(c)
        streamed = [t for c in chunks for t in c]
        proxy = http_proxy.start_http(port=0)
        try:
            http_unary, sse = _sse_tokens(proxy.address[1], "llama8b",
                                          prompt)
        finally:
            http_proxy.stop_http()
        check(streamed == unary and len(chunks) >= 2,
              f"17(a): {len(chunks)} streamed chunks, tokens equal to the "
              f"unary result: {streamed == unary}")
        check(http_unary == unary and sse == unary,
              f"17(a): HTTP unary equal {http_unary == unary}, SSE equal "
              f"{sse == unary} to the unary result")
        st = handle.stats.remote().result(timeout=60)
        n = handle.launches.remote().result(timeout=60)
        free, cached, pages = handle.pool.remote().result(timeout=60)
        check(free + cached == pages,
              f"17(a): {free} free + {cached} cached pages of {pages}: "
              f"pages leaked")
        check(st["prefix_hit_tokens"] >= 128,
              "17(a): the shared 128-token prefix did not hit the cache")
        check(n["paged"] == layers * n["decode_steps"]
              and n["paged"] > 0 and n["paged_merge"] == n["paged"],
              f"17(a): paged launches {n['paged']} (merges "
              f"{n['paged_merge']}), want {layers} a decode step x "
              f"{n['decode_steps']}")
        check(n["fwd_sm90"] == n["fwd"],
              f"17(a): {n['fwd_sm90']} of {n['fwd']} flash launches took "
              f"the wgmma kernel")
        lat, ref3 = _latency_ms(out), phase3["paged"]["lat"]
        ref14 = PHASE14_LAT
        over = [(wall[r] - out[r]["latency_s"]) * 1e3 for r in out]
        print(f"  (a) Llama-3-8B bf16 paged replica (num_gpus=1, "
              f"CUDA_VISIBLE_DEVICES={info['visible']!r}, {info['name']}) "
              f"ready in {ready_s:.2f} s; phase 3's 8 requests through "
              f"handle.remote in {wave_s:.2f} s: tokens equal phase 3's "
              f"for {same3}/8 (printed, not required in bf16); TTFT p50 "
              f"{lat['ttft_p50']:.2f} ms p99 {lat['ttft_p99']:.2f} ms "
              f"(phase 3 {ref3['ttft_p50']:.2f} / {ref3['ttft_p99']:.2f}, "
              f"phase 14 {ref14.get('ttft_p50', float('nan')):.2f} / "
              f"{ref14.get('ttft_p99', float('nan')):.2f}); ITL p50 "
              f"{lat['itl_p50']:.3f} ms p99 {lat['itl_p99']:.3f} ms "
              f"(phase 3 {ref3['itl_p50']:.3f} / {ref3['itl_p99']:.3f}, "
              f"phase 14 {ref14.get('itl_p50', float('nan')):.3f} / "
              f"{ref14.get('itl_p99', float('nan')):.3f}); client wall "
              f"less engine latency p50 "
              f"{statistics.median(over):.2f} ms", flush=True)
        print(f"  (a) one prompt again: unary, {len(chunks)} streamed "
              f"chunks (first after {first_chunk_s * 1e3:.1f} ms), HTTP "
              f"unary and SSE: equal tokens; paged launches {n['paged']} "
              f"= {layers} x {n['decode_steps']} decode steps, merges "
              f"{n['paged_merge']}; flash launches {n['fwd']} (wgmma "
              f"{n['fwd_sm90']}); prefix hit tokens "
              f"{st['prefix_hit_tokens']}; pages {free} free + {cached} "
              f"cached of {pages}", flush=True)
        launches["flash_attention_fwd"] += n["fwd_sm90"]
        launches["paged_attention"] += n["paged"]
        serve.delete("llama8b")

        # (b) fp32 Llama-3-8B width, 2 layers: the dense replica's
        # tokens against 9(a)'s paged tokens (3xTF32 prefill)
        cfg32 = replace(llama.LlamaConfig.llama3_8b(), num_layers=2,
                        dtype=torch.float32, param_dtype=torch.float32)
        kw32 = dict(SERVE_8B, model_config=_model_config(cfg32),
                    device=device)
        t1 = time.perf_counter()
        handle = serve.run(
            serve.deployment(name="llama8b_fp32", engine=True,
                             num_gpus=gpus)(
                _served_engine("dense")).bind(**kw32), timeout=900)
        ready32_s = time.perf_counter() - t1
        out, _ = _route_wave(handle, first, 300)
        more, _ = _route_wave(handle, last, 120)
        out.update(more)
        got = {r: v["tokens"] for r, v in out.items()}
        same9 = sum(got[r] == phase9a[r] for r in got)
        n = handle.launches.remote().result(timeout=60)
        check(same9 == len(phase9a),
              f"17(b): fp32 router tokens equal 9(a)'s for {same9}/"
              f"{len(phase9a)} requests")
        check(n["fwd"] == 2 * n["prefill_batches"] and n["fwd"] > 0
              and n["fwd_tf32x3"] == n["fwd"],
              f"17(b): flash launches {n['fwd']} (3xTF32 "
              f"{n['fwd_tf32x3']}), want 2 a prefill batch x "
              f"{n['prefill_batches']}")
        print(f"  (b) fp32 2-layer dense replica ready in {ready32_s:.2f} "
              f"s: router tokens equal 9(a)'s paged tokens for "
              f"{same9}/{len(phase9a)} requests; flash launches {n['fwd']} "
              f"(3xTF32 {n['fwd_tf32x3']}, {n['prefill_batches']} prefill "
              f"batches)", flush=True)
        launches["flash_attention_fwd_tf32x3_d128"] += n["fwd_tf32x3"]

        # (e) the same deployment with request replay: its replica is
        # SIGKILLed after a stream's first chunk; the controller starts
        # another on the freed card and the router resumes the stream
        os.environ["RTPU_SERVE_REQUEST_REPLAY"] = "1"
        os.environ["RTPU_SERVE_REPLICA_WAIT_S"] = "300"
        config.reload()
        try:
            # the budget is explicit, so that the resumed request's
            # shrinks by the tokens already delivered
            prompt, budget = first[1][1], SERVE_8B["max_new_tokens"]
            unkilled = handle.remote(prompt, budget).result(
                timeout=120)["tokens"]
            victim = handle.info.remote().result(timeout=60)["pid"]
            gen = handle.stream(prompt, budget)
            spliced = list(next(gen))
            n_first = len(spliced)
            os.kill(victim, _signal.SIGKILL)
            t_kill = time.perf_counter()
            recover_s = None
            for c in gen:
                if recover_s is None:
                    recover_s = time.perf_counter() - t_kill
                spliced += c
            after = handle.info.remote().result(timeout=60)
        finally:
            os.environ.pop("RTPU_SERVE_REQUEST_REPLAY", None)
            os.environ.pop("RTPU_SERVE_REPLICA_WAIT_S", None)
            config.reload()
        check(spliced == unkilled,
              f"17(e): the spliced stream differs from the unkilled run:"
              f"\n{spliced}\n{unkilled}")
        check(after["pid"] != victim,
              "17(e): the replica was not replaced")
        if cuda:
            check(after["visible"] == info["visible"],
                  f"17(e): the replacement sees {after['visible']!r}")
        n = handle.launches.remote().result(timeout=60)
        launches["flash_attention_fwd_tf32x3_d128"] += n["fwd_tf32x3"]
        print(f"  (e) replica (pid {victim}) SIGKILLed after the stream's "
              f"first chunk ({n_first} tokens): the replacement (pid "
              f"{after['pid']}, "
              f"CUDA_VISIBLE_DEVICES={after['visible']!r}) resumed it "
              f"{recover_s:.2f} s after the kill; spliced tokens equal the "
              f"unkilled run's ({len(spliced)} tokens)", flush=True)
        serve.delete("llama8b_fp32")

        # (c) the DAG device lane: K and V of one 8B request between two
        # methods of one GPU actor, by reference (auto) and over shm (off)
        Lane = rt.remote(_lane_actor()).options(num_gpus=gpus)
        lane = Lane.remote(LANE_KV_SHAPE)
        rt.get(lane.step.remote(0), timeout=300)
        nbytes = 2 * int(np.prod(LANE_KV_SHAPE)) * 2
        lane_out = {}
        for mode, cap in (("auto", 1 << 20), ("off", nbytes + (8 << 20))):
            with InputNode() as inp:
                node = bind(lane, "take", bind(lane, "make", inp))
            dag = compile_dag(node, capacity=cap, device=mode)
            try:
                kinds = [type(c).__name__ for c in dag._shm_chans]
                hops, got = [], None
                for i in range(LANE_HOPS):
                    got = dag.execute(i, timeout_ms=120_000)
                    hops.append(got[3])
            finally:
                dag.teardown()
            lane_out[mode] = (kinds, got, statistics.median(hops))
        kinds, (same, equal, where, _), hop = lane_out["auto"]
        want_dev = "cuda" if cuda else "cpu"
        check(kinds == ["DeviceChannel"] and same and equal
              and where == want_dev,
              f"17(c) auto: edge {kinds}, same tensors {same}, values "
              f"{equal}, on {where}")
        kinds_off, (same_o, equal_o, where_o, _), hop_off = lane_out["off"]
        check(kinds_off == ["Channel"] and not same_o and equal_o
              and where_o == "cpu",
              f"17(c) off: edge {kinds_off}, same tensors {same_o}, bits "
              f"{equal_o}, on {where_o}")
        dag = compile_pipeline([(lane, "step")])
        try:
            dag.execute(0)
            rtt_dag, rtt_actor = [], []
            for i in range(LANE_RTT_CALLS):
                t1 = time.perf_counter()
                dag.execute(i)
                rtt_dag.append(time.perf_counter() - t1)
            for i in range(LANE_RTT_CALLS):
                t1 = time.perf_counter()
                rt.get(lane.step.remote(i))
                rtt_actor.append(time.perf_counter() - t1)
        finally:
            dag.teardown()
        rt.kill(lane)
        PHASE17_DAG["rtt_shm_us"] = statistics.median(rtt_dag) * 1e6
        print(f"  (c) {nbytes / 2**20:.0f} MiB of K and V (2 x "
              f"{list(LANE_KV_SHAPE)} bf16) between two methods of one "
              f"GPU actor: device='auto' compiles {kinds}, the consumer "
              f"gets the same tensors {same} (data_ptr), equal values "
              f"{equal}, on {where}, {hop * 1e6:.1f} us a hop (median of "
              f"{LANE_HOPS}); device='off' compiles {kinds_off}, tensors on "
              f"{where_o} with equal bits {equal_o}, {hop_off * 1e6:.1f} us "
              f"a hop ({nbytes / hop_off / 1e9:.2f} GB/s); a small value's "
              f"round trip: dag.execute p50 "
              f"{statistics.median(rtt_dag) * 1e6:.1f} us, an actor call "
              f"p50 {statistics.median(rtt_actor) * 1e6:.1f} us "
              f"({LANE_RTT_CALLS} calls each)", flush=True)

        # (d) DAG mode: LLMPipeline at Llama-3-8B bf16 width, its generate
        # stage on a GPU actor, against the same stage in the driver
        mc = DAG_MODEL_CONFIG
        t1 = time.perf_counter()
        handle = serve.run(
            serve.deployment(name="llm_dag")(_served_counted_pipeline())
            .bind(model_config=mc, max_new_tokens=DAG_MAX_NEW,
                  device=device,
                  generate_options={"num_gpus": gpus} if gpus else None),
            timeout=900)
        dag_ready_s = time.perf_counter() - t1
        text = "the port serves through compiled channels"
        replies, times = [], []
        for _ in range(DAG_REQUESTS):
            t1 = time.perf_counter()
            replies.append(handle.remote(text).result(timeout=300))
            times.append(time.perf_counter() - t1)
        n = handle.generate_launches.remote().result(timeout=60)
        serve.delete("llm_dag")
        local = _Generate(mc, DAG_MAX_NEW, device=device)
        want = " ".join(str(i) for i in local.run(
            _Tokenize(mc.get("vocab_size", 256)).run(text)))
        del local
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        check(all(r == want for r in replies),
              f"17(d): the pipeline's replies differ from the stage run in "
              f"the driver:\n{replies[0]}\n{want}")
        check(n["fwd"] == layers * DAG_REQUESTS and n["fwd_sm90"] == n["fwd"],
              f"17(d): the generate stage's flash launches {n['fwd']} "
              f"(wgmma {n['fwd_sm90']}), want {layers} a request x "
              f"{DAG_REQUESTS}")
        print(f"  (d) LLMPipeline, Llama-3-8B bf16, generate stage on a "
              f"num_gpus=1 actor: ready in {dag_ready_s:.2f} s; "
              f"{DAG_REQUESTS} replies of {DAG_MAX_NEW} tokens equal the "
              f"stage run in the driver, token for token; "
              f"{statistics.median(times) * 1e3:.2f} ms a request (p50); "
              f"flash launches {n['fwd']} (wgmma {n['fwd_sm90']})",
              flush=True)
        launches["flash_attention_fwd"] += n["fwd_sm90"]
        PHASE17_DAG.update(text=text, reply=want,
                           ms=statistics.median(times) * 1e3)
    finally:
        serve.shutdown()
        rt.shutdown()
    if cuda:
        # (f) every replica and stage actor is gone, its context with it
        deadline = time.monotonic() + 60
        while True:
            free = torch.cuda.mem_get_info()[0]
            if free >= free0 - (1 << 30) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        check(free >= free0 - (1 << 30),
              f"17(f): after shutdown() the card has {free / 2**30:.2f} GiB "
              f"free, {free0 / 2**30:.2f} before")
        print(f"  (f) after serve.shutdown() and shutdown(): "
              f"{free / 2**30:.2f} GiB free on the card, "
              f"{free0 / 2**30:.2f} before", flush=True)
    print(f"  phase 17 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# ---------------------------------------------------------------- phase 18

# 18(b)'s sweep: the learning rates (3e-4 is phase 7's; 1e-1 diverges),
# ASHA's max_t (the steps a trial may train) and its grace period and
# reduction factor. Cut from 4 trials of 12 steps (grace 3) to 3 of 8
# (grace 2) to make room for phase 20 in the script's time limit (with 2
# trials ASHA has too few results at a rung to stop one)
TUNE_LRS = [3e-4, 1e-3, 1e-1]
TUNE_MAX_T, TUNE_GRACE, TUNE_ETA = 8, 2, 2
# 18(c): the step after whose checkpoint the trial's actor dies, and the
# steps the resumed trial trains to
TUNE_CKPT_AT, TUNE_RESUME_STEPS = 3, 8
# 18(d): the steps and learning rates of the gang trials (one trial: a
# second, at lr 1e-3, printed its loss only and cost a gang start: about
# half of 18(d)'s 67-72 s on an H100 80GB HBM3 at 700 W)
TUNE_GANG_STEPS, TUNE_GANG_LRS = 5, [3e-4]
# 18(a)'s timed read_tfrecords pass
READ_BYTES = 256 << 20
# phase 18's object store (the timed pass's block is in it)
TUNE_STORE_BYTES = 1 << 30
# the trials' GPT-2 configuration: None is GPT2Config.gpt2_125m() (a
# rehearsal on the CPU sets a small one; the trainable carries it)
TUNE_GPT2_CFG = None


def _token_rows(batch: dict, column: str) -> dict:
    """18's ``map_batches`` decoder: each record of ``column`` is one row
    of int64 tokens."""
    return {"tokens": np.stack([np.frombuffer(x, dtype=np.int64)
                                for x in batch[column]])}


def _avro_long(n: int) -> bytes:
    u = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        if u >> 7:
            out.append((u & 0x7F) | 0x80)
            u >>= 7
        else:
            out.append(u)
            return bytes(out)


def _write_avro_deflate(path: str, toks) -> None:
    """An Avro object container file of records {step: long, row: long,
    tokens: bytes}, one block, deflate codec (the spec's raw deflate)."""
    import zlib

    schema = {"type": "record", "name": "TokenRow", "fields": [
        {"name": "step", "type": "long"}, {"name": "row", "type": "long"},
        {"name": "tokens", "type": "bytes"}]}
    body = bytearray()
    for i, r in enumerate(toks):
        rec = r.tobytes()
        body += _avro_long(0) + _avro_long(i) + _avro_long(len(rec)) + rec
    comp = zlib.compressobj(wbits=-15)
    payload = comp.compress(bytes(body)) + comp.flush()
    sync = bytes(range(16))
    meta = {b"avro.schema": json.dumps(schema).encode(),
            b"avro.codec": b"deflate"}
    out = bytearray(b"Obj\x01") + _avro_long(len(meta))
    for k, v in meta.items():
        out += _avro_long(len(k)) + k + _avro_long(len(v)) + v
    out += _avro_long(0) + sync
    out += _avro_long(len(toks)) + _avro_long(len(payload)) + payload + sync
    with open(path, "wb") as f:
        f.write(bytes(out))


def _tune_gpt2_trial(config) -> None:
    """18's trainable: phase 7's GPT-2 run (params from seed 0,
    AdamW(lr, weight decay 0.01)) on step k's 8 rows of the TFRecords
    Dataset at ``config["path"]``, read through ``read_tfrecords``,
    decoded by ``map_batches`` and staged by ``iter_torch_batches`` on
    the trial's card. Reports the loss every step with the step time,
    this process's launches, its pid and when the trainable began.
    Resumes from ``tune.get_checkpoint()`` (params and AdamW state
    through ``dist_checkpoint``) and then reads on from the step after
    it. With ``ckpt_at``, reports a checkpoint at that step, and behind
    the sentinel file ends its actor after that report. Raises without
    CUDA unless ``config["device"]`` names the CPU (a rehearsal)."""
    entry = time.time()
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch import tune
    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.tools.train_gang import launch_counts
    from ray_tpu_torch.train import Checkpoint

    imported = time.time()
    if config.get("device") is None and not torch.cuda.is_available():
        raise RuntimeError("18: the trial found no CUDA device")
    dev = torch.device(config.get("device") or
                       f"cuda:{torch.cuda.current_device()}")
    cuda = dev.type == "cuda"
    cfg = TUNE_GPT2_CFG or gpt2.GPT2Config.gpt2_125m()
    params = gpt2.init_params(cfg, seed=0, device=dev)
    if cuda:
        torch.cuda.synchronize()
    drawn = time.time()
    leaves = llama.param_leaves(params)
    for _, p in leaves:
        p.requires_grad_()
    opt = torch.optim.AdamW([p for _, p in leaves], lr=config["lr"],
                            weight_decay=0.01)
    built = time.time()   # a process's first optimizer imports torch._dynamo

    def state(step):
        st = opt.state
        return {"params": {n: p.detach() for n, p in leaves},
                "exp_avg": {n: st[p]["exp_avg"] for n, p in leaves},
                "exp_avg_sq": {n: st[p]["exp_avg_sq"] for n, p in leaves},
                "adam_step": {n: st[p]["step"] for n, p in leaves},
                "step": step}

    start = 0
    ckpt = tune.get_checkpoint()
    if ckpt is not None or config.get("ckpt_at") is not None:
        from ray_tpu_torch.train import dist_checkpoint as dc
    if ckpt is not None:
        for _, p in leaves:
            opt.state[p] = {"step": torch.tensor(0.0),
                            "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": torch.zeros_like(p)}
        with ckpt.as_directory() as d:
            start = dc.restore(d, like=state(None))["step"] + 1
    if cuda:
        torch.empty(1, pin_memory=True)   # the process's first pinned block
    pinned = time.time()
    ds = rdata.read_tfrecords(config["path"]).map_batches(
        _token_rows, fn_kwargs={"column": "bytes"})
    it = ds.iter_torch_batches(batch_size=config["batch"],
                               device=None if cuda else "cpu")
    try:
        for step, batch in enumerate(it):
            if step >= config["steps"]:
                break
            if step < start:
                continue   # the rows of steps trained before the resume
            if step == start:
                setup_s = time.time() - entry   # to the first batch
                parts = (imported - entry, drawn - imported,
                         built - drawn, pinned - built,
                         entry + setup_s - pinned)
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = gpt2.loss_fn(cfg, params, {"tokens": batch["tokens"]})
            loss.backward()
            opt.step()
            value = loss.item()
            if cuda:
                torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            saved = None
            if step == config.get("ckpt_at"):
                d = os.path.join(tune.get_trial_dir(), f"ckpt_{step}")
                dc.save(d, state(step))
                saved = Checkpoint.from_directory(d)
            tune.report({"loss": value, "step": step, "resumed_at": start,
                         "step_ms": step_ms, "entry": entry,
                         "setup_s": setup_s,
                         "setup_parts": parts,
                         "t": time.time(), "pid": os.getpid(),
                         "launches": launch_counts(),
                         "visible": os.environ.get("CUDA_VISIBLE_DEVICES")},
                        checkpoint=saved)
            if saved is not None and not os.path.exists(config["sentinel"]):
                open(config["sentinel"], "w").close()
                os._exit(1)
    finally:
        it.close()


def _tune_gang_loop(config) -> None:
    """18(d)'s gang worker: 18(b)'s trial in a one-worker gang (the
    gradients averaged over its NCCL group, as 15(b)), on the gang's
    Dataset shard (``get_dataset_shard("train")``, 8 rows a step); the
    trial's config (its lr) merged into the loop's by the Tuner."""
    from ray_tpu_torch import train as tr
    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.tools.train_gang import average_grads, launch_counts

    dev = torch.device(config.get("device") or
                       f"cuda:{torch.cuda.current_device()}")
    cuda = dev.type == "cuda"
    cfg = TUNE_GPT2_CFG or gpt2.GPT2Config.gpt2_125m()
    params = gpt2.init_params(cfg, seed=0, device=dev)
    leaves = llama.param_leaves(params)
    for _, p in leaves:
        p.requires_grad_()
    opt = torch.optim.AdamW([p for _, p in leaves], lr=config["lr"],
                            weight_decay=0.01)
    it = tr.get_dataset_shard("train").iter_torch_batches(
        batch_size=config["batch"], device=None if cuda else "cpu")
    try:
        for step, batch in enumerate(it):
            if step >= config["steps"]:
                break
            opt.zero_grad(set_to_none=True)
            loss = gpt2.loss_fn(cfg, params, {"tokens": batch["tokens"]})
            loss.backward()
            average_grads(opt)
            opt.step()
            tr.report({"loss": loss.item(), "step": step,
                       "launches": launch_counts(), "pid": os.getpid(),
                       "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})
    finally:
        it.close()


def _trial_launches(hists) -> dict:
    """The flash launches of every trial process: each process's last
    report (its counts are cumulative), summed."""
    last = {}
    for hist in hists:
        for m in hist:
            last[m["pid"]] = m["launches"]
    return {k: sum(n[k] for n in last.values())
            for k in ("fwd", "fwd_sm90", "dq", "dq_sm90", "dkv", "dkv_sm90")}


def _check_launches(what: str, n: dict, steps: int, L: int, per: int,
                    cuda: bool) -> None:
    want = (per * L * steps, L * steps, L * steps) if cuda else (0, 0, 0)
    check((n["fwd"], n["dq"], n["dkv"]) == want
          and (n["fwd_sm90"], n["dq_sm90"], n["dkv_sm90"]) == want,
          f"{what}: launches {n}, want {want[0]} forward and {want[1]} dQ "
          f"and dK/dV over {steps} steps, all wgmma")


def _add_launches(launches: dict, n: dict) -> None:
    """A run's wgmma launches into the kernel line's d-64/128 rows."""
    for k, key in (("flash_attention_fwd", "fwd_sm90"),
                   ("flash_attention_bwd_dq", "dq_sm90"),
                   ("flash_attention_bwd_dkv", "dkv_sm90")):
        launches[k] += n[key]


def tune_phase(dev, gpt2_losses: list) -> dict:
    """18: Data's deferred readers and Tune on the card. (a) phase 7's
    GPT-2 tokens (8 x 1025, numpy seed 0) as int64 byte records through
    ``Dataset.write_tfrecords``, a tar of ``.tokens`` members, a sqlite
    table of (step, row, blob) and a deflate Avro file, each read back
    through the port's reader and ``map_batches`` equal to the source bit
    for bit; the MB/s of a 256 MiB ``read_tfrecords`` pass (printed
    only). (b) a Tuner sweep of GPT-2 125M trials, one ``num_gpus=1``
    trial actor at a time, over ``TUNE_LRS`` under ASHA (max_t 8, grace
    2, reduction 2), each fed from a TFRecords Dataset whose steps 0-4 are
    phase 7's batch and steps 5-7 rows of numpy seed 1: the lr 3e-4
    trial's first five losses equal phase 7's bit for bit, ASHA stops a
    trial before max_t, every trial ends, and the card's memory comes
    back. (c) the lr 3e-4 trial with ``max_failures=1``: a checkpoint at
    step 3, its actor ends with ``os._exit(1)``, the retry resumes from
    ``tune.get_checkpoint()`` and its losses for steps 4-7 equal (b)'s
    bit for bit. (d) a Tuner over a ``TorchTrainer`` (one ``use_gpu``
    worker, NCCL) with ``datasets={"train": ds}``: the lr 3e-4 trial's
    final loss (step 4) equals (b)'s. Returns the trial processes'
    wgmma launches. On the CPU (a rehearsal, with ``TUNE_GPT2_CFG``
    small and ``RTPU_GPUS=1``) the trials train on the CPU."""
    import io
    import shutil
    import sqlite3
    import tarfile
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    from ray_tpu_torch import train as tr
    from ray_tpu_torch import tune
    from ray_tpu_torch.models import gpt2

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    device = None if cuda else "cpu"
    cfg = TUNE_GPT2_CFG or gpt2.GPT2Config.gpt2_125m()
    b, s = GANG_GPT2
    L, per = cfg.num_layers, 2 if cfg.remat else 1
    toks7 = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s + 1))
    fresh = np.random.default_rng(1).integers(
        0, cfg.vocab_size, ((TUNE_MAX_T - 5) * b, s + 1))
    rows = np.concatenate([toks7] * 5 + [fresh])
    launches = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
                "flash_attention_bwd_dkv": 0}
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free0 = torch.cuda.mem_get_info()[0]
    rt.init(num_workers=4, object_store_memory=TUNE_STORE_BYTES)
    work = tempfile.mkdtemp(prefix="rtpt_tune_")
    try:
        # (a) four readers the card's machine can run, bit for bit
        recs = [r.tobytes() for r in toks7]
        got = {}
        rd.from_items([{"bytes": r} for r in recs], parallelism=1) \
            .write_tfrecords(os.path.join(work, "tfr"))
        got["tfrecords"] = rd.read_tfrecords(os.path.join(work, "tfr")) \
            .map_batches(_token_rows, fn_kwargs={"column": "bytes"})
        tar = os.path.join(work, "shard-000000.tar")
        with tarfile.open(tar, "w") as f:
            for i, r in enumerate(recs):
                info = tarfile.TarInfo(f"row{i:05d}.tokens")
                info.size = len(r)
                f.addfile(info, io.BytesIO(r))
        got["webdataset"] = rd.read_webdataset(tar).map_batches(
            _token_rows, fn_kwargs={"column": "tokens"})
        db = os.path.join(work, "tokens.db")
        conn = sqlite3.connect(db)
        with conn:   # commits
            conn.execute("CREATE TABLE t (step INTEGER, row INTEGER, "
                         "tokens BLOB)")
            conn.executemany("INSERT INTO t VALUES (?, ?, ?)",
                             [(0, i, r) for i, r in enumerate(recs)])
        conn.close()
        got["sql"] = rd.read_sql(
            "SELECT step, row, tokens FROM t ORDER BY step, row",
            lambda: sqlite3.connect(db)).map_batches(
                _token_rows, fn_kwargs={"column": "tokens"})
        avro = os.path.join(work, "tokens.avro")
        _write_avro_deflate(avro, toks7)
        got["avro"] = rd.read_avro(avro).map_batches(
            _token_rows, fn_kwargs={"column": "tokens"})
        for name, ds in got.items():
            back = np.concatenate([x["tokens"] for x in ds.iter_batches(
                batch_size=None, prefetch_batches=0)])
            check(back.dtype == toks7.dtype and np.array_equal(back, toks7),
                  f"18(a): {name} read back {back.dtype} {back.shape}, not "
                  f"phase 7's tokens bit for bit")
        with open(os.path.join(work, "tfr", "part-00000.tfrecords"),
                  "rb") as f:
            frames = f.read()
        reps = READ_BYTES // len(frames)
        os.makedirs(os.path.join(work, "big"))
        big = os.path.join(work, "big", "part.tfrecords")
        with open(big, "wb") as f:
            for _ in range(reps):
                f.write(frames)
        size = os.path.getsize(big)
        t0 = time.perf_counter()
        n_recs = sum(len(x["bytes"]) for x in rd.read_tfrecords(big)
                     .iter_batches(batch_size=None, prefetch_batches=0))
        read_s = time.perf_counter() - t0
        check(n_recs == reps * b, f"18(a): the timed pass read {n_recs} "
                                  f"records, not {reps * b}")
        print(f"  (a) phase 7's tokens ({b} x {s + 1} int64) through "
              f"write_tfrecords/read_tfrecords, a webdataset tar, sqlite "
              f"(read_sql) and a deflate Avro file (read_avro), each with "
              f"map_batches: equal to the source bit for bit; a "
              f"{size / 2**20:.0f} MiB read_tfrecords pass ({n_recs} "
              f"records, one file, the page cache warm) in {read_s:.3f} s: "
              f"{size / read_s / 1e6:.1f} MB/s (information only); "
              f"{smi_line() if cuda else 'cpu'}", flush=True)
        print("  (a) not run here: read_images (needs PIL), "
              "from_huggingface/read_huggingface, read_delta, read_iceberg "
              "and read_bigquery (need pyarrow; BigQuery a client too): "
              "this machine has neither pyarrow, PIL nor pandas; "
              "tests/test_torch_data.py holds them to ray_tpu.data on the "
              "CPU", flush=True)
        del got, frames
        os.remove(big)

        # (b) the sweep
        path = os.path.join(work, "steps")
        rd.from_items([{"bytes": r.tobytes()} for r in rows],
                      parallelism=1).write_tfrecords(path)
        ds = rd.read_tfrecords(path).map_batches(
            _token_rows, fn_kwargs={"column": "bytes"})
        it = ds.iter_torch_batches(batch_size=b, device=device)
        first = next(iter(it))["tokens"]
        it.close()
        check(np.array_equal(first.cpu().numpy(), toks7),
              "18(b): the Dataset's first batch is not phase 7's tokens")
        base = {"path": path, "batch": b, "device": device}
        wall0, t0 = time.time(), time.perf_counter()
        grid = tune.Tuner(
            _tune_gpt2_trial,
            param_space=dict(base, lr=tune.grid_search(TUNE_LRS),
                             steps=TUNE_MAX_T),
            tune_config=tune.TuneConfig(
                metric="loss", mode="min",
                scheduler=tune.ASHAScheduler(
                    max_t=TUNE_MAX_T, grace_period=TUNE_GRACE,
                    reduction_factor=TUNE_ETA),
                max_concurrent_trials=1, trial_resources={"num_gpus": 1}),
            run_config=tr.RunConfig(storage_path=work, name="sweep")).fit()
        sweep_s = time.perf_counter() - t0
        check(not grid.errors, f"18(b): trials failed: {grid.errors}")
        trials = grid._trials
        hists = [t.metric_history for t in trials]
        prev = wall0
        for t, hist in zip(trials, hists):
            losses = [m["loss"] for m in hist]
            steps_ms = [m["step_ms"] for m in hist]
            ready_ms = (hist[0]["entry"] - prev) * 1e3 if hist else 0.0
            prev = hist[-1]["t"] if hist else prev
            fate = (f"stopped by ASHA at rung {t.iterations}"
                    if t.iterations < TUNE_MAX_T else "ran to max_t")
            print(f"  (b) lr {t.config['lr']:g}: {t.status.value} after "
                  f"{t.iterations} iterations ({fate}), last loss "
                  f"{losses[-1]:.4f}; losses "
                  f"{' '.join(f'{x:.4f}' for x in losses)}; trainable "
                  f"began {ready_ms:.0f} ms after the previous trial's last "
                  f"report (fit()'s start for the first): the actor's "
                  f"ready time; its first batch in hand "
                  f"{hist[0]['setup_s']:.2f} s later (imports, params "
                  f"on the device, AdamW, the first pinned block (a "
                  f"checkpoint's restore), the Dataset's first batch: "
                  f"{' '.join(f'{x:.2f}' for x in hist[0]['setup_parts'])}"
                  f" s); step "
                  f"{statistics.median(steps_ms[1:] or steps_ms):.1f} ms "
                  f"(median after the first, {steps_ms[0]:.1f} ms first); "
                  f"CUDA_VISIBLE_DEVICES {hist[0]['visible']!r}",
                  flush=True)
        best = grid.get_best_result()
        n = _trial_launches(hists)
        n_steps = sum(len(h) for h in hists)
        print(f"  (b) best: lr {best.config['lr']:g} (loss "
              f"{best.metrics['loss']:.4f}); {n_steps} steps over "
              f"{len(trials)} trials in {sweep_s:.1f} s; launches in the "
              f"trials: flash forward {n['fwd']} (wgmma {n['fwd_sm90']}), "
              f"dQ {n['dq']} (wgmma {n['dq_sm90']}), dK/dV {n['dkv']} "
              f"(wgmma {n['dkv_sm90']})", flush=True)
        ref = trials[TUNE_LRS.index(3e-4)]
        sweep_losses = [m["loss"] for m in ref.metric_history]
        check(sweep_losses[:5] == gpt2_losses[:5],
              f"18(b): the lr 3e-4 trial's first losses {sweep_losses[:5]} "
              f"are not phase 7's {gpt2_losses[:5]} bit for bit")
        check(all(t.status.value == "TERMINATED" for t in trials),
              f"18(b): trials did not end: "
              f"{[t.status.value for t in trials]}")
        check(any(t.iterations < TUNE_MAX_T for t in trials),
              f"18(b): ASHA stopped no trial: "
              f"{[t.iterations for t in trials]}")
        _check_launches("18(b)", n, n_steps, L, per, cuda)
        _add_launches(launches, n)

        # (c) the lr 3e-4 trial dies after step 3's checkpoint, resumes
        sentinel = os.path.join(work, "died")
        wall0 = time.time()
        grid = tune.Tuner(
            _tune_gpt2_trial,
            param_space=dict(base, lr=3e-4, steps=TUNE_RESUME_STEPS,
                             ckpt_at=TUNE_CKPT_AT, sentinel=sentinel),
            tune_config=tune.TuneConfig(metric="loss", mode="min",
                                        trial_resources={"num_gpus": 1}),
            run_config=tr.RunConfig(
                storage_path=work, name="resume",
                failure_config=tr.FailureConfig(max_failures=1))).fit()
        check(not grid.errors, f"18(c): the trial failed: {grid.errors}")
        (trial,) = grid._trials
        hist = trial.metric_history
        pids = [m["pid"] for m in hist]
        steps = [m["step"] for m in hist]
        resumed = [m for m in hist if m["resumed_at"] > 0]
        got = [m["loss"] for m in resumed]
        want = sweep_losses[TUNE_CKPT_AT + 1:TUNE_RESUME_STEPS]
        died_at = hist[TUNE_CKPT_AT]["t"]
        back_s = resumed[0]["t"] - died_at if resumed else float("nan")
        print(f"  (c) lr 3e-4 with max_failures=1: steps {steps}, pids "
              f"{pids}, resumed at {resumed[0]['resumed_at'] if resumed else None}"
              f"; the retry reported {back_s:.1f} s after the step-"
              f"{TUNE_CKPT_AT} report its actor died after (its trainable "
              f"began {resumed[0]['entry'] - died_at if resumed else 0:.1f} "
              f"s after, its first batch in hand, the checkpoint restored, "
              f"{resumed[0]['setup_s'] if resumed else 0:.2f} s later); "
              f"resumed losses "
              f"{' '.join(f'{x:.4f}' for x in got)} against (b)'s "
              f"{' '.join(f'{x:.4f}' for x in want)} (bit for bit "
              f"{got == want}); num_failures {trial.num_failures}",
              flush=True)
        check(steps == list(range(TUNE_RESUME_STEPS))
              and len(set(pids[:TUNE_CKPT_AT + 1])) == 1
              and pids[TUNE_CKPT_AT + 1] != pids[TUNE_CKPT_AT]
              and trial.num_failures == 1,
              f"18(c): steps {steps}, pids {pids}, failures "
              f"{trial.num_failures}: the actor did not die and resume")
        check(got == want, f"18(c): resumed losses {got} are not (b)'s "
                           f"{want} bit for bit")
        n = _trial_launches([hist])
        _check_launches("18(c)", n, len(hist), L, per, cuda)
        _add_launches(launches, n)

        # (d) a Tuner over a TorchTrainer fed by the same Dataset
        gang_ds = rd.read_tfrecords(path).map_batches(
            _token_rows, fn_kwargs={"column": "bytes"}).limit(
                TUNE_GANG_STEPS * b)
        trainer = tr.TorchTrainer(
            _tune_gang_loop,
            train_loop_config={"batch": b, "steps": TUNE_GANG_STEPS,
                               "device": device},
            torch_config=tr.TorchConfig(device=device, distributed=True,
                                        timeout_s=600.0),
            scaling_config=tr.ScalingConfig(num_workers=1, use_gpu=cuda),
            datasets={"train": gang_ds})
        t0 = time.perf_counter()
        grid = tune.Tuner(
            trainer, param_space={"lr": tune.grid_search(TUNE_GANG_LRS)},
            tune_config=tune.TuneConfig(metric="loss", mode="min",
                                        max_concurrent_trials=1),
            run_config=tr.RunConfig(storage_path=work, name="gang")).fit()
        gang_s = time.perf_counter() - t0
        check(not grid.errors, f"18(d): the gang trials failed: "
                               f"{grid.errors}")
        finals = [t.last_result for t in grid._trials]
        want = sweep_losses[TUNE_GANG_STEPS - 1]
        got = finals[0].get("loss")
        print(f"  (d) Tuner over TorchTrainer (one "
              f"{'use_gpu worker, NCCL' if cuda else 'CPU worker, gloo'}, "
              f"datasets={{'train': ds}}): lr 3e-4 loss at step "
              f"{finals[0].get('step')} {got:.4f} against (b)'s "
              f"{want:.4f} (bit for bit {got == want}); the gang's "
              f"CUDA_VISIBLE_DEVICES {finals[0].get('visible')!r}; "
              f"{gang_s:.1f} s", flush=True)
        check(got == want and finals[0].get("step") == TUNE_GANG_STEPS - 1,
              f"18(d): the gang trial's loss {got} at step "
              f"{finals[0].get('step')} is not (b)'s {want}")
        n = {k: sum(f["launches"][k] for f in finals)
             for k in finals[0]["launches"]}
        _check_launches("18(d)", n, len(finals) * TUNE_GANG_STEPS, L, per,
                        cuda)
        _add_launches(launches, n)
    finally:
        rt.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    if cuda:
        # every trial actor and gang worker is gone, its context with it
        deadline = time.monotonic() + 60
        while True:
            free = torch.cuda.mem_get_info()[0]
            if free >= free0 - (1 << 30) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        check(free >= free0 - (1 << 30),
              f"18(b): after the sweeps the card has {free / 2**30:.2f} GiB "
              f"free, {free0 / 2**30:.2f} before")
        print(f"  after shutdown(): {free / 2**30:.2f} GiB free on the "
              f"card, {free0 / 2**30:.2f} before", flush=True)
    print(f"  phase 18 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# ------------------------------------------------------------- phase 19

RL_STORE_BYTES = 256 << 20
# the reference's learning bars (tests/test_rllib.py) and budgets
PPO_CATCH_BAR, PPO_CATCH_ITERS = 0.6, 40
IMPALA_CATCH_BAR, IMPALA_CATCH_ITERS = 0.5, 60
RL_HELD_UPDATES = 3   # PPO updates held to a CPU learner


class _Clock:
    """Wall seconds of a learner's calls, by method name: wraps
    ``obj.<name>`` for each name, each call ending in the host (the
    weights come back as numpy, the metrics as floats)."""

    def __init__(self, obj, *names):
        self.s = {n: [] for n in names}
        for n in names:
            fn = getattr(obj, n)
            setattr(obj, n, self._wrap(n, fn))

    def _wrap(self, name, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.s[name].append(time.perf_counter() - t0)
            return out
        return timed

    def take(self) -> dict:
        """The seconds each method took since the last take."""
        out = {n: sum(v) for n, v in self.s.items()}
        out.update({f"n_{n}": len(v) for n, v in self.s.items()})
        for v in self.s.values():
            v.clear()
        return out


def _rl_visible_runner():
    """The EnvRunner class with one more method: what its worker sees of
    the card."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib.env_runner import EnvRunner

    class VisibleRunner(EnvRunner._cls):
        def visible(self):
            import os as _os

            import torch as _torch
            return (_os.environ.get("CUDA_VISIBLE_DEVICES"),
                    _torch.cuda.is_available())

    return rt.remote(VisibleRunner)


def _same_batch(got: dict, want: dict) -> bool:
    return sorted(got) == sorted(want) and all(
        np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
        and np.array_equal(got[k], want[k]) for k in want)


def _on(module, dev) -> bool:
    return all(p.device.type == dev.type for p in module.parameters())


def _split_line(r: dict, c: dict, what: str = "update") -> str:
    wall = r["time_this_iter_s"]
    other = wall - c["get_weights"] - c[what]
    return (f"{wall * 1e3:.1f} ms (weights' host copy {c['get_weights'] * 1e3:.2f}"
            f" ms x {c['n_get_weights']}, {what} {c[what] * 1e3:.1f} ms x "
            f"{c['n_' + what]}, sampling and the rest {other * 1e3:.1f} ms)")


def rl_drivers_phase(dev) -> dict:
    """19: the RLlib drivers on the card, the runtime started afresh.
    Learners on ``dev`` (``learners(device=None)`` on the card), runners
    plain CPU actors. (a) an ``EnvRunner`` (the conv module on Catch) and
    an ``OffPolicyRunner`` of each kind (DQN on CartPole, SAC on
    Pendulum) given a card learner's weights return, bit for bit, the
    batches the same runner code computes in this process from the same
    seed; the runners' worker sees ``CUDA_VISIBLE_DEVICES=""`` and no
    card. (b) ``tests/test_rllib.py::test_ppo_cnn_learns_pixel_catch``'s
    program: PPO on CatchPixels-v0, 2 runners x 16 envs x 64 steps, lr
    1e-3, seed 0, reaches an ``episode_return_mean`` of 0.6 within 40
    iterations, the learner's module the port's ``CNNModule`` on the
    card; each of the first 3 updates is held to a CPU learner started
    from the card learner's state on the same batch and permutations
    (losses at rtol 1e-4, as phase 10). (c)
    ``test_impala_cnn_learns_pixel_catch``'s program: IMPALA reaches 0.5
    within 60 iterations, every runner with one sample in flight after
    each ``train()``. (d) APPO on Catch, DQN uniform and prioritized on
    CartPole, SAC on Pendulum: 3 iterations past ``learning_starts``,
    finite losses, the learners' parameters on the card, prioritized
    replay's priorities moved by the TD errors. (e) ``MultiAgentPPO`` on
    Coordination-v0 with two policies, one of them in
    ``policies_to_train``: the frozen policy's weights stay equal bit for
    bit, the trained one's move. (f) DreamerV3 on CartPole, 8 envs,
    ``learning_starts`` 256, 3 iterations of 32 steps: every ``act`` and
    update on the card, finite metrics. ms an iteration and its split
    (the weights' host copy, the updates, the rest: sampling and the
    object store), env steps/s; DreamerV3's ms an ``act`` and an update.
    ``stop()`` kills the runners; no attention kernel launches; the
    card's free memory is back after ``shutdown()``. Returns each
    driver's median seconds an iteration. On the CPU (a rehearsal) the
    learners run there."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib import env_runner, learner, rl_module

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    device = None if cuda else "cpu"
    times = {}
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free0 = torch.cuda.mem_get_info()[0]
    counters_reset()
    rt.init(num_workers=4, object_store_memory=RL_STORE_BYTES)
    try:
        # every runner actor is made up front, each a process that
        # imports torch: they start side by side while the phase runs
        t_build = time.perf_counter()
        catch_spec = rllib.algorithm.module_spec_of(
            rllib.envs.make_env("CatchPixels-v0", 1), (64, 64))
        pv = learner.PPOLearner(rl_module.build_pv_module(catch_spec),
                                seed=0, device=device)
        dqn_spec = {"obs_dim": 4, "num_actions": 2,
                    "hidden": rllib.DQNConfig().module_hidden}
        ql = rllib.dqn.DQNLearner(rl_module.QMLPModule(**dqn_spec),
                                  seed=0, device=device)
        sac_spec = {"obs_dim": 3, "action_dim": 1, "action_low": -2.0,
                    "action_high": 2.0, "hidden": (128, 128)}
        sl = rllib.sac.SACLearner(
            rl_module.SquashedGaussianModule(**sac_spec),
            rl_module.TwinQModule(3, 1), seed=0, device=device)
        check(all(_on(m, dev) for m in (pv.module, ql.module, sl.actor,
                                       sl.critic)),
              "19(a): a learner's parameters are not on the card")
        runner_cls = _rl_visible_runner()
        cases = [
            ("EnvRunner (CNN, Catch)", runner_cls, env_runner.EnvRunner._cls,
             ("CatchPixels-v0", 16, 64, catch_spec), {"seed": 0},
             pv.get_weights(), [("sample", ()), ("sample_sequences", ()),
                                ("evaluate", (4,))]),
            ("OffPolicyRunner (DQN, CartPole)", env_runner.OffPolicyRunner,
             env_runner.OffPolicyRunner._cls,
             ("CartPole-v1", 8, dqn_spec), {"kind": "dqn", "seed": 0},
             ql.get_weights(), [("sample_transitions", (64, 0.3)),
                                ("evaluate", (4,))]),
            ("OffPolicyRunner (SAC, Pendulum)", env_runner.OffPolicyRunner,
             env_runner.OffPolicyRunner._cls,
             ("Pendulum-v1", 8, sac_spec), {"kind": "sac", "seed": 0},
             sl.get_weights(), [("sample_transitions", (64,)),
                                ("evaluate", (2,))])]
        actors = [actor_cls.remote(*args, **kw)
                  for _, actor_cls, _, args, kw, _, _ in cases]

        ppo_cfg = (rllib.PPOConfig().environment("CatchPixels-v0")
                   .env_runners(num_env_runners=2,
                                num_envs_per_env_runner=16,
                                rollout_fragment_length=64)
                   .training(lr=1e-3, gamma=0.99).debugging(seed=0)
                   .learners(device=device))
        impala_cfg = (rllib.IMPALAConfig().environment("CatchPixels-v0")
                      .env_runners(num_env_runners=2,
                                   num_envs_per_env_runner=16,
                                   rollout_fragment_length=32)
                      .training(lr=1e-3, gamma=0.99).debugging(seed=0)
                      .learners(device=device))

        def dqn(prioritized):
            c = (rllib.DQNConfig().environment("CartPole-v1")
                 .debugging(seed=0).learners(device=device))
            c.train_kwargs.update(learning_starts=1024,
                                  prioritized_replay=prioritized)
            return c

        sac_cfg = (rllib.SACConfig().environment("Pendulum-v1")
                   .debugging(seed=0).learners(device=device))
        sac_cfg.train_kwargs.update(learning_starts=512)
        ma_cfg = (rllib.MultiAgentPPOConfig().environment("Coordination-v0")
                  .env_runners(num_env_runners=2, num_envs_per_env_runner=16,
                               rollout_fragment_length=32)
                  .training(lr=3e-4, gamma=0.95).debugging(seed=0)
                  .multi_agent(policies=["p0", "p1"],
                               policy_mapping_fn=lambda a: (
                                   "p0" if a == "a0" else "p1"),
                               policies_to_train=["p0"])
                  .learners(device=device))
        algos = {
            "PPO (Catch)": ppo_cfg.build(),
            "IMPALA (Catch)": impala_cfg.build(),
            "APPO (Catch)": (rllib.APPOConfig()
                             .environment("CatchPixels-v0")
                             .env_runners(num_env_runners=2,
                                          num_envs_per_env_runner=16,
                                          rollout_fragment_length=32)
                             .debugging(seed=0).learners(device=device)
                             .build()),
            "DQN (CartPole)": dqn(False).build(),
            "DQN prioritized (CartPole)": dqn(True).build(),
            "SAC (Pendulum)": sac_cfg.build(),
            "MultiAgentPPO (Coordination)": ma_cfg.build()}
        n_actors = len(actors) + sum(len(a.runners) for a in algos.values())
        print(f"  {n_actors} runner actors made and 7 drivers built in "
              f"{time.perf_counter() - t_build:.2f} s (their processes "
              f"start meanwhile)", flush=True)

        # (a) runners on the card learner's weights, against the same
        # runner code in this process
        for actor, (what, actor_cls, cls, args, kw, w, calls) in zip(
                actors, cases):
            threads = torch.get_num_threads()
            local = cls(*args, **kw)
            torch.set_num_threads(threads)   # a runner takes one
            w_ref = rt.put(w)
            t0 = time.perf_counter()
            remote = [rt.get(getattr(actor, m).remote(w_ref, *a),
                             timeout=300) for m, a in calls]
            actor_s = time.perf_counter() - t0
            here = [getattr(local, m)(w, *a) for m, a in calls]
            same = [(_same_batch(g, h) if isinstance(h, dict) else g == h)
                    for g, h in zip(remote, here)]
            check(all(same), f"19(a): {what}: {calls} from the actor equal "
                             f"to the driver process's: {same}")
            extra = ""
            if actor_cls is runner_cls:
                seen = rt.get(actor.visible.remote(), timeout=60)
                check(seen == ("", False), f"19(a): a runner's worker sees "
                                           f"CUDA_VISIBLE_DEVICES, CUDA "
                                           f"{seen}")
                extra = f"; the worker's CUDA_VISIBLE_DEVICES, CUDA {seen}"
            rt.kill(actor)
            print(f"  (a) {what}: {', '.join(m for m, _ in calls)} equal "
                  f"bit for bit to the driver process's ({actor_s:.2f} s "
                  f"in the actor, {time.perf_counter() - t_build:.2f} s "
                  f"after it was made){extra}", flush=True)
        del pv, ql, sl

        # (b) PPO learns pixel Catch
        cfg, algo = ppo_cfg, algos.pop("PPO (Catch)")
        lrn = algo.learner
        check(isinstance(lrn.module, rl_module.CNNModule)
              and _on(lrn.module, dev),
              f"19(b): the learner's module is {type(lrn.module).__name__} "
              f"on {next(lrn.module.parameters()).device}")
        kw = dict(cfg.train_kwargs)
        kw.pop("lam")
        anchor = learner.PPOLearner(
            rl_module.build_pv_module(algo.module_spec), lr=cfg.lr,
            seed=cfg.seed, device="cpu", **kw)
        clock = _Clock(lrn, "get_weights", "update")
        perm_rng = np.random.default_rng(19)
        held, update = [], lrn.update
        deterministic = torch.backends.cudnn.deterministic

        def held_update(batch, perms=None):
            if len(held) >= RL_HELD_UPDATES:
                return update(batch)
            n, mb, E = len(batch["obs"]), kw["minibatch_size"], \
                kw["num_epochs"]
            perms = np.stack([perm_rng.permutation(n)[: n // mb * mb]
                              for _ in range(E)]).reshape(E, n // mb, mb)
            _rl_copy_state(anchor, lrn)
            # cuDNN's deterministic algorithms, as phase 10's held
            # updates run: a non-deterministic weight gradient moved one
            # run's third update past rtol 1e-4 (a clipped ratio
            # switching branch by rounding)
            torch.backends.cudnn.deterministic = True
            try:
                mc = update(batch, perms=perms)
            finally:
                torch.backends.cudnn.deterministic = deterministic
            mp = anchor.update(batch, perms=perms)
            held.append(max(abs(mc[k] - mp[k]) / max(abs(mp[k]), 1e-30)
                            for k in mp))
            for k in mp:
                check(abs(mc[k] - mp[k]) <= 1e-4 * abs(mp[k]),
                      f"19(b): update {len(held)} {k} {mc[k]} on the card, "
                      f"{mp[k]} on the CPU from the same state")
            return mc

        lrn.update = held_update
        best, its, walls = -1.0, 0, []
        try:
            for its in range(1, PPO_CATCH_ITERS + 1):
                r = algo.train()
                c = clock.take()
                best = max(best, r["episode_return_mean"])
                steps = 2 * 16 * 64
                walls.append(r["time_this_iter_s"])
                print(f"  (b) PPO iteration {its}: return mean "
                      f"{r['episode_return_mean']:.3f}, "
                      f"{_split_line(r, c)}, "
                      f"{steps / r['time_this_iter_s']:.0f} env steps/s",
                      flush=True)
                if best >= PPO_CATCH_BAR:
                    break
            runner0 = algo.runners[0]
        finally:
            algo.stop()
        check(best >= PPO_CATCH_BAR, f"19(b): pixel PPO reached {best:.3f} "
                                     f"in {its} iterations, not "
                                     f"{PPO_CATCH_BAR}")
        try:
            rt.get(runner0.sample.remote(anchor.get_weights()), timeout=60)
            dead = "alive"
        except rt.exceptions.ActorDiedError:
            dead = "ActorDiedError"
        check(dead == "ActorDiedError", f"19(b): after stop() a runner is "
                                        f"{dead}")
        # the held iterations' walls include the CPU learner's update
        times["PPO (Catch)"] = statistics.median(
            walls[RL_HELD_UPDATES:] or walls)
        print(f"  (b) PPO on pixel Catch: best return mean {best:.3f} in "
              f"{its} iterations (bar {PPO_CATCH_BAR}); the first "
              f"{len(held)} updates held to a CPU learner: max rel |d "
              f"loss| {max(held):.3e}; ms an iteration p50 "
              f"{times['PPO (Catch)'] * 1e3:.1f}, the first "
              f"{walls[0] * 1e3:.1f}; after stop() a runner call raises "
              f"{dead}", flush=True)
        del algo, lrn, anchor

        # (c) IMPALA learns pixel Catch
        algo = algos.pop("IMPALA (Catch)")
        check(isinstance(algo.learner.module, rl_module.CNNModule)
              and _on(algo.learner.module, dev),
              "19(c): the learner is not the conv module on the card")
        clock = _Clock(algo.learner, "get_weights", "update")
        best, its, walls, flight = -1.0, 0, [], []
        try:
            for its in range(1, IMPALA_CATCH_ITERS + 1):
                r = algo.train()
                c = clock.take()
                flight.append(len(algo._inflight) == 2 and set(
                    map(id, algo._inflight.values())) == set(
                        map(id, algo.runners)))
                best = max(best, r["episode_return_mean"])
                walls.append(r["time_this_iter_s"])
                if its % 5 == 1 or best >= IMPALA_CATCH_BAR:
                    print(f"  (c) IMPALA iteration {its}: return mean "
                          f"{r['episode_return_mean']:.3f}, "
                          f"{_split_line(r, c)}, "
                          f"{8 * 32 * 16 / r['time_this_iter_s']:.0f} env "
                          f"steps/s", flush=True)
                if best >= IMPALA_CATCH_BAR:
                    break
        finally:
            algo.stop()
        check(all(flight), f"19(c): a runner without exactly one sample in "
                           f"flight after train(): {flight}")
        check(best >= IMPALA_CATCH_BAR, f"19(c): pixel IMPALA reached "
                                        f"{best:.3f} in {its} iterations, "
                                        f"not {IMPALA_CATCH_BAR}")
        times["IMPALA (Catch)"] = statistics.median(walls[1:] or walls)
        print(f"  (c) IMPALA on pixel Catch: best return mean {best:.3f} "
              f"in {its} iterations (bar {IMPALA_CATCH_BAR}); one sample "
              f"in flight a runner after every train(); ms an iteration "
              f"p50 {times['IMPALA (Catch)'] * 1e3:.1f}", flush=True)
        del algo

        # (d) the other drivers, 3 iterations past learning_starts
        others = [("APPO (Catch)", "update", "pg_loss"),
                  ("DQN (CartPole)", "update_many", "loss"),
                  ("DQN prioritized (CartPole)", "update_many", "loss"),
                  ("SAC (Pendulum)", "update_many", "q_loss")]
        for what, upd, key in others:
            algo = algos.pop(what)
            lrn = algo.learner
            mods = [lrn.actor, lrn.critic] if hasattr(lrn, "critic") \
                else [lrn.module]
            check(all(_on(m, dev) for m in mods),
                  f"19(d): {what}: the learner's parameters are not on "
                  f"{dev}")
            clock = _Clock(lrn, "get_weights", upd)
            before, rows, walls = [], [], []
            try:
                while len(rows) < 3 and len(before) < 10:
                    r = algo.train()
                    c = clock.take()
                    if c["n_" + upd] == 0:
                        before.append(r)
                        continue
                    rows.append(r)
                    walls.append(r["time_this_iter_s"])
                    print(f"  (d) {what} iteration "
                          f"{r['training_iteration']}: {key} {r[key]:.4f}, "
                          f"{_split_line(r, c, upd)}", flush=True)
                buf = getattr(algo, "buffer", None)
                prio = (buf._prio[:len(buf)].copy()
                        if hasattr(buf, "_prio") else None)
            finally:
                algo.stop()
            losses = [v for r in rows for k, v in r.items()
                      if k.endswith("loss")]
            check(len(rows) == 3 and all(np.isfinite(losses)),
                  f"19(d): {what}: {len(rows)} iterations past "
                  f"learning_starts, losses {losses}")
            if what.startswith("DQN"):
                check(len(before) >= 1 and all(np.isnan(r["loss"])
                                               for r in before),
                      f"19(d): {what}: the iterations before "
                      f"learning_starts report {before}")
            if prio is not None:
                moved = int((prio != 1.0).sum())
                check(moved > 0 and len(np.unique(prio)) > 1,
                      f"19(d): {what}: no priority moved by the TD errors")
                print(f"  (d) {what}: {moved} of {len(prio)} priorities "
                      f"set from TD errors (max {prio.max():.3f})",
                      flush=True)
            times[what] = statistics.median(walls)
            del algo, lrn

        # (e) multi-agent PPO with a frozen policy
        algo = algos.pop("MultiAgentPPO (Coordination)")
        lrns = algo.learners
        check(all(_on(ln.module, dev) for ln in lrns.values()),
              "19(e): a policy's learner is not on the card")
        w0 = {pid: rl_module.tree_leaves(ln.get_weights())
              for pid, ln in lrns.items()}
        walls = []
        try:
            for _ in range(3):
                r = algo.train()
                walls.append(r["time_this_iter_s"])
            ret = algo.evaluate()
        finally:
            algo.stop()
        w1 = {pid: rl_module.tree_leaves(ln.get_weights())
              for pid, ln in lrns.items()}
        frozen = all(np.array_equal(w1["p1"][k], w0["p1"][k])
                     for k in w0["p1"])
        moved = sum(not np.array_equal(w1["p0"][k], w0["p0"][k])
                    for k in w0["p0"])
        check(frozen and moved > 0 and not any(k.startswith("p1/")
                                               for k in r),
              f"19(e): frozen p1 equal {frozen}, {moved} leaves of p0 moved, "
              f"keys {sorted(r)}")
        times["MultiAgentPPO (Coordination)"] = statistics.median(walls)
        print(f"  (e) MultiAgentPPO, p0 trained, p1 frozen: p1's weights "
              f"equal bit for bit after 3 iterations, {moved} of "
              f"{len(w0['p0'])} leaves of p0 moved; p0 pg_loss "
              f"{r['p0/pg_loss']:.4f}; greedy return {ret:.2f}", flush=True)
        del algo, lrns

        # (f) DreamerV3 on CartPole, in this process
        cfg = (rllib.DreamerV3Config().environment("CartPole-v1")
               .env_runners(num_envs_per_env_runner=8).debugging(seed=0)
               .learners(device=device))
        cfg.train_kwargs.update(learning_starts=256, steps_per_iter=32)
        algo = cfg.build()
        lrn = algo.learner
        check(lrn.device.type == dev.type and _on(lrn.wm, dev)
              and _on(lrn.ac, dev),
              f"19(f): the DreamerV3 learner is on {lrn.device}")
        clock = _Clock(lrn, "act", "update")
        rows = []
        for _ in range(3):
            rows.append((algo.train(), clock.take()))
        metrics = [v for r, _ in rows for k, v in r.items()
                   if k not in ("iteration", "env_steps")]
        check(all(np.isfinite(metrics)) and rows[-1][1]["n_update"] > 0,
              f"19(f): DreamerV3 metrics {rows}")
        acts = sum(c["act"] for _, c in rows) / sum(c["n_act"]
                                                   for _, c in rows)
        ups = sum(c["update"] for _, c in rows) / sum(c["n_update"]
                                                     for _, c in rows)
        for r, c in rows:
            print(f"  (f) DreamerV3 iteration {r['iteration']}: "
                  f"{c['n_act']} acts, {c['n_update']} updates, wm_loss "
                  f"{r.get('wm_loss', float('nan')):.4f}", flush=True)
        print(f"  (f) DreamerV3: {acts * 1e3:.3f} ms an act (8 envs), "
              f"{ups * 1e3:.3f} ms an update (batch 8 x 16)", flush=True)
        algo.stop()
        del algo, lrn
    finally:
        rt.shutdown()
    n = counters()
    check(not any(n.values()), f"19: attention kernels launched: {n}")
    for what, s in times.items():
        print(f"  {what}: {s * 1e3:.1f} ms an iteration (p50)", flush=True)
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        deadline = time.monotonic() + 60
        while True:
            free = torch.cuda.mem_get_info()[0]
            if free >= free0 - (1 << 30) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        check(free >= free0 - (1 << 30),
              f"19: after shutdown() the card has {free / 2**30:.2f} GiB "
              f"free, {free0 / 2**30:.2f} before")
        print(f"  after shutdown(): {free / 2**30:.2f} GiB free on the "
              f"card, {free0 / 2**30:.2f} before", flush=True)
    print(f"  phase 19 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return times


# ---------------------------------------------------------------- phase 20

# 20(c): the tensor the GPU actor hands back, and the node servers'
# stores, each able to hold it twice
CLUSTER_BIG_BYTES = 1 << 30
CLUSTER_STORE_BYTES = 2 * CLUSTER_BIG_BYTES + (256 << 20)
# 20(d): how long the card may take to get back the memory the GPU actor
# held once its node is SIGKILLed, and how much of it may stay missing
FREED_WITHIN_S, FREED_SLACK_BYTES = 30.0, 1 << 30
# 20(f): the reference test's episodes and bars
POLICY_EPISODES, POLICY_MIN_UPDATES, POLICY_MIN_EPISODES = 300, 10, 40
# 14(b)'s put rate, printed beside 20(c)'s pull
PHASE14_PUT: dict = {}


class ClusterReplica(EngineReplica):
    """Phase 20's GPU actor: phase 14's replica, which also takes its
    requests from an object (``load``: on another node, so a cross-node
    fetch), serves a loaded wave (``submit_wave``), and hands back a
    tensor made on its card through its own ``put`` (``big``)."""

    def load(self, waves) -> list:
        self.waves = waves
        return [len(w) for w in waves]

    def submit_wave(self, i: int) -> None:
        for rid, prompt in self.waves[i]:
            self.submit(rid, prompt, hold=True)

    def big(self, nbytes: int, seed: int) -> tuple:
        import ray_tpu_torch as rt

        g = torch.Generator(device=self.dev).manual_seed(seed)
        t = torch.randint(-2**15, 2**15, (nbytes // 2,), dtype=torch.int16,
                          device=self.dev, generator=g).view(torch.bfloat16)
        digest = _sha256(t.view(torch.int16).cpu())
        return [rt.put(t)], digest, str(t.device)


def _sha256(t: torch.Tensor) -> str:
    """sha256 of a contiguous CPU tensor's bytes, read in place. A
    ``tobytes()`` copy of 1 GiB holds the GIL for seconds, long enough on
    a loaded host for the driver to miss its GCS heartbeats and be
    declared dead (the nodes then kill its actors); hashlib reads the
    buffer without the GIL."""
    import hashlib

    return hashlib.sha256(t.numpy()).hexdigest()


def _cluster_where():
    return os.environ.get("RTPU_NODE_ID"), os.environ.get(
        "CUDA_VISIBLE_DEVICES")


def _cluster_put(value) -> list:
    """A task's ``put`` of ``value``: the ref, nested, so the object stays
    where the task ran."""
    import ray_tpu_torch as rt

    return [rt.put(value)]


def _cluster_digest(refs) -> tuple:
    """A task's view of 20(c)'s tensor: its sha256 and how long its get
    took."""
    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    t = rt.get(refs[0], timeout=300)
    get_s = time.perf_counter() - t0
    return (_sha256(t.view(torch.int16)),
            get_s, str(t.dtype), tuple(t.shape), t.device.type,
            os.environ.get("RTPU_NODE_ID"))


def _cluster_lineage(x: int) -> tuple:
    time.sleep(4.0)
    return os.environ.get("RTPU_NODE_ID"), x * x


def _loads_torch(pid: int) -> list:
    """The torch and CUDA libraries mapped into process ``pid``."""
    with open(f"/proc/{pid}/maps") as f:
        return sorted({line.rsplit("/", 1)[-1].strip() for line in f
                       if "libtorch" in line or "libcuda" in line})


_TENANT = r"""
import json, sys, time
import ray_tpu_torch as rt

addr, name, path = sys.argv[1:4]
rt.init(address=f"ray://{addr}")
replica = rt.get_actor(name)
with open(path) as f:
    wave = json.load(f)
for rid, prompt in wave:
    replica.submit.remote(rid, prompt, True)
rt.get(replica.flush.remote(), timeout=300)
out, deadline = {}, time.monotonic() + 300
while len(out) < len(wave) and time.monotonic() < deadline:
    out.update(rt.get(replica.collect.remote(), timeout=300))
    time.sleep(0.005)
print("TENANT " + json.dumps({r: out[r]["tokens"] for r, _ in wave
                              if r in out}), flush=True)
rt.shutdown()
"""

_POLICY_CLIENT = r"""
import sys
import numpy as np
from ray_tpu_torch.rllib.envs import make_env
from ray_tpu_torch.rllib.policy_server import PolicyClient

host, port, key_hex, episodes = sys.argv[1:5]
client = PolicyClient((host, int(port)), bytes.fromhex(key_hex))
env = make_env("CartPole-v1", 1, seed=1)
for _ in range(int(episodes)):
    obs = env.reset()
    eid = client.start_episode()
    while True:
        a = client.get_action(eid, obs[0])
        obs2, rew, term, trunc = env.step(np.array([a]))
        client.log_returns(eid, float(rew[0]))
        if term[0] or trunc[0]:
            client.end_episode(eid, obs2[0])
            break
        obs = obs2
print("CLIENT_DONE", flush=True)
"""


def _policy_server(dev) -> str:
    """20(f): ``tests/test_rllib.py::test_policy_server_external_client_
    process``'s program with the learner on ``dev``: a CPU client process
    drives CartPole over ``PolicyClient``; the learner consumes the
    server's batches and pushes its weights back."""
    from ray_tpu_torch.rllib import PolicyServerInput
    from ray_tpu_torch.rllib.impala import ImpalaLearner
    from ray_tpu_torch.rllib.envs import make_env
    from ray_tpu_torch.rllib.rl_module import build_pv_module

    probe = make_env("CartPole-v1", 1)
    spec = {"obs_dim": probe.obs_dim, "num_actions": probe.num_actions,
            "hidden": (64, 64)}
    srv = PolicyServerInput(spec, seed=0)
    learner = ImpalaLearner(build_pv_module(spec), lr=1e-3, gamma=0.99,
                            seed=0, device=None if dev.type == "cuda"
                            else "cpu")
    check(all(p.device.type == dev.type
              for p in learner.module.parameters()),
          "20(f): the learner is not on the card")
    warm = {
        "obs": np.zeros((80, 1, spec["obs_dim"]), np.float32),
        "next_obs": np.zeros((80, 1, spec["obs_dim"]), np.float32),
        "actions": np.zeros((80, 1), np.int32),
        "behavior_logits": np.zeros((80, 1, spec["num_actions"]),
                                    np.float32),
        "rewards": np.zeros((80, 1), np.float32),
        "terminateds": np.zeros((80, 1), bool),
        "dones": np.zeros((80, 1), bool),
    }
    learner.update(warm)
    srv.set_weights(learner.get_weights())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", _POLICY_CLIENT, srv.address[0],
         str(srv.address[1]), srv.authkey.hex(), str(POLICY_EPISODES)],
        stdout=subprocess.PIPE, text=True, env=env)
    update_s = []
    try:
        returns, updates = [], 0
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            b = srv.next_batch(80)
            if b is not None:
                t1 = time.perf_counter()
                learner.update(b)
                srv.set_weights(learner.get_weights())
                update_s.append(time.perf_counter() - t1)
                updates += 1
            elif proc.poll() is not None:
                break  # client done AND buffer drained
            else:
                time.sleep(0.02)
            returns.extend(srv.episode_returns())
        out, _ = proc.communicate(timeout=60)
    finally:
        proc.kill()
        srv.close()
    wall = time.perf_counter() - t0
    check("CLIENT_DONE" in out, "20(f): the policy client did not finish")
    check(updates >= POLICY_MIN_UPDATES,
          f"20(f): only {updates} learner updates")
    check(len(returns) >= POLICY_MIN_EPISODES,
          f"20(f): only {len(returns)} episodes")
    early = float(np.mean(returns[:10]))
    late = float(np.mean(returns[-10:]))
    check(late > early and late > 40.0,
          f"20(f): returns early {early:.1f}, late {late:.1f}")
    return (f"{len(returns)} episodes, {updates} updates on {dev.type} "
            f"({statistics.median(update_s) * 1e3:.2f} ms each with the "
            f"weights' round trip, p50), return {early:.1f} -> {late:.1f} "
            f"in {wall:.1f} s")


def cluster_phase(dev, phase3: dict) -> dict:
    """20: cluster mode on the card's host. (a) a GCS and two node
    servers, node A with CPUs only and node B with the card
    (``add_node(gpus=1)``), stores of ``CLUSTER_STORE_BYTES``; a driver
    connects with ``init(address=...)``: ``GPU`` 1.0 cluster-wide, both
    nodes listed, a CPU task sees ``CUDA_VISIBLE_DEVICES=""``, the GCS
    and node servers map no torch or CUDA library. (b) a ``num_gpus=1``
    actor (named) lands on node B, builds phase 3's bf16 weights (seed
    0) on its card, loads phase 3's prompts from an object a task on node
    A put, and serves them through the dense and then the paged engine:
    phase 3's tokens, its launch counts; TTFT and ITL beside phase 14's.
    (c) the actor puts a 1 GiB bf16 tensor made on its card; the driver
    (through node A, its home, a chunked pull) and a task on node A get
    it, bit for bit (sha256); pull GB/s beside 14(b)'s put. (e) a
    subprocess through ``init("ray://...")`` and a ``ClientProxyServer``
    gets the named actor and receives phase 3's paged tokens for the
    first wave. (d) node A is SIGKILLed while a task with lineage runs
    there: its object is rebuilt on node B and the actor keeps answering;
    then node B is SIGKILLed: calls raise ``ActorDiedError`` and the
    card's free memory is back within ``FREED_SLACK_BYTES`` in
    ``FREED_WITHIN_S``. (f) the RLlib policy server with its learner on
    the card. Returns the actor's launches. On the CPU (a rehearsal, with
    ``LlamaConfig.llama3_8b``, ``SERVE_8B`` and the sizes patched small)
    node B gets an injected GPU id and the actor runs on the CPU."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.client import ClientProxyServer
    from ray_tpu_torch.core import runtime_context
    from ray_tpu_torch.core.cluster import Cluster
    from ray_tpu_torch.exceptions import ActorDiedError
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                      param_dtype=torch.bfloat16)
    first, last = serve_8b_requests(cfg.vocab_size)
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free0 = torch.cuda.mem_get_info()[0]
    shm = os.statvfs("/dev/shm")
    shm_free = shm.f_bavail * shm.f_frsize
    check(shm_free > 2 * CLUSTER_STORE_BYTES,
          f"20: /dev/shm has {shm_free / 2**30:.2f} GiB free, the two "
          f"stores need {2 * CLUSTER_STORE_BYTES / 2**30:.2f}")
    launches = {"flash_attention_fwd": 0, "paged_attention": 0}
    t0 = time.perf_counter()
    cluster = Cluster(num_nodes=0, num_workers_per_node=2,
                      object_store_memory=CLUSTER_STORE_BYTES)
    proxy = tenant_dir = None
    try:
        node_a = cluster.add_node(resources={"node_a": 4})
        node_b = cluster.add_node(resources={"node_b": 4}, gpus=1)
        check(cluster.wait_for_nodes(2), "20(a): the nodes did not register")
        gcs = cluster.gcs_address
        os.environ["RTPU_CLUSTER_AUTHKEY"] = cluster.authkey.hex()
        rt.init(address=f"{gcs[0]}:{gcs[1]}")
        core = runtime_context.get_core()
        up_s = time.perf_counter() - t0
        res = core.cluster_resources()
        nodes = {tuple(n["address"]): n for n in core.nodes()}
        check(res.get("GPU") == 1.0, f"20(a): cluster resources {res}")
        check(set(nodes) == {tuple(node_a.address), tuple(node_b.address)},
              f"20(a): nodes {list(nodes)}")
        id_a = nodes[tuple(node_a.address)]["node_id"].hex()
        id_b = nodes[tuple(node_b.address)]["node_id"].hex()
        check(nodes[tuple(node_b.address)]["resources"].get("GPU") == 1.0
              and not nodes[tuple(node_a.address)]["resources"].get("GPU"),
              "20(a): the card is not advertised by node B alone")
        check(tuple(core._home) == tuple(node_a.address),
              "20(a): the driver's home node is not node A")
        where = rt.remote(_cluster_where)
        seen = rt.get([where.options(resources={r: 1}).remote()
                       for r in ("node_a", "node_b")], timeout=120)
        check(seen == [(id_a, ""), (id_b, "")],
              f"20(a): CPU tasks see {seen}")
        mapped = {name: _loads_torch(p.pid) for name, p in
                  (("gcs", cluster._gcs_proc), ("node A", node_a.proc),
                   ("node B", node_b.proc))}
        check(not any(mapped.values()),
              f"20(a): cluster processes map torch/CUDA: {mapped}")
        print(f"  (a) GCS + 2 node servers up and a driver connected in "
              f"{up_s:.2f} s: {res}; CPU tasks on A and B see "
              f"CUDA_VISIBLE_DEVICES=''; the GCS and node servers map no "
              f"torch or CUDA library", flush=True)

        # (b) the GPU actor on node B, its prompts from node A
        t1 = time.perf_counter()
        replica = rt.remote(ClusterReplica).options(
            num_gpus=1, name="llama8b").remote(
                cfg, SERVE_8B, 0, None if cuda else "cpu")
        info = rt.get(replica.info.remote(), timeout=900)
        ready_s = time.perf_counter() - t1
        table = core.gcs.call(("list_actors",))
        entry = next(v for v in table.values() if v.get("name") == "llama8b")
        check(tuple(entry["node"]) == tuple(node_b.address),
              f"20(b): the GPU actor is on {entry['node']}, not node B")
        if cuda:
            check(info["visible"] == info["gpu_ids"] == "0"
                  and info["device_count"] == 1,
                  f"20(b): the GPU actor's worker sees {info}")
        inner = rt.get(rt.remote(_cluster_put).options(resources={"node_a": 1}).remote(
            [first, last]), timeout=120)[0]
        counts = rt.get(replica.load.remote(inner), timeout=120)
        check(counts == [len(first), len(last)], f"20(b): loaded {counts}")
        fetched = core._nodes.get(node_b.address).call(("state",))["fetch"]
        check(fetched["count"] >= 1, f"20(b): node B fetched {fetched}")
        print(f"  (b) GPU actor on node B ready in {ready_s:.2f} s "
              f"({info['init_s']:.2f} s building the weights), "
              f"CUDA_VISIBLE_DEVICES={info['visible']!r}, {info['name']}; "
              f"its prompts fetched from node A ({fetched['count']} "
              f"fetches, {fetched['bytes']} bytes)", flush=True)
        for kind in ("dense", "paged"):
            rt.get(replica.start.remote(kind), timeout=300)
            t1 = time.perf_counter()
            out = {}
            for i, wave in enumerate((first, last)):
                rt.get(replica.submit_wave.remote(i), timeout=60)
                rt.get(replica.flush.remote(), timeout=300)
                deadline = time.monotonic() + 300
                while (len(out) < sum(len(w) for w in (first, last)[:i + 1])
                       and time.monotonic() < deadline):
                    out.update(rt.get(replica.collect.remote(), timeout=300))
                    time.sleep(0.005)
            wall = time.perf_counter() - t1
            n, st, build_s = rt.get(replica.stop.remote(), timeout=120)
            want = phase3[kind]
            same = sum(out.get(r, {}).get("tokens") == want["tokens"][r]
                       for r in want["tokens"])
            check(same == len(want["tokens"]),
                  f"20(b) {kind} on node B: tokens equal phase 3's for "
                  f"{same}/{len(want['tokens'])} requests")
            got = (n["fwd"], n["paged"])
            check(got == tuple(want["launches"]),
                  f"20(b) {kind} on node B: flash and paged launches {got}, "
                  f"phase 3 {want['launches']}")
            check(n["fwd_sm90"] == n["fwd"] and n["paged_merge"] == n["paged"],
                  f"20(b) {kind}: launches {n}")
            launches["flash_attention_fwd"] += got[0]
            launches["paged_attention"] += got[1]
            lat = _latency_ms(out)
            ref14 = PHASE14_LAT if kind == "paged" else {}
            beside = (f" (phase 14's direct actor: TTFT p50 "
                      f"{ref14['ttft_p50']:.2f} ms, ITL p50 "
                      f"{ref14['itl_p50']:.3f} ms)" if ref14 else "")
            print(f"  (b) {kind} on node B: tokens equal phase 3's for "
                  f"{same}/{len(want['tokens'])} requests; flash launches "
                  f"{got[0]}, paged launches {got[1]}; wall {wall:.2f} s; "
                  f"TTFT p50 {lat['ttft_p50']:.2f} ms, ITL p50 "
                  f"{lat['itl_p50']:.3f} ms{beside}", flush=True)

        # (c) 1 GiB from the card on node B to the driver and node A
        nbytes = CLUSTER_BIG_BYTES
        t1 = time.perf_counter()
        refs, digest, made_on = rt.get(replica.big.remote(nbytes, 20),
                                       timeout=300)
        make_s = time.perf_counter() - t1
        check(made_on.startswith("cuda") or not cuda,
              f"20(c): the tensor was made on {made_on}")
        before = core._nodes.get(node_a.address).call(("state",))["fetch"]
        t1 = time.perf_counter()
        got = rt.get(refs[0], timeout=300)
        pull_s = time.perf_counter() - t1
        after = core._nodes.get(node_a.address).call(("state",))["fetch"]
        pulled = after["bytes"] - before["bytes"]
        pull_gbps = pulled / max(after["seconds"] - before["seconds"],
                                 1e-9) / 1e9
        check(got.dtype == torch.bfloat16 and got.numel() * 2 == nbytes
              and got.device.type == "cpu",
              f"20(c): the driver got {got.dtype} {tuple(got.shape)} on "
              f"{got.device}")
        check(_sha256(got.view(torch.int16)) == digest,
              "20(c): the driver's bits differ")
        check(pulled >= nbytes,
              f"20(c): node A pulled {pulled} bytes, want >= {nbytes}")
        check(_in_store(got),
              "20(c): the driver's get is not a view into node A's store")
        del got
        task = rt.get(rt.remote(_cluster_digest).options(
            resources={"node_a": 1}).remote(refs), timeout=300)
        check(task[0] == digest and task[5] == id_a,
              f"20(c): the task on node A got {task[:1] + task[2:]}")
        put14 = PHASE14_PUT.get("gbps")
        print(f"  (c) {nbytes / 2**30:.2f} GiB bf16 made on "
              f"{made_on} in node B's actor ({make_s:.2f} s with its "
              f"sha256 and put): the driver's get {pull_s:.2f} s through "
              f"node A's chunked pull ({pulled / 2**30:.2f} GiB at "
              f"{pull_gbps:.2f} GB/s), a view into node A's store; a task "
              f"on node A read it in {task[1] * 1e3:.1f} ms; both bit for "
              f"bit (phase 14's put: "
              + (f"{put14:.2f} GB/s)" if put14 else "not measured)"),
              flush=True)
        rt.free(refs[0])

        # (e) the thin client, before the failures
        rt.get(replica.start.remote("paged"), timeout=300)
        proxy = ClientProxyServer(cluster.gcs_address,
                                  authkey=cluster.authkey)
        tenant_dir = tempfile.mkdtemp(prefix="rtpt_tenant_")
        wave_path = os.path.join(tenant_dir, "wave.json")
        with open(wave_path, "w") as f:
            json.dump(first, f)
        env = dict(os.environ, RTPU_CLUSTER_AUTHKEY=cluster.authkey.hex(),
                   CUDA_VISIBLE_DEVICES="")
        here = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
        t1 = time.perf_counter()
        res_t = subprocess.run(
            [sys.executable, "-c", _TENANT,
             f"{proxy.address[0]}:{proxy.address[1]}", "llama8b",
             wave_path], env=env, capture_output=True, text=True,
            timeout=600)
        tenant_s = time.perf_counter() - t1
        line = next((ln for ln in res_t.stdout.splitlines()
                     if ln.startswith("TENANT ")), None)
        check(line is not None,
              f"20(e): the ray:// tenant failed: {res_t.stderr[-2000:]}")
        toks = json.loads(line[len("TENANT "):])
        want = phase3["paged"]["tokens"]
        same = sum(toks.get(r) == want[r] for r, _ in first)
        check(toks.get("q0") == want["q0"] and same == len(first),
              f"20(e): the tenant's tokens equal phase 3's for "
              f"{same}/{len(first)} requests (q0 "
              f"{toks.get('q0') == want['q0']})")
        n, _, _ = rt.get(replica.stop.remote(), timeout=120)
        launches["paged_attention"] += n["paged"]
        launches["flash_attention_fwd"] += n["fwd"]
        check(proxy.num_tenants == 0, "20(e): the tenant was not reaped")
        print(f"  (e) a ray:// tenant in its own process got the named "
              f"actor and phase 3's paged tokens for q0 (and {same}/"
              f"{len(first)} of its wave) in {tenant_s:.2f} s; paged "
              f"launches {n['paged']}", flush=True)

        # (d) node A dies with a task in flight, then node B
        lineage = rt.remote(_cluster_lineage).options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                id_a, soft=True))
        ref = lineage.remote(7)
        time.sleep(1.0)
        t1 = time.perf_counter()
        cluster.remove_node(node_a)
        value = rt.get(ref, timeout=300)
        rebuild_s = time.perf_counter() - t1
        check(value == (id_b, 49),
              f"20(d): the lost object came back as {value}, want node "
              f"B's (.., 49)")
        check(rt.get(replica.ping.remote(), timeout=60) > 0,
              "20(d): the GPU actor stopped answering")
        if cuda:
            torch.cuda.synchronize()
            held = torch.cuda.mem_get_info()[0]
        t1 = time.perf_counter()
        cluster.remove_node(node_b)
        deadline = time.monotonic() + 60
        while (core.node_states().get(id_b) != "DEAD"
               and time.monotonic() < deadline):
            time.sleep(0.1)
        check(core.node_states().get(id_b) == "DEAD",
              f"20(d): node B is {core.node_states().get(id_b)} after its "
              f"SIGKILL")
        dead_s = time.perf_counter() - t1
        try:
            rt.get(replica.ping.remote(), timeout=60)
            check(False, "20(d): a call to the dead node's actor returned")
        except ActorDiedError as e:
            err = type(e).__name__
        call_s = time.perf_counter() - t1 - dead_s
        freed_line = ""
        if cuda:
            deadline = time.monotonic() + FREED_WITHIN_S
            while True:
                free = torch.cuda.mem_get_info()[0]
                if (free >= free0 - FREED_SLACK_BYTES
                        or time.monotonic() > deadline):
                    break
                time.sleep(0.2)
            freed_s = time.perf_counter() - t1
            check(free >= free0 - FREED_SLACK_BYTES,
                  f"20(d): {freed_s:.1f} s after node B's SIGKILL the card "
                  f"has {free / 2**30:.2f} GiB free, {free0 / 2**30:.2f} "
                  f"before the actor")
            freed_line = (f"; the card's free memory {held / 2**30:.2f} -> "
                          f"{free / 2**30:.2f} GiB ({free0 / 2**30:.2f} "
                          f"before the actor) {freed_s:.2f} s after the "
                          f"kill")
        print(f"  (d) node A SIGKILLed with a lineage task in flight: "
              f"rebuilt on node B in {rebuild_s:.2f} s, the GPU actor "
              f"still answering; node B SIGKILLed: declared dead in "
              f"{dead_s:.2f} s, then a call raised {err} in "
              f"{call_s:.2f} s{freed_line}", flush=True)
    finally:
        if proxy is not None:
            proxy.close()
        rt.shutdown()
        cluster.shutdown()
        os.environ.pop("RTPU_CLUSTER_AUTHKEY", None)
        if tenant_dir is not None:
            import shutil

            shutil.rmtree(tenant_dir, ignore_errors=True)
    print(f"  (f) policy server: {_policy_server(dev)}", flush=True)
    print(f"  phase 20 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# ---------------------------------------------------------------- phase 21

# 21(b): small-value round trips timed over the socket edges
SOCK_RTT_CALLS = 200
# 21(c): GPT-2 steps the NCCL gang takes (phase 15's run, batch and seq)
CLUSTER_GANG_STEPS = 3
# 21(d): the job's GEMM, n x n with entries in [-8, 8] (exact in fp32)
JOB_GEMM_N, JOB_GEMM_SEED = 4096, 21
# phase 21's object stores
CLUSTER21_STORE_BYTES = 512 << 20


class _Echo:
    """21(b)'s stage on node B for the socket round trip."""

    def step(self, x):
        return x


def _counted_generate():
    """21(b)'s generate stage: ``LLMPipeline``'s ``_Generate`` that also
    reports its process's kernel launches."""
    from ray_tpu_torch.serve import dag_mode

    class CountedGenerate(dag_mode._Generate):
        def launches(self) -> dict:
            return counters()

    return CountedGenerate


def _spread_sums_loop(config) -> None:
    """21(c)'s gloo gang worker: the ``torch`` backend's sums (and every
    other op) against the ``host`` backend's, and the node it runs on."""
    import torch.distributed as dist

    from ray_tpu_torch import train as tr
    from ray_tpu_torch.parallel import collective

    ctx = tr.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    dev = collective.init_collective_group(world, rank, backend="torch",
                                           group_name="dev")
    host = collective.get_group("train")
    x = np.random.default_rng(rank).standard_normal(1 << 16)
    t = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    same = {}
    for op in ("sum", "prod", "min", "max"):
        same[op] = bool(np.array_equal(dev.allreduce(x, op),
                                       host.allreduce(x, op)))
        same[op + "_bf16"] = bool(torch.equal(dev.allreduce(t, op),
                                              host.allreduce(t, op)))
    same["allgather"] = all(np.array_equal(a, b) for a, b in zip(
        dev.allgather(x), host.allgather(x)))
    same["broadcast"] = bool(np.array_equal(dev.broadcast(x, 1),
                                            host.broadcast(x, 1)))
    nodes = [None] * world
    dist.all_gather_object(nodes, os.environ.get("RTPU_NODE_ID"))
    tr.report({"same": same, "nodes": nodes, "world": world,
               "backend": dist.get_backend(),
               "sum0": float(dev.allreduce(x)[0])})


_JOB = r"""
import hashlib, os, sys, time
import ray_tpu_torch as rt

n, seed, device = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
rt.init()


@rt.remote
class Gemm:
    def run(self, n, seed, device):
        import torch

        g = torch.Generator(device=device).manual_seed(seed)
        a, b = (torch.randint(-8, 9, (n, n), generator=g, device=device,
                              dtype=torch.float32) for _ in range(2))
        c = a @ b
        name = (torch.cuda.get_device_name(0) if device == "cuda"
                else "cpu")
        return (hashlib.sha256(c.cpu().numpy().tobytes()).hexdigest(),
                os.environ.get("RTPU_NODE_ID"),
                os.environ.get("CUDA_VISIBLE_DEVICES"), name)


t0 = time.perf_counter()
g = Gemm.options(num_gpus=1).remote()
digest, node, visible, name = rt.get(g.run.remote(n, seed, device),
                                     timeout=600)
print("JOB_DIGEST", digest, node, visible, repr(name),
      f"{time.perf_counter() - t0:.2f}", flush=True)
rt.shutdown()
"""


def _gemm_digest(n: int, seed: int, device) -> str:
    """21(d): the job's GEMM in the driver: sha256 of ``a @ b`` over
    seeded integer entries (every product and sum exact in fp32, so any
    order of summation gives these bits)."""
    import hashlib

    g = torch.Generator(device=device).manual_seed(seed)
    a, b = (torch.randint(-8, 9, (n, n), generator=g, device=device,
                          dtype=torch.float32) for _ in range(2))
    return hashlib.sha256((a @ b).cpu().numpy().tobytes()).hexdigest()


def cluster_plane_phase(dev, phase17: dict, gpt2_losses: list) -> dict:
    """21: cluster mode above the substrate, on a fresh ``Cluster``: node
    A the head (the job agent) with CPUs only, node B given the card.
    (a) the state API on the driver; (b) Llama-3-8B bf16 served by a
    ``PipelineDeployment`` of ``LLMPipeline``'s stages across the nodes,
    over two socket edges, against 17(d)'s replies (``phase17``); (c) a
    one-worker NCCL gang on node B through the TCP rendezvous, against
    phase 7's GPT-2 losses, and a gloo gang ``SPREAD`` over both nodes;
    (d) a job through node A's agent that runs a GEMM on node B's card.
    Returns the launches of (b)'s generate stage and (c)'s gang worker.
    On the CPU (a rehearsal, with ``DAG_MODEL_CONFIG``, ``GANG_GPT2`` and
    ``GPT2Config.gpt2_125m`` patched small) node B gets an injected GPU
    id and its actors run on the CPU."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import state
    from ray_tpu_torch import train as tr
    from ray_tpu_torch.core import runtime_context
    from ray_tpu_torch.core.cluster import Cluster
    from ray_tpu_torch.dag import compile_pipeline
    from ray_tpu_torch.job import JobStatus, JobSubmissionClient
    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.serve.dag_mode import (PipelineDeployment,
                                              _Detokenize, _Tokenize)

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    device = None if cuda else "cpu"
    mc = DAG_MODEL_CONFIG
    layers = llama.LlamaConfig.llama3_8b().num_layers
    launches = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
                "flash_attention_bwd_dkv": 0}
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    storage = tempfile.mkdtemp(prefix="rtpt_cluster21_")
    t0 = time.perf_counter()
    cluster = Cluster(num_nodes=0, num_workers_per_node=2,
                      object_store_memory=CLUSTER21_STORE_BYTES)
    dep = client = None
    try:
        node_a = cluster.add_node(resources={"node_a": 4}, head=True)
        node_b = cluster.add_node(resources={"node_b": 4}, gpus=1)
        check(cluster.wait_for_nodes(2), "21(a): the nodes did not register")
        gcs = cluster.gcs_address
        os.environ["RTPU_CLUSTER_AUTHKEY"] = cluster.authkey.hex()
        rt.init(address=f"{gcs[0]}:{gcs[1]}")
        core = runtime_context.get_core()
        up_s = time.perf_counter() - t0
        check(tuple(core._home) == tuple(node_a.address),
              "21(a): the driver's home node is not node A")

        # (a) the state API
        where = rt.remote(_cluster_where)
        rt.get([where.options(resources={r: 1}).remote()
                for r in ("node_a", "node_b")], timeout=120)
        nodes = state.list_nodes()
        ids = {tuple(n["address"]): n["node_id"] for n in nodes}
        id_a, id_b = ids.get(tuple(node_a.address)), ids.get(
            tuple(node_b.address))
        res = state.cluster_resources()
        summary = state.state_summary()
        worker_nodes = {w["node_id"] for w in state.list_workers()}
        check(len(nodes) == 2 and all(n["state"] == "ALIVE" for n in nodes)
              and id_a and id_b, f"21(a): list_nodes {nodes}")
        check(res.get("GPU") == 1.0 and res.get("CPU") == 4.0,
              f"21(a): cluster_resources {res}")
        check(len(summary["nodes"]) == 2
              and summary["cluster_resources"] == res
              and worker_nodes == {id_a, id_b},
              f"21(a): the summary's nodes {summary['nodes']}, workers on "
              f"{worker_nodes}")
        print(f"  (a) head node A (job agent) and GPU node B up, driver "
              f"connected in {up_s:.2f} s; state: {len(nodes)} nodes "
              f"ALIVE, cluster_resources {res}, workers on both nodes "
              f"({len(state.list_workers())}), summary tasks "
              f"{summary['tasks']}", flush=True)

        # (b) Llama-3-8B across nodes: tokenize | generate (card) | detok
        t1 = time.perf_counter()
        dep = PipelineDeployment([
            (_Tokenize, "run", (mc.get("vocab_size", 256),),
             {"resources": {"node_a": 1}}),
            (_counted_generate(), "run",
             (mc, DAG_MAX_NEW, None, device), {"num_gpus": 1}),
            (_Detokenize, "run", (), {"resources": {"node_a": 1}}),
        ])
        ready_s = time.perf_counter() - t1
        gen = dep._actors[1]
        table = core.gcs.call(("list_actors",))
        placed = [tuple(table[a._actor_id.binary()]["node"])
                  for a in dep._actors]
        check(placed == [tuple(node_a.address), tuple(node_b.address),
                         tuple(node_a.address)],
              f"21(b): the stages are on {placed}")
        text = phase17["text"]
        replies, times = [], []
        for _ in range(DAG_REQUESTS):
            t1 = time.perf_counter()
            replies.append(dep(text, timeout_ms=300_000))
            times.append(time.perf_counter() - t1)
        socks = core.kv_op("keys", "dagchan:")
        to_driver = [d[0] for d, _ in
                     dep._dag._in_edges + dep._dag._out_edges]
        n = rt.get(gen.launches.remote(), timeout=60)
        dep.shutdown()
        dep = None
        check(to_driver == ["shm", "shm"] and len(socks) == 2,
              f"21(b): the driver's edges are {to_driver}, socket edges "
              f"{len(socks)} (want the two between nodes A and B)")
        check(all(r == phase17["reply"] for r in replies),
              f"21(b): the replies differ from 17(d)'s:\n{replies[0]}\n"
              f"{phase17['reply']}")
        check(n["fwd"] == layers * DAG_REQUESTS and n["fwd_sm90"] == n["fwd"],
              f"21(b): the generate stage's flash launches {n['fwd']} "
              f"(wgmma {n['fwd_sm90']}), want {layers} a request x "
              f"{DAG_REQUESTS}")
        launches["flash_attention_fwd"] += n["fwd_sm90"]
        echo = rt.remote(_Echo).options(resources={"node_b": 1}).remote()
        dag = compile_pipeline([(echo, "step")])
        try:
            kinds = [d[0] for d, _ in dag._in_edges + dag._out_edges]
            dag.execute(0)
            rtt = []
            for i in range(SOCK_RTT_CALLS):
                t1 = time.perf_counter()
                dag.execute(i)
                rtt.append(time.perf_counter() - t1)
        finally:
            dag.teardown()
        rt.kill(echo)
        check(kinds == ["sock", "sock"],
              f"21(b): the echo's edges are {kinds}")
        ms17 = phase17.get("ms")
        shm_us = phase17.get("rtt_shm_us")
        print(f"  (b) Llama-3-8B bf16 ({layers} layers) as tokenize on A | "
              f"generate on B's card | detokenize on A, over 2 socket "
              f"edges (the driver's 2 shm): ready in {ready_s:.2f} s; "
              f"{DAG_REQUESTS} replies equal 17(d)'s; "
              f"{statistics.median(times) * 1e3:.2f} ms a request (p50; "
              f"17(d) on one node: "
              + (f"{ms17:.2f} ms)" if ms17 else "not measured)")
              + f"; flash launches {n['fwd']} (wgmma {n['fwd_sm90']}); a "
              f"small value's round trip over 2 socket edges p50 "
              f"{statistics.median(rtt) * 1e6:.1f} us (17(c)'s shm edge: "
              + (f"{shm_us:.1f} us)" if shm_us else "not measured)")
              + f" ({SOCK_RTT_CALLS} calls)", flush=True)

        # (c) the gangs: NCCL on node B through the TCP rendezvous, gloo
        # SPREAD over A and B
        gcfg = gpt2.GPT2Config.gpt2_125m()
        gb, gs = GANG_GPT2
        sentinel = os.path.join(storage, "crashed")
        open(sentinel, "w").close()   # no crash drill here
        t1 = time.perf_counter()
        res_g = tr.TorchTrainer(
            _gang_gpt2_loop,
            train_loop_config={"cfg": gcfg, "batch": gb, "seq": gs,
                               "steps": CLUSTER_GANG_STEPS,
                               "device": device, "sentinel": sentinel},
            torch_config=tr.TorchConfig(device=device, distributed=True,
                                        timeout_s=600.0),
            scaling_config=tr.ScalingConfig(
                num_workers=1, use_gpu=cuda,
                resources_per_worker={"node_b": 1}),
            run_config=tr.RunConfig(storage_path=storage,
                                    name="gpt2")).fit()
        nccl_s = time.perf_counter() - t1
        check(res_g.error is None,
              f"21(c): the NCCL gang failed: {res_g.error!r}")
        hist = res_g.metrics_history
        glosses = [m["loss"] for m in hist]
        want = gpt2_losses[:CLUSTER_GANG_STEPS]
        grel = _rel(glosses, want)
        ng = hist[-1]["launches"]
        L = gcfg.num_layers
        steps = CLUSTER_GANG_STEPS
        check(hist[0]["node"] == id_b and hist[0]["rendezvous"] == "TCPStore"
              and hist[0]["backend"] == ("nccl" if cuda else "gloo"),
              f"21(c): the gang ran on {hist[0]['node']} ({id_b} is B), "
              f"met in {hist[0]['rendezvous']}, {hist[0]['backend']}")
        check(grel <= 2e-2, f"21(c): losses {glosses} are not phase 7's "
                            f"{want} at rtol 2e-2")
        check(ng["fwd"] == ng["fwd_sm90"] >= L * steps
              and ng["dq"] == ng["dq_sm90"] == L * steps
              and ng["dkv"] == ng["dkv_sm90"] == L * steps,
              f"21(c): the gang worker's launches {ng}, want >= "
              f"{L * steps} forward and {L * steps} dQ and dK/dV, all "
              f"wgmma")
        launches["flash_attention_fwd"] += ng["fwd_sm90"]
        launches["flash_attention_bwd_dq"] += ng["dq_sm90"]
        launches["flash_attention_bwd_dkv"] += ng["dkv_sm90"]
        t1 = time.perf_counter()
        res_s = tr.TorchTrainer(
            _spread_sums_loop,
            torch_config=tr.TorchConfig(device="cpu", distributed=True),
            scaling_config=tr.ScalingConfig(num_workers=2,
                                            placement_strategy="SPREAD"),
            run_config=tr.RunConfig(storage_path=storage,
                                    name="spread")).fit()
        spread_s = time.perf_counter() - t1
        check(res_s.error is None,
              f"21(c): the gloo gang failed: {res_s.error!r}")
        m = res_s.metrics
        check(sorted(m["nodes"]) == sorted([id_a, id_b])
              and (m["world"], m["backend"]) == (2, "gloo")
              and all(m["same"].values()),
              f"21(c): the SPREAD gang: nodes {m['nodes']}, {m['backend']} "
              f"world {m['world']}, equal ops {m['same']}")
        print(f"  (c) NCCL gang on node B from node A's driver, met in "
              f"rank 0's TCPStore: GPT-2 125M {gb} x {gs}, losses "
              f"{' '.join(f'{x:.4f}' for x in glosses)} against phase 7's "
              f"{' '.join(f'{x:.4f}' for x in want)} (largest relative "
              f"difference {grel:.3e}); launches fwd {ng['fwd']} dq "
              f"{ng['dq']} dkv {ng['dkv']} (all wgmma); fit {nccl_s:.1f} "
              f"s. gloo gang SPREAD over A and B: every torch-backend op "
              f"equals the host backend's ({len(m['same'])} checks); fit "
              f"{spread_s:.1f} s", flush=True)

        # (d) a job through the head's agent, its GEMM on node B's card
        want_digest = _gemm_digest(JOB_GEMM_N, JOB_GEMM_SEED,
                                   "cuda" if cuda else "cpu")
        script = os.path.join(storage, "job.py")
        with open(script, "w") as f:
            f.write(_JOB)
        client = JobSubmissionClient(f"{gcs[0]}:{gcs[1]}",
                                     authkey=cluster.authkey)
        t1 = time.perf_counter()
        jid = client.submit_job(
            entrypoint=f"{sys.executable} {script} {JOB_GEMM_N} "
                       f"{JOB_GEMM_SEED} {'cuda' if cuda else 'cpu'}")
        status = client.wait_until_finished(jid, timeout=300)
        job_s = time.perf_counter() - t1
        logs = client.get_job_logs(jid)
        line = next((ln for ln in logs.splitlines()
                     if ln.startswith("JOB_DIGEST ")), "")
        parts = line.split()
        info = client.get_job_info(jid)
        check(status == JobStatus.SUCCEEDED,
              f"21(d): the job ended {status}:\n{logs[-2000:]}")
        check(len(parts) >= 4 and parts[1] == want_digest
              and parts[2] == id_b and info["agent"] == id_a,
              f"21(d): the job printed {line!r} (driver's digest "
              f"{want_digest}, node B {id_b}, agent {info['agent']})")
        print(f"  (d) job {jid} through node A's agent: SUCCEEDED "
              f"{job_s:.2f} s after submit; its num_gpus=1 actor on node "
              f"B (CUDA_VISIBLE_DEVICES={parts[3]!r}, "
              f"{' '.join(parts[4:-1])}) printed the driver's digest of "
              f"the {JOB_GEMM_N} x {JOB_GEMM_N} GEMM ({parts[1][:16]}...; "
              f"{parts[-1]} s in the job's driver)", flush=True)
    finally:
        if client is not None:
            client.close()
        if dep is not None:
            dep.shutdown()
        rt.shutdown()
        cluster.shutdown()
        os.environ.pop("RTPU_CLUSTER_AUTHKEY", None)
        shutil.rmtree(storage, ignore_errors=True)
    print(f"  phase 21 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def _detached(params) -> dict:
    return {k: _detached(v) if isinstance(v, dict) else v.detach()
            for k, v in params.items()}


_PHASE_T: dict = {}


def phase_start(n: int) -> None:
    """Stamp the start of phase ``n`` (``phase_seconds`` reads them)."""
    _PHASE_T[n] = time.perf_counter()


def phase_seconds() -> str:
    """Each phase's seconds, from its start stamp to the next one's (the
    last to now)."""
    ts = sorted(_PHASE_T.items()) + [(None, time.perf_counter())]
    return ", ".join(f"{n} {t1 - t0:.1f}"
                     for (n, t0), (_, t1) in zip(ts, ts[1:]))


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import ray_tpu_torch.ops._build  # noqa: F401  (the package is here)
    except ImportError as e:
        print(f"chip_smoke: ray_tpu_torch not found beside the script: {e}",
              file=sys.stderr)
        sys.exit(2)
    logging.basicConfig(level=logging.WARNING)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    phase_start(0)
    print(f"phase 0: card {smi_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; import torch {_IMPORT_S:.2f} s; bytecode "
          f"cache {sys.pycache_prefix}", flush=True)
    build_phase()

    ctx_main = [m + 16 for m in SERVE_8B_LENS]  # mid-decode history
    phase_start(1)
    print("phase 1: kernels against their plain versions", flush=True)
    kernels = flash_phase(dev)
    kernels.append(paged_phase(dev, ctx_main))
    kernels += flash_bwd_phase(dev)
    kernels += paged_families_phase(dev, ctx_main)
    kernels += flash_d256_phase(dev)
    kernels += flash_small_d_phase(dev)
    flash_tf32x3_phase(dev)
    phase_start(2)
    print("phase 2: fp32 full width, 2 layers, dense vs paged: Llama-3-8B, "
          "Qwen2-7B, Gemma-7B", flush=True)
    from ray_tpu_torch.models.llama import LlamaConfig

    llama_fp32_fwd = fp32_phase(dev, LlamaConfig.llama3_8b(), "Llama-3-8B")
    for model in ("Qwen2-7B", "Gemma-7B"):
        fp32_phase(dev, published_config(model), model)
        gc.collect()
        torch.cuda.empty_cache()
    phase_start(3)
    print("phase 3: Llama-3-8B bf16, 32 layers, dense then paged",
          flush=True)
    launches, phase3 = serve_8b_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase_start(4)
    print("phase 4: fp32 full width, 2 layers, gradients through the "
          "kernels: Llama-3-8B (head dim 128), then Gemma-7B (head dim "
          "256)", flush=True)
    llama_fp32 = grad_phase(dev, LlamaConfig.llama3_8b())
    gc.collect()
    torch.cuda.empty_cache()
    gemma_fp32 = grad_phase(dev, published_config("Gemma-7B"))
    gc.collect()
    torch.cuda.empty_cache()
    phase_start(5)
    print("phase 5: training, Llama-3-8B width, 8 layers, 5 AdamW steps",
          flush=True)
    train = train_phase(dev)
    phase_start(6)
    print("phase 6: Qwen2-7B and Gemma-7B bf16, full width, dense then "
          "paged", flush=True)
    qwen2 = serve_family_phase(dev, "Qwen2-7B")
    gemma = serve_family_phase(dev, "Gemma-7B")
    phase_start(7)
    print("phase 7: training GPT-2 125M, Mixtral-8x7B width and Gemma-7B "
          "width", flush=True)
    families = train_families_phase(dev)
    phase_start(8)
    print("phase 8: the tiny presets (head dim 16) on the card", flush=True)
    scalar = tiny_phase(dev)
    phase_start(9)
    print("phase 9: disaggregated prefill/decode and the decode API: "
          "Llama-3-8B fp32 2 layers, then bf16 32 layers", flush=True)
    disagg_fp32 = disagg_fp32_phase(dev)
    disagg = disagg_serve_phase(dev)
    decode_api_phase(dev)
    phase_start(10)
    print("phase 10: the RL learners, card against CPU", flush=True)
    rl_phase(dev)
    phase_start(11)
    print("phase 11: the parallel layer at world size 1 over NCCL: "
          "Llama-3-8B width (Ulysses, ring, pp 1), Mixtral-8x7B width "
          "{dp 1, ep 1}", flush=True)
    sharded = mesh_phase(dev)
    phase_start(12)
    print("phase 12: tensor-parallel serving at world size 1 over NCCL: "
          "Llama-3-8B bf16, both engines with mesh={tp 1}", flush=True)
    tp_serve = tp_serve_phase(dev, phase3)
    phase_start(13)
    print("phase 13: sharded checkpoints and the predictor (Llama-3-8B "
          f"width, {CKPT_LAYERS} layers), then the disaggregated engine and page "
          "export/import with mesh={tp 1}", flush=True)
    ckpt = checkpoint_phase(dev)
    tp_disagg = tp_disagg_phase(dev, disagg_fp32, disagg)
    phase_start(14)
    print("phase 14: the port's runtime on the card: resources, objects, "
          "and Llama-3-8B bf16 served from an actor with num_gpus=1",
          flush=True)
    runtime = runtime_phase(dev, phase3)
    phase_start(15)
    print("phase 15: the Train gang on the card: Llama-3-8B width trained "
          "from a GPU gang worker, a restart drill at GPT-2 125M, the "
          "refusals", flush=True)
    gang, gang_step = train_gang_phase(dev, train,
                                       families["gpt2"]["losses"])
    phase_start(16)
    print("phase 16: Data on the card: the device feed, Llama-3-8B width "
          "trained from a Dataset shard in a gang worker, Llama-3-8B "
          "predictions over a Dataset on a GPU actor pool, offline BC",
          flush=True)
    data = data_phase(dev, train, gang_step)
    phase_start(17)
    print("phase 17: the serving plane and compiled DAGs on the card: "
          "Llama-3-8B bf16 through serve.run from a num_gpus=1 replica, "
          "fp32 2 layers against 9(a), the DAG device lane, DAG mode, a "
          "replica SIGKILLed mid-stream", flush=True)
    served = serve_plane_phase(dev, phase3, disagg_fp32)
    phase_start(18)
    print("phase 18: Data's readers and Tune on the card: four readers "
          "bit for bit, a GPT-2 125M sweep on num_gpus=1 trial actors "
          "under ASHA fed from TFRecords, a trial killed and resumed, a "
          "Tuner over a TorchTrainer", flush=True)
    swept = tune_phase(dev, families["gpt2"]["losses"])
    phase_start(19)
    print("phase 19: the RLlib drivers on the card: EnvRunner gangs on CPU "
          "actors, PPO and IMPALA learning pixel Catch, APPO, DQN, SAC, "
          "multi-agent PPO, DreamerV3", flush=True)
    rl_drivers_phase(dev)
    phase_start(20)
    print("phase 20: cluster mode on the card's host: a GCS and two node "
          "servers, Llama-3-8B bf16 served from a num_gpus=1 actor on the "
          "GPU node, 1 GiB across nodes, node deaths, the ray:// client, "
          "the RLlib policy server", flush=True)
    clustered = cluster_phase(dev, phase3)
    phase_start(21)
    print("phase 21: cluster mode above the substrate: the state API, "
          "Llama-3-8B bf16 served by a DAG across two nodes over socket "
          "edges, gangs through the TCP rendezvous (NCCL on node B, gloo "
          "SPREAD over both), a job through the head node's agent",
          flush=True)
    planed = cluster_plane_phase(dev, PHASE17_DAG,
                                 families["gpt2"]["losses"])
    # the serving kernels' counts come from phases 3 and 6, the backward
    # kernels' from phase 5 (wgmma, d 128) and phase 7's Gemma run (the
    # wgmma dQ and dK/dV at d 256), the fp32 rows' from phase 2's Llama
    # dense engine (the d-128 3xTF32 forward) and phase 4's Llama (the
    # d-128 3xTF32 dQ and dK/dV) and Gemma (d 256) runs; the
    # forward's training counts are printed in 5 and 7
    gemma_train = families["gemma"]
    launches.update(flash_attention_bwd_dq=train["flash_attention_bwd_dq"],
                    flash_attention_bwd_dkv=train["flash_attention_bwd_dkv"],
                    flash_attention_fwd_tf32x3_d128=llama_fp32_fwd,
                    flash_attention_bwd_dq_tf32x3_d128=llama_fp32[
                        "dq_tf32x3"],
                    flash_attention_bwd_dkv_tf32x3_d128=llama_fp32["dkv"],
                    flash_attention_fwd_sm90_d256=gemma["fwd"],
                    flash_attention_fwd_tf32x3_d256=gemma_fp32["fwd"],
                    paged_attention_gm8_hd128=qwen2["paged"],
                    paged_attention_gm1_hd256=gemma["paged"],
                    flash_attention_bwd_dq_sm90_d256=gemma_train["dq_sm90"],
                    flash_attention_bwd_dq_tf32x3_d256=gemma_fp32[
                        "dq_tf32x3"],
                    flash_attention_bwd_dkv_tf32x3_d256=gemma_fp32["dkv"],
                    flash_attention_bwd_dkv_sm90_d256=gemma_train[
                        "dkv_sm90"])
    # phase 11's sharded runs launch the d-128 wgmma flash kernels too
    for name, key in (("flash_attention_fwd", "fwd_sm90"),
                      ("flash_attention_bwd_dq", "dq_sm90"),
                      ("flash_attention_bwd_dkv", "dkv_sm90")):
        launches[name] += sharded[key]
    # and phase 12's engines the serving kernels, phase 13 the training
    # kernels (its run, its losses, the predictor) and the paged kernel,
    # phase 14's GPU actor the serving kernels again
    # and phase 15's gang worker the training kernels, phase 16's gang
    # worker and predictor actor the d-128 flash kernels, phase 17's
    # replicas and generate stage the d-128 forward (wgmma and 3xTF32)
    # and the G-4 paged kernel
    # and phase 18's trial actors and gang workers the d-64 wgmma flash
    # kernels
    # and phase 20's GPU actor on node B the serving kernels, phase 21's
    # generate stage the d-128 forward and its gang worker the d-64 flash
    # forward, dQ and dK/dV
    for part in (tp_serve, ckpt, tp_disagg, runtime, gang, data, served,
                 swept, clustered, planed):
        for name, n in part.items():
            launches[name] += n
    # the scalar kernels' rows: phase 8's count (its presets are fp32)
    launches.update(scalar)
    for rec in kernels:
        rec["launches"] = launches[rec["name"]]
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    table = [{k: rec[k] for k in order} for rec in kernels]
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s "
          f"(seconds a phase: {phase_seconds()})", flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
