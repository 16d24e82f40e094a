#!/usr/bin/env python3
"""Chip smoke for the PyTorch + CUDA port (``distkeras_tpu_torch``).

Run on a machine with one NVIDIA H100 (Hopper, sm_90a), the CUDA toolkit and
PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. the card's name and power limit (``nvidia-smi``);
2. build all five kernel sources from ``distkeras_tpu_torch/csrc`` (one
   ``nvcc`` per source, started together) and, beside them, the native
   parameter server's C++ core (``native/dkps.cpp``, ``g++``), then show
   that the kernels
   redesigned on wgmma (K2's, K3's and K4's bf16 paths, the small-D flash
   forward and fused backward at D = 16 and 32, K7's dwh product and every
   instantiation of K1's prefill kernel) issue ``HGMMA`` and ``UTMALDG``
   (TMA) instructions and spill nothing, and that K6's cluster
   scan, K7's two scans and K1's split decode kernel spill nothing
   (``check_sass``);
3. K1 ``q_matmul`` against its plain version at every Dense shape of the
   served 400M config: decode (M=8, twice for equal bits: the K split sums
   in rank order), the served prefill lengths (``SERVED_LENGTHS``) and
   M=1024, with kernel, plain and library (``torch.matmul`` over a
   pre-dequantized bf16 weight) times and the card's bound, each row with
   the launch plan (``quant.plan_q_matmul``), at the front door's chunk
   rows (``CHUNK_ROWS``) and at ``serve_decode``'s rows
   (``DECODE_ROWS``: 4, 16, 20, 40); then ragged edges for every kernel
   path;
4. K2 flash-attention forward against its plain version at prefill shapes
   (B=4 and the served B=1 lengths; H=16, Hkv=1, D=128, bf16, causal) and
   at small cases for its edge tiles (ragged L, windows, masked keys
   inside whole tiles, GQA 2 and MQA, fully masked rows, f32), and the
   small-D forward (bf16 at D = 16 and 32) at the LM twin's decode prefill
   and the same edges at both head dims, L past one key tile, with
   kernel, plain and library (``scaled_dot_product_attention``) times and
   the bound (the small-D rows also with the FMA kernel's time and their
   persistent grid);
5. K5 fused Adam against its plain version over the 8-worker stack of the
   IMDB LSTM's leaves (21.5 M f32 elements), bf16 gradients and misaligned
   leaves, with kernel, plain and library (``torch.optim.Adam(fused=True)``
   over the same tensors) times and the bound;
6. K6 and K7, the LSTM scan forward and backward, against their plain
   versions at the training shapes (G=8 workers, B=64, T=200, H=128, bf16;
   and G=1, the parameter-server path's launch, each worker alone)
   and small ragged f32 / bf16 cases at the edges of K6's cluster scan
   and K7's prefetch (see ``check_lstm``), K6 also without saved cell
   states (the eval path's launch), K7 twice for equal bits, with kernel,
   plain and library (cuDNN's ``nn.LSTM`` at the same T, G·B and H,
   forward and backward; its forget-bias convention differs, so it is
   timed, not compared) times and the bounds, K6's launch (cluster size,
   rows, blocks) and K7's two launches (the reverse scan, the dwh
   product) timed apart;
7. K2, K3 and K4, the flash-attention forward and backward (dq, dk/dv),
   against their plain versions at the LM's and the classifier's training
   shapes and at small GQA / window / ragged / masked-key / f32 /
   fully-masked cases, and the small-D forward and fused backward at the
   LM twin's shape, at D=32 and L=2048 and at their edges (see
   ``check_flash_bwd``), with kernel, plain and library (SDPA's forward
   and backward, on the device) times and the bounds; then the
   flash Function under ``torch.func.vmap(grad)`` at W=2, through the
   kernels and the plain versions (one launch of K2, K3 and K4 for the
   step); then the fused cross-entropy: its row kernels (``ce_fwd_rows``,
   ``ce_bwd_rows``) against their plain versions at config 9's head chunk
   with and without the bias, a ragged vocabulary and f32, db twice for
   equal bits, with kernel, plain and library (``F.cross_entropy``) times
   and the bounds; then the op in bf16 under ``vmap(grad)`` at the LM's
   head width: f32 logits, one row-kernel launch a chunk for both workers
   and no per-worker loop (``check_fused_ce``);
8. one DynSGD window at full width through the kernels and the same window
   through their plain versions on the card: the centers must agree within
   the stated bf16 tolerance (see ``compare_window``);
9. serve the 400M MQA decoder (vocab 16384, dim 2048, 16 heads, 1 KV head,
   depth 8, RoPE, flash prefill, bf16; random weights from seed 0) through
   ``GenerationServer`` to 4 concurrent ``GenerationClient``s (prompts of
   128/77/208/333 tokens, 32 greedy new tokens each), then quantize it
   (``quantize_lm``) and serve again; K1 and K2's launch counters, reset
   just before, must show both launched, K1 at decode and at prefill;
   every served stream is held to a full forward, tie-aware (see
   ``tie_aware_check``);
10. train: ``DynSGD(lstm_classifier(), worker_optimizer="fused_adam",
    features_col=["features", "mask"], num_workers=8, batch_size=64,
    communication_window=4)`` — BASELINE config 5 at its published width
    (vocab 20000, maxlen 200, embed 128, hidden 128, bf16 compute, f32
    params, lr 1e-3), random init from seed 0 — for two epochs of 6 windows
    on the synthetic IMDB stand-in; K5, K6 and K7's launch counters, reset
    just before, must show all three launched; the loss must fall, and the
    trained center's eval logits must match the plain-torch reference scan;
    then LeNet under ADAG (BASELINE config 2) on synthetic MNIST, 8
    workers, to test accuracy > 0.95;
11. one ADAG window of the config-9 LM at full width and depth 2 through
    K2–K5 and through their plain versions: centers within the stated bf16
    bound (see ``compare_lm_window``);
12. train config 9 (``bench.py:518-586``): ``transformer_lm_spec(vocab
    16384, maxlen 2048, dim 1024, heads 8, depth 8, RoPE, bf16 compute,
    f32 params, attn_impl="flash", fused_ce=True, ce_chunk=512)`` under
    ``ADAG(worker_optimizer="fused_adam", learning_rate=1e-4,
    num_workers=2, batch_size=8, communication_window=2)`` for two epochs
    of 3 windows on a learnable synthetic stream (``lm_tokens``), random
    init from seed 0; K2, K3, K4, K5 and the fused CE's row kernels'
    launch counters, reset just before, must all show launches, no
    ``vmap`` may fall back to a loop over workers, and the last window's
    loss must be below the first's; then config 6's encoder classifier
    (``transformer_classifier(vocab 8192, maxlen 2048, dim 512, heads 8,
    depth 8, attn_impl="flash")``) under ``DOWNPOUR(worker_optimizer="sgd",
    learning_rate=1e-3, num_workers=2, batch_size=8)`` for 3 windows on
    ragged rows; K2, K3 and K4 must have launched and the loss be finite;
13. the parameter-server backend (``backend="ps"``), every launch counter
    set to 0 just before each phase and read just after: config 3
    (CIFAR-10 VGG-small under DOWNPOUR, bf16 compute, f32 params, fused
    Adam at PS3_LR) through a ``SocketParameterServer`` the phase starts,
    4 worker threads of batch 512, window 1, 4 epochs of 32 windows a
    worker — 512 commits and 512 folds, some commit priced τ ≥ 1, K5
    launched 512 times, the loss falling and held-out accuracy above
    PS3_ACC_BAR;
    config 5 (the IMDB LSTM above) under DynSGD through the in-process PS,
    8 workers of batch 64, window 4, 2 epochs of 3 windows — K5, K6 and
    K7 launched once a step a worker (192 each), 48 commits, the loss
    falling; one worker through the in-process PS through the kernels and
    through their plain versions, centers within ``compare_window``'s bf16
    bound; then the MNIST example's twin
    (``distkeras_tpu_torch.examples.mnist``) in this process, ADAG and
    DOWNPOUR through the PS with int8 commits, each to test accuracy >
    0.8; then config 5 through the native PS at ``ps_pipeline_depth=1``
    (K5, K6 and K7 once a step a worker, 48 commits and folds, the loss
    falling, some commit priced τ ≥ 1, its τ beside the in-process serial
    run's); one DOWNPOUR worker on config 5 over the native PS serially
    and pipelined, centers within ``compare_ps_window``'s bound and
    displacement check (the largest difference printed); and config 3
    again through the native PS serially, and at depth 1 through the
    native and the shm PS at PS3_PIPE_LR for PS3_PIPE_EPOCHS (each run:
    one commit and one fold a window a worker, K5 once a step, every
    worker's loss falling, held-out accuracy above PS3_ACC_BAR; its
    window's phases, τ and the center lock's hold printed); each phase
    prints its wall time;
14. the parameter server's resilience layer on config 5 (8 workers, batch
    64, window 4, fused Adam, 2 epochs of 3 windows), each phase one JSON
    line, its launches counted alone and gated (K5, K6 and K7 once a step
    actually taken; lifetime folds equal the commits the clients saw
    acknowledged; the loss falling): ``ps_config5_chaos_socket`` (socket
    PS with a WAL snapshotting every PS5_SNAPSHOT_EVERY commits,
    ``RetryPolicy(seed=0)``, heartbeats with a lease below the restart
    delay, ``FaultPlan(seed=0, drop_recv=PS5_DROP, kill_at={3: 2})`` and a
    restart budget of one: some replay refused, one restart, some
    eviction, every worker's loss falling, the log recovered to the final
    center bit for bit, ``python -m distkeras_tpu_torch.resilience.wal
    verify`` clean), ``ps_config5_failover`` (a hot standby and a WAL, the
    primary killed after half the commits: one failover at fence epoch 1,
    the final center the standby's, the failover time printed beside the
    timeout) and ``ps_config5_native_wal`` (the native PS's C++ WAL with
    heartbeats at the chaos phase's lease, which every request renews, and
    retries, crash()ed after the last exchange: folds equal the logical
    commits, and the port's ``recover_ps_state`` gives the center last
    served bit for bit, with ``num_updates``, ``last_seq`` and
    ``fence_epoch``; the core's eviction count at the crash, once the
    log has drained, equal to the evict records in its log, every commit of the log, those after a worker's eviction
    too, folded once; a failing gate keeps the log and prints its path);
    the WAL phases print the durability cost (window
    time, ``ps.wal_wait`` total, fsyncs, bytes, the temporary directory's
    filesystem) beside the in-process window;
15. the sharded center (``sharding/``), each phase one JSON line, its
    launches counted alone: ``ps_config5_sharded_chain`` (config 5 over
    PS_SHARDS socket shards with a chain of PS_CHAIN links a shard and a
    WAL a server, the primary of the shard holding ``Embed_0.weight``
    killed after half the commits: one failover, on that shard, via its
    chain's link at fence epoch 1; every shard's folds equal the logical
    commits; the final center the join of the live shards; each shard's
    log replaying to its part; the WAL root verifying clean; every
    worker's loss falling; K5/K6/K7 once a step), ``ps_sharded_parity``
    (one worker of config 5 through the in-process PS at PS_PARITY_SHARDS
    shards and at one: centers equal bit for bit) and
    ``ps_config3_sharded_native`` (config 3 as the native serial run, over
    PS3_SHARDS native shards: every client's SHARD_INFO handshake under
    the plan, every shard folding every commit, config 3's gates), each
    printing the shards' bytes and the window's phases beside the
    unsharded run's;
16. checkpoints and the center's EMA on config 5, each phase one JSON
    line, its launches counted alone and gated (K5, K6 and K7 once a
    step): ``config5_resume_collective`` (DynSGD W=8 streaming its input,
    6 windows an epoch: CK_EPOCHS epochs straight against CK_EPOCHS - 1
    checkpointed and one resumed by a fresh trainer, centers within
    ``compare_window``'s bf16 bound, bit-equality printed; the same
    checkpoints written with ``checkpoint_async`` equal bit for bit; the
    checkpoint's bytes, the synchronous save, the async save on the
    caller's thread, the restore, the epoch with and without a checkpoint
    and the file system printed), ``config5_ema_collective`` (EMA_EPOCHS
    epochs at ``ema_decay`` 0, the EMA bit-equal to the center, and at
    EMA_DECAY, the EMA model above IMDB_ACC_BAR on fresh held-out rows;
    the window with and without the EMA printed) and
    ``ps_config5_checkpoint_ema`` (the in-process PS with a barrier
    checkpoint, the EMA, a worker killed after the first barrier and
    restored from its snapshot, folds equal the acknowledged commits; then
    a resume whose fold count starts at the saved one; the barrier's ms
    printed); the native WAL phase (14) runs with the EMA too, its log
    replaying the C++ EMA bit for bit, and the sharded parity phase (15)
    holds the joined EMA to the single server's bit for bit;
17. elastic membership on config 5 (``elastic=True``,
    ``RetryPolicy(seed=0)``, 8 initial workers, 2 epochs of 24 blocks),
    each phase one JSON line with the card's name and power limit, its
    launches counted alone and gated (K5, K6 and K7 once a step):
    ``ps_config5_elastic`` (the in-process PS, then the socket PS with a
    WAL, ``FaultPlan(join_worker_at_window={0: 1},
    preempt_worker_at_window={3: 2})``: the assigner's ledger exactly
    once, one join, one clean drain and the pool back at 8 in the
    coordinator and the server, folds equal the acknowledged commits, the
    joiner's first DynSGD τ priced from its join pull, the loss falling;
    the join's ms (request to first commit), the drain's ms (notice to
    report) and the window's ms before and after the join printed),
    ``ps_config5_elastic_native_pipelined`` (the
    native PS at depth 1: the same gates, the core's counters equal to
    the in-process run's), ``ps_config5_elastic_sharded`` (2 socket
    shards: every shard's folds equal the logical commits, every shard
    counted the join and the drain) and ``ps_config5_autoscale`` (an
    ``ElasticPolicy`` whose 1e6 rounds/s no pool reaches, at most
    PS5_POOL_MAX workers: some autoscaler join, the live pool never above
    the cap, the ledger exact; its decisions printed with their times);
18. the membership directory (``directory/``), each phase one JSON line
    with the card, its launches counted alone:
    ``ps_config5_directory_chaos`` (config 5 elastic over 2 chained socket
    shards with ``directory=True``: every client, the joiner's too, minted
    from a lookup; shard 1's primary killed at half the commits, the
    directory primary at its PS5_DIR_KILL_OPS-th op, a partition window of
    dropped directory ops; gates: one kill of each, one join, drops ridden
    out, a shard and a directory failover, folds equal the logical
    commits on every shard, each shard's log replaying bit for bit to its
    part, ``wal verify`` naming the directory log, the ledger exact, both
    shards in the final membership with shard 1 at the promoted link and
    fence epoch >= 1, the directory's lookups at least the 9 clients, the
    loss falling, K5/K6/K7 once a step; the failovers' ms beside their
    timeouts printed, and the windows outside the failovers beside a
    control run's, the same trainer and plan without the directory) and
    ``ps_config5_ps_directory`` (a trainer that knows only
    ``ps_directory=`` trains against 2 shards this script hosts and
    registers: folds equal the logical commits on each shard, the
    trainer's center the join of the shards' bit for bit, K5/K6/K7 once a
    step). ``serve_router_int8`` runs in phase 9's serving block: two
    ``GenerationServer`` replicas of the int8 model registered with
    ``register_with`` behind a ``RoutedGenerationClient``; one prefix's
    repeats on one replica, distinct prefixes on both, 10 concurrent
    streams all complete with replica "a" hard-killed mid-stream, every
    stream (and the same prompts served unrouted) tie-aware, "a" out of
    the directory within 3 TTLs, K1 and K2 launched on the routed traffic
    alone;
19. ``serve_frontdoor`` runs after ``serve_router_int8`` in phase 9's
    serving block: ``GenerationEngine(prefix_cache=True,
    prefill_chunk=FD_CHUNK, admission="slo", max_batch=FD_BATCH)`` driven
    on this thread by ``_drive_frontdoor`` (a chat with a 384-token system
    prompt stepped to its first token; five more sharing it, two
    diverging mid-block; a 900-token document; two realtime requests, one
    sampled, arriving one block short of the pool), int8 with a mid-run
    refill swap to the seed-1 int8 weights, and bf16; gates: every
    request completes, every stream tie-aware under the weights that
    served it (the swapped-in ones through the engine's own module), the
    shared prompt's hits (>= 5 x 384 tokens), a COW copy, a preemption,
    the pool empty after ``flush_prefix_cache``, the tree and the pool
    empty when the swap landed (its ``stats()["last_swap"]`` record), K1
    launched at prefill and decode on the int8 traffic alone; each token
    off the full forward's exact top k is probed against a full forward
    whose attention rounds like the served path's (``attn_impl=
    "reference"``: bf16 scores and probabilities) and against a replay of
    the chunk program over its context (``probe_gaps``), information
    only;
    beside them a FIFO control (the same jobs, cache off) for tokens/s
    and per-class latency;
20. ``serve_decode`` runs after ``serve_frontdoor``, on the same models:
    the dense-cache ``generate`` (greedy int8 and bf16, each held to the
    engine's streams of the same 4 prompts of 128 tokens, split only at
    a tie; sampled bf16 at top_k 8, one seed twice), ``beam_search`` at 4
    beams on int8 (beams 1 equal to greedy up to a tie; the best beam's
    score its full-forward log-prob within ``BEAM_TOL_ULP`` ulps a token,
    greedy's beside it), greedy ``speculative_generate`` at K=4 (bf16
    with the int8 twin as draft, and int8 drafting itself), the engine
    with ``draft=``
    behind the server on ``serve``'s traffic (int8 drafting itself, its
    acceptance at least ``SPEC_SELF_FLOOR``; bf16 with the int8 draft),
    a ``ResilientGenerationClient`` request across a server crash and a
    restart on the same port (equal to the uncrashed stream, a
    reconnect), and ``GeneratorPredictor`` greedy and at 2 beams, equal
    to ``generate`` and ``beam_search``; every stream tie-aware, K1
    launched at M = 4, 8, 16, 20 and 40 and K2 on every dense prefill;
    after the classifier's training, ``ModelPredictor(quantize=True)`` on
    it (argmax agreement with bf16 at least ``CLS_AGREE``; logits within
    ``CLS_DEQ_TOL`` of the logit scale of a float forward over its own
    dequantized weights; K1 held to its plain version at the classifier's
    Dense shapes in phase 3);
21. the model families (A10), after the directory phases, each one JSON
    line with the card's name and power limit, its wall time, launches
    (counted alone) and gates: ``a10_resnet_adag_syncbn``
    (``resnet_small(sync_bn=True)`` at widths 16/32/64 in bf16 under ADAG,
    W=8 of batch 64, window 2, fused Adam, on the CIFAR-10 stand-in: one
    window through K5 equal to its plain version, every worker's
    ``bn_stem`` statistics equal and moved, the W-worker forward equal to
    the flat batch's within A10_FWD_TOL, K5 once a step, the eval-mode
    prediction finite with its accuracy), ``a10_resnet_ps`` (per-worker
    BN through the in-process PS, 4 threads: ``trained_nt_`` moved, K5
    once a step a worker, ``sync_bn`` refused), ``a10_sru_dynsgd``
    (``sru_classifier()`` on config 5's data and trainer: ``assoc`` equal
    to ``scan`` in f32 on the card, the loss falling, K5 once a step, its
    window beside config 5's LSTM window), ``a10_moe_adag``
    (``moe_transformer_classifier()`` under ADAG, W=2 of batch 16: the
    K5 window parity, ``moe_aux_loss`` finite, K5 once a step, the
    dropped slot share) and ``a10_config9_remat`` (one config 9 window
    without and with ``remat=True``: centers within the LM window's
    bound, bit-equality printed, the remat peak memory lower, K2 twice
    as often, K3 and K4 as often);
22. one model over a mesh (A12), each phase in an NCCL world of one it
    makes and destroys, one JSON line with the card, its launches
    (counted alone) and gates: ``a12_config9_mesh`` (config 9 through
    ``MeshTrainer(mesh_shape={"dp": 1}, input_mode="resident",
    worker_optimizer="fused_adam")``, 2 epochs of A12_LM_STEPS steps: the
    loss falling, K2–K4 depth × steps and K5 steps, two steps bit-equal
    to a hand-written single-device step of the same module and kernels;
    tokens/s and the peak memory beside the ADAG W=2 window's),
    ``a12_config6_mesh`` (config 6 under
    ``parameter_sharding="fsdp+megatron"`` on ``{"dp": 1, "tp": 1}``,
    SGD: the same gates, but two steps' update within A12_SGD_GAP of the
    hand-written step's, and a ``.dkc`` resume bit-equal to the
    uninterrupted run) and ``a12_strategies`` (``"sequence"`` on config
    6 with SGD, its update within A12_SGD_GAP of spmd's; ``"expert"`` on
    the MoE classifier and ``"pipeline"`` on config 6 at depth 1 with
    fused Adam, bit-equal to spmd's; each on a mesh of one rank against
    ``"spmd"`` on the same model and rows);
23. W workers over processes (A12.2), each phase counting its own
    launches: ``a12_dp_mesh_config5`` (config 5 under DynSGD, W=8, for
    A122_IMDB_WINDOWS windows with ``mesh=None`` and through
    ``mesh=Mesh({"dp": 1})`` in an NCCL world of one: centers and losses
    bit-equal, K5, K6 and K7 once a step in both), ``a12_dp_mesh_config9``
    (two one-window epochs of config 9 under ADAG W=2 both ways:
    bit-equal, K2–K4 depth × steps and K5 steps; the second window's ms
    and the peak memory beside ``train_lm``'s) and ``a12_ps_two_process`` (two processes of this
    script, ``--ps-rank``, started by ``job_deployment.LocalRunner`` in a
    gloo world on the one card: config 5 under DynSGD through the
    multi-process ``backend="ps"`` over socket and native, 4 + 4 worker
    threads, rank 0 hosting the PS; commits = updates = acknowledged
    windows, both ranks' centers equal, the loss falling, K5–K7 summed
    over the ranks equal to the workers' steps);
24. deploy streaming (A13), ``a13_deploy_stream``: config 9's LM at full
    width and depth A13_DEPTH trains under ADAG through the in-process PS
    with a ``WeightStreamer`` attached (``deploy_streamer=``); a bf16 and
    an int8 ``GenerationServer`` in a ``DirectoryServer`` serve its
    versions; a ``RolloutController`` canaries and promotes the second,
    canaries the third and rolls it back when its ``health`` reports the
    SLO firing; every stream equals a fresh engine's at its version, the
    streamer reaches the last fold, the PS's deploy lag at training's end
    stays within the fold count, the journal holds
    the four transitions, and K1–K5 launch;
25. observability (A13), each phase counting its own launches:
    ``a13_observe_ps_config5`` (config 5 through the socket PS with a WAL,
    ``analyze=True`` and the watchtower; the CLI scrapes the live server
    — ``dump --prom``, ``health --watch`` — and analyzes the saved trace
    and series: the regime, ``host_busy_fraction``, each worker's
    critical path and window ms, the overlap; every window assembled, no
    span dropped, K5–K7 as in the in-process phase),
    ``a13_observe_native_config5`` (the same on the native PS with the
    C++ WAL: one "dkps" ``ps.fold`` span a fold, each commit decomposed
    against them), ``a13_watch_serving`` (the int8 400M decoder served
    traced with a serving watchtower: the ``metrics`` reply, the serving
    report's queue/prefill/decode split over every request, tie-aware
    streams, K1 and K2; the server's flight recorder writes its timeline
    to a temporary ``trace_dir``, whose file holds one ``serve.request``
    span a request, as many as in memory, and gives the analyzer the same
    served count) and ``a13_watch_rollout`` (``a13_deploy_stream``
    with the trainer's DeployLagRule and ``health`` from a serving
    watchtower whose SLO rule an injected latency fault fires);
    ``a22_native_shm_lane`` (host code, no kernel: the native PS's shm
    ring lane at config 5's center under DynSGD with 8 workers: 8 lane
    clients and 8 TCP clients of two servers fold the same seeded
    exchanges bit-equal, a TCP client pulls what a lane client pulls, the
    int8 pull streams agree, ``set_model`` reads back bit-equal, 8 lane
    threads exchange at once with commits = folds, no segment survives
    ``stop()``; the median and min–max ms of one exchange over each);
26. the example twins (``distkeras_tpu_torch/examples``) at their own
    defaults, each phase one JSON line with the card, its wall time and
    its launches (counted alone, K1's also by rows): ``examples_lm`` (the
    cyclic LM trained under ADAG in bf16 through the small-D flash
    kernels, then greedy, beam-4 and int8 decodes, each at 0.9
    continuation accuracy; the fused backward once a block a step and K3
    and K4 never, the small-D forward as often plus the decodes'
    prefills, K1 at M=4 and M=32), ``examples_longcontext`` (one fwd+bwd+Adam step of the
    rematted classifier at L=4096: K2 twice a block, K3 and K4 once; the
    sequence-parallel leg on one rank), ``examples_parallelism`` (dp, tp,
    fsdp, pp, sp and ep in a world of one, every MeshTrainer loss
    falling), ``examples_serve_lm`` and ``examples_serve_lm_spec`` (every
    served stream equal to ``generate()``, the eos stream stopping at the
    oracle's first eos), ``examples_train_while_serving`` (promote, then
    roll back; every stream equal to the oracle at its version),
    ``examples_workflow`` (the notebook's cells, read with ``json``: AEASGD
    and EAMSGD above 0.70) and ``examples_alias`` (``distkeras_torch``'s
    ADAG is the port's, no JAX loaded); K1-K4 are also held to their plain
    versions at these shapes in phases 3, 4 and 7;
27. print the ``kernels`` JSON line (K1 as one decode step and, as
    ``q_matmul_prefill``, one 1024-token prefill; the small-D flash
    kernels at the LM twin's training shape, with their launches on
    ``examples_lm``; every row with its
    launches on the PS phases, the checkpoint and EMA phases, the
    elastic phases, the directory phases, the front door,
    ``serve_decode``, the model family, the mesh, the W-over-processes,
    the deploy and the example phases, K6 and K7
    with their G=1 times), read config 3's
    gates (``ps3_failures``, the sharded run's too), then the result line
    ``{"ok": true, "device": {...}}`` last.

The library calls are yardsticks only; the port never calls them.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np

PEAK_BYTES = 3.35e12        # H100 SXM HBM3, bytes/s
PEAK_BF16 = 989e12          # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12            # H100 SXM f32 FLOP/s outside the tensor cores

DEVICE = "cuda"
SMI = None                # nvidia-smi's name and power limit, set by main()
VOCAB, MAXLEN, DIM, HEADS, KV_HEADS, DEPTH = 16384, 1024, 2048, 16, 1, 8
PROMPTS = (128, 77, 208, 333)
SERVED_LENGTHS = (80, 128, 208, 336)   # the prompts padded to BLOCK
NEW_TOKENS = 32
BLOCK = 16
# serve_frontdoor's traffic on the served config: a FD_SYSTEM-token system
# prompt (24 full blocks) shared by six best-effort chats — the first with
# a FD_FIRST-token suffix, stepped alone to its first token, then five
# with FD_CHATS-token suffixes, those at FD_COW repeating the first's
# first FD_COW_LEN suffix tokens and diverging mid-block — a FD_DOC-token
# document (ceil(900/256) = 4 chunks), then FD_RT realtime prompts, the
# second sampled; NEW_TOKENS each. The pool leaves the first realtime
# request one block short, so it must preempt.
FD_CHUNK, FD_SYSTEM, FD_FIRST = 256, 384, 56
FD_BATCH = 8              # the front door engine's max_batch
# the front door's chunk program at prefill_chunk=FD_CHUNK runs its Dense
# layers at M = npad·FD_CHUNK, npad the prefilling rows rounded up to a
# power of two (<= FD_BATCH): 256, 512, 1024, 2048; and 4·100, which no
# token tile divides
CHUNK_ROWS = tuple((1 << i) * FD_CHUNK
                   for i in range(FD_BATCH.bit_length())) + (4 * 100,)
FD_CHATS, FD_COW, FD_COW_LEN = (120, 40, 200, 72, 160), (1, 3), 8
FD_DOC, FD_RT = 900, (64, 96)
FD_RT_SAMPLING = dict(temperature=0.7, top_k=8, seed=3)
FD_SWAP_AFTER = 4         # realtime tokens before the int8 run's swap
# serve_decode on the served config: DECODE_B prompts of DECODE_LP tokens
# through the dense-cache functions, NEW_TOKENS new; sampled at top_k
# DECODE_TOP_K; BEAMS beams; speculation at K=SPEC_K. K1's rows there
# (DECODE_ROWS): dense int8 decode B=4, beams 4 x 4, the dense int8
# verify 4 x (K+1), the engine's int8 verify 8 x (K+1); its draft steps
# run at the engine's 8 rows
DECODE_B, DECODE_LP, DECODE_TOP_K, BEAMS, SPEC_K = 4, 128, 8, 4, 4
DECODE_ROWS = (DECODE_B, DECODE_B * BEAMS, DECODE_B * (SPEC_K + 1),
               8 * (SPEC_K + 1))
# the beam gate: the best beam's score (summed on the decode path) equals
# its full-forward log-prob within BEAM_TOL_ULP bf16 ulps (at each row's
# max logit) summed over its tokens: the two paths round each token's
# logits up to tie_aware_check's two ulps apart. Its log-prob against
# greedy's is reported, not gated: beam search does not always beat
# greedy (on a random-weight model some rows end below it, PERF.md)
BEAM_TOL_ULP = 2.0
# the int8 model drafting itself in the engine: its draft steps take K1's
# decode plan (M=8) and its verify the prefill plan (M=40), which sum in
# different orders, so bf16 near-ties flip; the floor is the prediction
# written in PERF.md before the first run on the card
SPEC_SELF_FLOOR = 0.8
# the resilient client's request: RESILIENT_NEW new tokens, its server
# crashed once the engine has run RESILIENT_CRASH_AT steps
RESILIENT_NEW, RESILIENT_CRASH_AT = 128, 16
# GeneratorPredictor: PRED_N prompts of PRED_LP tokens in one chunk
PRED_N, PRED_LP, PRED_NEW = 16, 64, 16
# the config 6 classifier served in int8: CLS_PRED_ROWS fresh rows in
# chunks of CLS_PRED_BATCH, argmax agreement with bf16 at least CLS_AGREE
CLS_PRED_ROWS, CLS_PRED_BATCH, CLS_AGREE = 64, 8, 0.98
# the int8 classifier's logits against a plain forward over its own
# dequantized weights on the same rows: max |difference| at most
# CLS_DEQ_TOL of the plain logits' largest magnitude. The logits leave the
# head in bf16, whose ulp is 2^-7 of a power of two below the scale, and
# the plain forward rounds the dequantized weights to bf16 where the
# kernel widens them exactly: 0.02 is about 2.6 ulps at a scale of 2, a
# wrong kernel is off by the scale itself (prediction in PERF.md)
CLS_DEQ_TOL = 0.02
# Dense shapes (K, N) of the config: qkv, attn_out, mlp_up, mlp_down, head
DENSE = ((2048, 2304), (2048, 2048), (2048, 8192), (8192, 2048),
         (2048, 16384))
PER_STEP = {(2048, 2304): DEPTH, (2048, 2048): DEPTH, (2048, 8192): DEPTH,
            (8192, 2048): DEPTH, (2048, 16384): 1}
# BASELINE config 5 at its published width: IMDB LSTM under DynSGD
IMDB_VOCAB, IMDB_T, IMDB_E, IMDB_H = 20000, 200, 128, 128
IMDB_W, IMDB_BATCH, IMDB_WINDOW, IMDB_LR = 8, 64, 4, 1e-3
IMDB_WINDOWS = 6          # windows per epoch of the training phase
# config 9 (bench.py:518-586): the causal LM training composition, under
# ADAG with W=2 stacked workers of batch 8 (B'=16 folded into the kernels)
LM_VOCAB, LM_L, LM_DIM, LM_HEADS, LM_DEPTH = 16384, 2048, 1024, 8, 8
LM_W, LM_BATCH, LM_WINDOW, LM_WINDOWS = 2, 8, 2, 3
LM_LR, LM_CHUNK = 1e-4, 512
LM_CMP_DEPTH = 2          # kernels-vs-plain window: plain attention holds
#                           [B', H, L, L] f32 scores per layer
# config 6 (bench.py:370-386): the encoder classifier under DOWNPOUR
CLS_VOCAB, CLS_L, CLS_DIM, CLS_HEADS, CLS_DEPTH = 8192, 2048, 512, 8, 8
CLS_W, CLS_BATCH, CLS_WINDOW, CLS_WINDOWS, CLS_LR = 2, 8, 5, 3, 1e-3
# the classifier's Dense shapes (K, N) as quantize_serving serves them,
# each with its rows M: qkv, attn_out, mlp_up, mlp_down at one predictor
# batch's tokens, the 2-class head at the pooled batch
CLS_DENSE = tuple(((k, n), (CLS_PRED_BATCH * CLS_L,)) for k, n in (
    (CLS_DIM, 3 * CLS_DIM), (CLS_DIM, CLS_DIM), (CLS_DIM, 4 * CLS_DIM),
    (4 * CLS_DIM, CLS_DIM))) + (((CLS_DIM, 2), (CLS_PRED_BATCH,)),)
LOSS = "sparse_softmax_cross_entropy"
# the parameter-server path (backend="ps"): config 3 (bench.py:316-324,
# CIFAR-10 VGG-small under DOWNPOUR) through a socket PS this script
# starts, 4 worker threads of batch 512 over 65536 rows, 4 epochs.
# Window 1, DOWNPOUR's push every step: at window 4 four workers' summed
# multi-step Adam windows learn slowly and erratically, in the JAX package
# too. Adam at 2.5e-4, half bench.py's 5e-4: at 5e-4 one serial run in
# five or six misses the accuracy bar (PERF.md, Findings). The loss sits
# on a plateau near 2.3 for an epoch or two, and at 2 epochs about one
# run in ten has a worker whose loss has not yet fallen (PERF.md,
# Findings), so 4 epochs
PS3_W, PS3_BATCH, PS3_WINDOW, PS3_LR, PS3_EPOCHS = 4, 512, 1, 2.5e-4, 4
PS3_WINDOWS = 32          # windows a worker an epoch
PS3_TEST = 2048
PS3_ACC_BAR = 0.3         # held-out accuracy gate (PERF.md, Findings)
# DOWNPOUR with four Adam workers learns config 3 while lr·τ stays near
# 1e-3 (PERF.md, Findings): τ is ~3 serially and ~7 pipelined, so the
# pipelined runs take half the rate for twice the epochs: at that rate
# the plateau lasts about three epochs
PS3_PIPE_LR, PS3_PIPE_EPOCHS = 1.25e-4, 8
# config 5 through the in-process PS: 8 worker threads of batch 64,
# window 4, 3 windows a worker an epoch, 2 epochs
PS5_W, PS5_WINDOWS, PS5_EPOCHS = 8, 3, 2
PS_PARITY_WINDOWS = 2     # the one-worker kernels-vs-plain PS run
PS_DISP_FRAC = 0.25       # its per-leaf displacement agreement
PS_PIPE_WINDOWS = 3       # the one-worker serial-vs-pipelined native run
# the resilience phases: config 5 as PS5_* runs it, through the socket PS
# under chaos (drops, a worker killed and restarted), through a standby
# failover, and through the native PS's C++ write-ahead log. The chaos
# phase's lease lapses during the killed worker's restart delay while its
# peers still heartbeat (windows of ~0.4 s: the eviction is seen), and
# stays above a live worker's heartbeat gap (a window and its exchange)
PS5_DROP = 0.15           # the chaos phase's drop_recv
PS5_KILL = {3: 2}         # worker 3 dies at its window 2
PS5_HEARTBEAT, PS5_LEASE, PS5_RESTART_DELAY = 0.05, 1.0, 2.0
PS5_ATTEMPTS = 12         # tries a call: a try fails with p ~ 0.28
PS5_MAX_DELAY = 0.2       # backoff cap: a replay reaches the server well
#                           inside the lease its fold renewed
PS5_SNAPSHOT_EVERY = 16   # snapshots (and log truncation) in the run
PS5_FAILOVER_TIMEOUT = 2.0
# the sharded center: config 5 over PS_SHARDS socket shards with a chain
# of PS_CHAIN links a shard, the heavy shard's primary killed at half the
# commits; the one-worker parity run at PS_PARITY_SHARDS against one PS;
# config 3 over PS3_SHARDS native shards
PS_SHARDS, PS_CHAIN, PS_PARITY_SHARDS, PS3_SHARDS = 2, 2, 4, 4
# checkpoints and the center's EMA on config 5. The collective runs stream
# their input (the EMA folds every window's center, which the resident
# path never hands back), IMDB_WINDOWS windows an epoch: run A trains
# CK_EPOCHS epochs, run B checkpoints CK_EPOCHS - 1 and a fresh trainer
# resumes the last, run C is B with checkpoint_async. The EMA runs train
# EMA_EPOCHS epochs (96 windows): an EMA at 0.99 keeps 0.99^n of its
# initial center after n folds, 0.83 after run A's 18 windows, 0.38 after
# 96, so only the longer run's EMA is a trained model to score
CK_EPOCHS = 3
EMA_DECAY = 0.99
EMA_EPOCHS = 16
IMDB_ACC_BAR = 0.75       # held-out accuracy of config 5's EMA model
IMDB_HELDOUT = 1024       # fresh rows of the synthetic IMDB stand-in
PS_CK_KILL = 3            # the PS phase's worker killed at its window
#                           PS5_WINDOWS: the first window after the first
#                           epoch barrier
# elastic membership on config 5 (PS5_W initial workers, 2 epochs of
# PS5_W * PS5_WINDOWS = 24 blocks): one worker joins when worker 0 has
# finished its first window, worker 3 is preempted at its second; the
# autoscaler's target no pool of the card reaches, so it joins up to
# PS5_POOL_MAX workers
PS5_ELASTIC_PLAN = dict(join_worker_at_window={0: 1},
                        preempt_worker_at_window={3: 2})
PS5_POOL_MAX = 10
# the membership directory on config 5: the elastic run over PS_SHARDS
# socket shards chained PS_CHAIN deep, with the hosted directory and its
# standby. Shard 1's primary dies at half the commits and the directory
# primary at its PS5_DIR_KILL_OPS-th op; ops PS5_DIR_PART_AFTER + 1 ..
# + PS5_DIR_PART_OPS are dropped (a partition right after the two
# registrations and the eight initial lookups). The directory's op count
# grows with time (its supervisors renew both entries every half second),
# so the kill lands a few seconds in, after the joiner's lookup. Leases
# outlast a sharded window (~1 s on the card) and a failover; the
# retry budget is the JAX package's acceptance test's, since a client
# waits out a shard failover and a directory failover
PS5_DIR_KILL_OPS = 24
PS5_DIR_VICTIM = 1
PS5_DIR_KILL_AFTER = PS5_W * PS5_WINDOWS * PS5_EPOCHS // 2
PS5_DIR_PART_AFTER, PS5_DIR_PART_OPS = 10, 4
PS5_DIR_HEARTBEAT, PS5_DIR_LEASE = 0.25, 10.0
PS5_DIR_RETRY = dict(max_attempts=200, base_delay=0.01, max_delay=0.2,
                     deadline=120.0, seed=0)
# the prefix-affine router over two int8 replicas of the served config:
# the route key's prefix, the replicas' directory lease, the concurrent
# requests of the kill
ROUTER_PREFIX, ROUTER_TTL, ROUTER_REQUESTS = 16, 1.0, 10
# the model families (A10), each phase at its family's full default width:
# ResNet-8 (widths 16/32/64, one block a stage, bf16) with sync BN under
# ADAG on the synthetic CIFAR-10 stand-in, W=8 of batch 64, window 2;
# the same ResNet with per-worker BN through the in-process PS, 4
# threads; the SRU classifier on config 5's data and trainer; the MoE
# classifier (dim 128, 4 heads, depth 2, 8 experts, top-2, capacity
# 2.0) under ADAG, W=2 of batch 16; config 9's spec with and without remat
A10_RESNET_W, A10_RESNET_BATCH, A10_RESNET_WINDOW = 8, 64, 2
A10_RESNET_WINDOWS, A10_RESNET_EPOCHS, A10_RESNET_LR = 6, 2, 1e-3
A10_RESNET_TEST = 1024
A10_FWD_TOL = 0.02        # W-worker sync-BN forward vs the flat batch's,
#                           of the logit scale: bf16 convs read BN outputs
#                           normalized with statistics summed in another
#                           order, which may round one bf16 ulp apart
A10_PS_W, A10_PS_WINDOWS = 4, 4
A10_SRU_TOL = 1e-5        # f32 assoc vs scan, of max(1, |c|) and the logits
A10_MOE_W, A10_MOE_BATCH, A10_MOE_WINDOW = 2, 16, 2
A10_MOE_WINDOWS, A10_MOE_LR = 8, 1e-3
# one model over a mesh (A12): MeshTrainer on an NCCL world of one, batch
# A12_BATCH (bench.py's B for configs 6 and 9); 2 epochs over the same
# steps' rows, so the second epoch's loss is read on rows already trained
A12_BATCH, A12_LM_STEPS, A12_CLS_STEPS, A12_STRAT_STEPS = 8, 3, 3, 2
A12_STRAT_LR = 1e-3
# the largest relative gap of an SGD update from its reference's, per leaf
# (_update_gap: a gradient scaled by 2 gives 1, one of flipped sign 2).
# Read on an H100 80GB HBM3 at 700 W: config 6's fsdp+megatron steps
# 1.48e-2 from the hand-written step's, the sequence strategy's 2.41e-2
# from spmd's (the embedding's sparse rows both times)
A12_SGD_GAP = 0.1
# config 9's ADAG W=2 window peak of max_memory_allocated (H100 80GB HBM3,
# 700 W; PERF.md §5), printed beside MeshTrainer's one-model peak
ADAG_W2_WINDOW_PEAK_GB = 30.0
A122_IMDB_WINDOWS = 3     # config 5 windows of the dp-mesh phase
A122_PS_WINDOWS = 3       # windows a worker an epoch, two-process PS
A122_RANK_TIMEOUT = 420.0  # seconds the two ranks get, socket and native
A13_DEPTH = 2             # config 9's depth in the deploy phase
A13_WINDOWS = 4           # windows a worker (2 PS workers)
A13_SNAPSHOT_EVERY = 2    # folds between streamed versions
A13_PROMPTS = (96, 160)   # prompt lengths each stream check sends
A13_NEW = 16              # greedy new tokens a stream
# observability (A13's second half): the watchtower's scrape interval in the
# observe phases, the deploy lag (folds) the watched rollout's
# DeployLagRule allows (three snapshot intervals), and its served p99 SLO
# (the injected fault reads ten times it)
A13_SCRAPE = 0.25
A13_LAG_BOUND = 3 * A13_SNAPSHOT_EVERY
A13_SLO_P99_MS = 1000.0
A22_EXCHANGES = 6         # exchanges a worker in a22_native_shm_lane
A22_INT8_PULLS = 3        # int8 pulls a lane in its stream comparison
# the example twins (distkeras_tpu_torch/examples), each driven at its own
# defaults. The LM twin: vocab 64, dim 64, 4 heads (D=16), depth 2,
# training rows of EX_LM_L tokens under ADAG with W=2 workers of batch 64
# (B'=128 at the flash kernels, causal, bf16), window 2; its decodes run 4
# prompts of 8 tokens (K2's prefill at B=4, L=8; K1's prefill plan at M=32
# and its decode plan at M=4, at the model's Dense shapes K=64 and 256).
# The long-context twin's flash+remat leg: dim 512, 8 heads (D=64), depth
# 8, L=4096, B=8, an all-ones key mask, non-causal, bf16
EX_LM_VOCAB, EX_LM_DIM, EX_LM_HEADS, EX_LM_DEPTH, EX_LM_L = 64, 64, 4, 2, 128
EX_LM_W, EX_LM_BATCH, EX_LM_WINDOW = 2, 64, 2
EX_LM_PROMPTS, EX_LM_PROMPT_LEN = 4, 8
EX_LM_DENSE = tuple(((k, n), (EX_LM_PROMPTS,
                              EX_LM_PROMPTS * EX_LM_PROMPT_LEN))
                    for k, n in ((EX_LM_DIM, 3 * EX_LM_DIM),
                                 (EX_LM_DIM, EX_LM_DIM),
                                 (EX_LM_DIM, 4 * EX_LM_DIM),
                                 (4 * EX_LM_DIM, EX_LM_DIM)))
EX_LC_L, EX_LC_B, EX_LC_DIM, EX_LC_HEADS, EX_LC_DEPTH = 4096, 8, 512, 8, 8
MNIST_RUNS = (["--trainer", "adag"],
              # DOWNPOUR sums 4 workers' Adam windows: window 1 (the
              # paper's push-every-step) is where it learns reliably
              ["--trainer", "downpour", "--backend", "ps", "--compression",
               "int8", "--workers", "4", "--window", "1"])


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float, peak_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_ms=t_bytes, ops_ms=t_ops)


def _events(torch, run, n: int) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        run()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def eager_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Time per call issued from Python one after another (CUDA events):
    the device time, or the host's time per call where the host is the
    slower of the two."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _events(torch, fn, iters) / iters


def cuda_ms(torch, fn, iters: int = 20, replays: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed ``replays`` times (CUDA events), so the Python wrappers' host
    time between launches is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _events(torch, graph.replay, replays) / (iters * replays)
    del graph
    return ms


def rotating(items):
    """A callable stepping through ``items`` — weights rotated so each
    timed launch reads them cold from HBM, as a decode step does."""
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % len(items)
        return items[state["i"]]

    return nxt


def check_q_matmul(torch, quant):
    """Phase 3: K1 against its plain version at every Dense shape of the
    served config: decode (M=8, the served batch), serve_decode's rows
    (DECODE_ROWS: dense decode, beams, the dense and the engine's verify),
    the served prefill lengths (SERVED_LENGTHS, one batched prefill per
    padded length), the front door's chunk program (CHUNK_ROWS) and
    M=1024; at the int8 classifier's shapes (CLS_DENSE) and the LM
    twin's int8 decode (EX_LM_DENSE, K=64 and 256); with kernel,
    plain and library times and the card's bound; the split decode
    kernel twice for equal bits; then ragged edges."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    rows, max_err = [], 0.0
    served = tuple(dict.fromkeys(
        (8, *DECODE_ROWS, *SERVED_LENGTHS, *CHUNK_ROWS, 1024)))
    for (k, n), ms, model in (
            tuple((kn, served, "lm") for kn in DENSE)
            + tuple((kn, m, "classifier") for kn, m in CLS_DENSE)
            + tuple((kn, m, "lm_twin") for kn, m in EX_LM_DENSE)):
        w = torch.randn((n, k), generator=gen, device=DEVICE) * 0.02
        qt = quant.quantize(w, axis=1)
        nrot = max(1, min(48, math.ceil(200e6 / qt.q.numel())))
        qs = [quant.QTensor(qt.q.clone(), qt.scale.clone())
              for _ in range(nrot)]
        deq = [quant.dequantize(q_, axis=1, dtype=torch.bfloat16)
               for q_ in qs]
        cases = [(m, torch.bfloat16) for m in ms]
        if (k, n) == DENSE[0]:   # ragged decode rows, and the f32 kernel
            cases += [(13, torch.bfloat16), (8, torch.float32),
                      (1024, torch.float32)]
        for m, dt in cases:
            x = torch.randn((m, k), generator=gen, device=DEVICE).to(dt)
            got = quant.q_matmul(x, qt).float()
            again = quant.q_matmul(x, qt).float()
            ref = quant._q_matmul_plain(x, qt.q, qt.scale, dt).float()
            torch.cuda.synchronize()
            rtol = 1e-2 if dt == torch.bfloat16 else 1e-5
            atol = 1e-3 * ref.abs().max().item() if dt == torch.bfloat16 \
                else 1e-5 * ref.abs().max().item()
            err = (got - ref).abs().max().item()
            ok = torch.allclose(got, ref, rtol=rtol, atol=atol)
            if not (ok and torch.isfinite(got).all()):
                raise AssertionError(
                    f"q_matmul M={m} K={k} N={n} {dt}: max |kernel - plain| "
                    f"= {err} beyond rtol={rtol}, atol={atol}")
            if not torch.equal(got, again):   # the K split sums in rank order
                raise AssertionError(f"q_matmul M={m} K={k} N={n} {dt}: two "
                                     f"launches differ")
            max_err = max(max_err, err)
            plan = quant.plan_q_matmul(m, n, k, dt)
            nq, nd = rotating(qs), rotating(deq)
            kernel_ms = cuda_ms(torch, lambda: quant.q_matmul(x, nq()))
            call_ms = eager_ms(torch, lambda: quant.q_matmul(x, nq()))
            plain_ms = cuda_ms(torch, lambda: quant._q_matmul_plain(
                x, *nq(), dt), iters=10)
            library_ms = (cuda_ms(torch, lambda: torch.matmul(x, nd().t()))
                          if dt == torch.bfloat16 else None)
            esz = 2 if dt == torch.bfloat16 else 4
            nbytes = m * k * esz + k * n + n * 4 + m * n * esz
            row = dict(M=m, K=k, N=n, dtype=str(dt).split(".")[-1],
                       model=model,
                       plan=dict(kernel=plan.kernel, tokens=plan.tokens,
                                 channels=plan.channels, splits=plan.splits,
                                 blocks=plan.blocks),
                       max_abs_err=err, equal_bits=True, kernel_ms=kernel_ms,
                       eager_ms=call_ms, plain_ms=plain_ms,
                       library_ms=library_ms,
                       **bound(nbytes, 2.0 * m * n * k,
                               PEAK_BF16 if esz == 2 else PEAK_F32))
            rows.append(row)
            log("q_matmul " + json.dumps(row))
        del qs, deq
    # ragged edges: M, K, N that no tile divides. K that rules out 16-byte
    # rows takes the element-masked kernels (f32 tile, bf16 decode, bf16
    # mma.sync prefill); K a multiple of 16 but not of a chunk, N not of a
    # channel tile and M not of a token tile take the split decode and the
    # wgmma prefill kernels, whose TMA boxes and cp.async pieces zero-fill
    for m, k, n in ((40, 200, 300), (50, 77, 130), (3, 77, 130),
                    (12, 200, 300), (40, 208, 300), (3, 208, 130),
                    (12, 1040, 300), (300, 1040, 1000), (17, 64, 64),
                    (257, 2048, 130)):
        qt = quant.quantize(torch.randn((n, k), generator=gen,
                                        device=DEVICE), axis=1)
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((m, k), generator=gen, device=DEVICE).to(dt)
            got = quant.q_matmul(x, qt).float()
            ref = quant._q_matmul_plain(x, qt.q, qt.scale, dt).float()
            rtol = 1e-2 if dt == torch.bfloat16 else 1e-5
            atol = (1e-3 if dt == torch.bfloat16 else 1e-5) \
                * ref.abs().max().item()
            if not torch.allclose(got, ref, rtol=rtol, atol=atol):
                raise AssertionError(
                    f"q_matmul edge M={m} K={k} N={n} {dt}: max |kernel - "
                    f"plain| = {(got - ref).abs().max().item()}")
        log(f"q_matmul edge M={m} K={k} N={n}: ok "
            f"({quant.plan_q_matmul(m, n, k).kernel} in bf16)")
    return rows, max_err


def check_flash(torch, fa):
    """Phase 4: K2 against its plain version, with times and bounds."""
    import torch.nn.functional as F

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    rows, max_err = [], 0.0
    bf = torch.bfloat16
    cases = [
        # (B, L, H, Hkv, D, dtype, causal, window, key mask; see _key_mask)
        (4, 128, 16, 1, 128, bf, True, None, None),
        (4, 208, 16, 1, 128, bf, True, None, None),
        (1, 80, 16, 1, 128, bf, True, None, None),
        (1, 128, 16, 1, 128, bf, True, None, None),
        (1, 208, 16, 1, 128, bf, True, None, None),
        (1, 336, 16, 1, 128, bf, True, None, None),
        (2, 100, 4, 2, 64, bf, False, 24, "half"),
        (2, 150, 4, 1, 128, bf, True, 40, "half"),
        # the wgmma kernel's edge tiles: L not a multiple of its 128-row
        # tiles, masked keys inside otherwise interior tiles, a window
        # narrower than a warp's 16 rows, GQA 2 and MQA, fully masked rows
        (2, 77, 4, 2, 64, bf, True, None, "holes"),
        (2, 130, 8, 8, 128, bf, False, None, "holes"),
        (2, 333, 4, 1, 128, bf, False, 5, "half"),
        (2, 333, 8, 2, 64, bf, True, None, "half"),
        (1, 512, 4, 4, 128, bf, False, None, "holes"),
        (2, 100, 4, 2, 64, torch.float32, True, 24, "half"),
        # the LM twin's decode prefill: 4 prompts of 8 tokens, D=16 (the
        # small-D kernel)
        (EX_LM_PROMPTS, EX_LM_PROMPT_LEN, EX_LM_HEADS, EX_LM_HEADS,
         EX_LM_DIM // EX_LM_HEADS, bf, True, None, None),
        # the small-D kernel's edges at D = 16 and 32: ragged L, masked
        # keys inside whole tiles, a window narrower than a warp's 16 rows,
        # GQA 2 and MQA, fully masked rows, L past one 128-key tile, and
        # bf16 at D = 24 (the FMA kernel)
        *[(2, 77, 4, 2, d, bf, True, None, "holes") for d in (16, 32)],
        *[(2, 333, 4, 1, d, bf, False, 5, "half") for d in (16, 32)],
        *[(2, 333, 8, 2, d, bf, True, None, "holes") for d in (16, 32)],
        *[(2, 100, 4, 2, d, bf, False, 24, "half") for d in (16, 32)],
        *[(1, 512, 4, 4, d, bf, False, None, "ragged") for d in (16, 32)],
        (2, 100, 4, 2, 24, bf, True, None, "half"),
    ]
    occupancy = {d: fa.small_occupancy(d) for d in (16, 32)}
    log("flash_attention small-D occupancy " + json.dumps(occupancy))
    for B, L, H, Hkv, D, dt, causal, window, mkind in cases:
        q = torch.randn((B, L, H, D), generator=gen, device=DEVICE).to(dt)
        k = torch.randn((B, L, Hkv, D), generator=gen, device=DEVICE).to(dt)
        v = torch.randn((B, L, Hkv, D), generator=gen, device=DEVICE).to(dt)
        km = _key_mask(torch, mkind, B, L, gen)
        masked = km is not None
        kw = dict(scale=D ** -0.5, causal=causal, window=window)
        o, lse = fa._fa_forward(q, k, v, km, **kw)
        ro, rlse = fa._fa_forward_plain(q, k, v, km, **kw)
        torch.cuda.synchronize()
        o_atol = 2e-2 if dt == torch.bfloat16 else 1e-4
        err = (o.float() - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        if not (err <= o_atol and lse_err <= 1e-3
                and torch.isfinite(o.float()).all()):
            raise AssertionError(
                f"flash B={B} L={L} H={H}/{Hkv} D={D} {dt} causal={causal} "
                f"window={window} mask={mkind}: |O - plain| = {err} "
                f"(atol {o_atol}), |lse - plain| = {lse_err} (atol 1e-3)")
        if mkind == "half" and o[1].abs().max().item() != 0.0:
            raise AssertionError("flash: fully masked rows must give 0")
        max_err = max(max_err, err)
        route = fa.flash_route(dt, D, True)
        kernel_ms = cuda_ms(torch, lambda: fa._fa_forward(q, k, v, km, **kw))
        call_ms = eager_ms(torch, lambda: fa._fa_forward(q, k, v, km, **kw))
        plain_ms = cuda_ms(torch, lambda: fa._fa_forward_plain(
            q, k, v, km, **kw), iters=10)
        extra = {}
        if route == "small":   # the FMA kernel it replaces, and its grid
            extra = dict(fma_ms=cuda_ms(torch, lambda: fa._fa_forward_cuda(
                q, k, v, km, route="fma", **kw)), **_small_grid(
                    occupancy[D], B * H * -(-L // 128)))
        library_ms = None
        if window is None and not masked:
            qt = q.transpose(1, 2).contiguous()
            kt = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2) \
                .contiguous()
            vt = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2) \
                .contiguous()
            library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
        pairs = _pairs(torch, fa, B, L, causal, window, km)
        esz = 2 if dt == torch.bfloat16 else 4
        nbytes = (2 * B * L * H * D + 2 * B * L * Hkv * D) * esz \
            + B * H * L * 4
        row = dict(B=B, L=L, H=H, Hkv=Hkv, D=D, dtype=str(dt).split(".")[-1],
                   causal=causal, window=window, key_mask=mkind, route=route,
                   max_abs_err=err, lse_err=lse_err, kernel_ms=kernel_ms,
                   eager_ms=call_ms, plain_ms=plain_ms,
                   library_ms=library_ms, **extra,
                   **bound(nbytes, 4.0 * pairs * H * D,
                           PEAK_BF16 if esz == 2 else PEAK_F32))
        rows.append(row)
        log("flash_attention " + json.dumps(row))
    return rows, max_err


def _small_grid(occ, items):
    """The small-D forward's launch: its persistent grid (one block an
    item, at most the resident blocks) and what bounds it."""
    resident = occ["fwd_blocks_per_sm"] * occ["sms"]
    return dict(grid_blocks=min(items, resident), items=items,
                resident_blocks=resident, **occ)


def _pairs(torch, fa, B, L, causal, window, km):
    """(batch, query, key) pairs this band and key mask leave to compute."""
    qp = torch.arange(L, device=DEVICE)[:, None]
    kp = torch.arange(L, device=DEVICE)[None, :]
    band = fa.band_predicate(qp, kp, causal, fa._canonical_window(window, L))
    valid = torch.ones((B, L, L), dtype=torch.bool, device=DEVICE)
    if band is not None:
        valid &= band[None]
    if km is not None:
        valid &= km.bool()[:, None, :]
    return int(valid.sum().item())


def _key_mask(torch, kind, B, L, gen):
    """None; "ones": every key valid (a mask the model passes all the
    same); "half": row 0 attends a prefix, row 1 nothing (every query
    of row 1 fully masked); "ragged": each row a prefix of its own
    length, L/4 .. L; "holes": every key but one in 37 (offset by the
    row), so masked keys fall inside tiles that are otherwise whole."""
    if kind is None:
        return None
    if kind == "ones":
        return torch.ones((B, L), device=DEVICE)
    km = torch.zeros((B, L), device=DEVICE)
    if kind == "half":
        km[0, : L - L // 3] = 1.0
        return km
    if kind == "holes":
        pos = torch.arange(L, device=DEVICE)[None]
        rows = torch.arange(B, device=DEVICE)[:, None]
        return ((pos + 5 * rows) % 37 != 3).float()
    lengths = torch.randint(L // 4, L + 1, (B,), generator=gen,
                            device=DEVICE)
    return (torch.arange(L, device=DEVICE)[None] < lengths[:, None]).float()


def check_flash_bwd(torch, fa):
    """K2's forward and the backward kernels against their plain versions:
    K3 (dq) and K4 (dk/dv) at the LM's training shape (B'=16 = 2 workers
    x 8, L=2048, H=8, D=128, bf16, causal), the classifier's (D=64,
    non-causal, ragged key mask) and the long-context twin's (B=8, L=4096,
    H=8, D=64 with an all-ones key mask); the fused small-D backward (dq,
    dk and dv in one launch, bf16 at D = 16 and 32) at the LM twin's
    training shape (B'=128, L=128, H=4, D=16, causal: one key tile, dq
    stored directly) and at the zoo's default width at config 9's length
    (B'=16, L=2048, H=4, D=32, causal: dq added into an f32 buffer); and
    small cases (GQA 2 and 1, window with and without causal, a window
    narrower than a warp's rows, ragged L, masked keys inside whole tiles,
    f32, bf16 at D=24 on the FMA kernels, fully masked rows, L past one
    key tile at both small head dims). The forward is held to the
    tolerances of ``check_flash``; the backward kernels and their plain
    version read the same q, k, v, dO and the kernel forward's O and lse.
    Tolerance: the kernels round p and ds to bf16 as operands of their
    second products (as FA2) where the plain version keeps f32, so bf16
    outputs agree to 2^-6 of the plain output's largest magnitude (two
    bf16 ulps); f32 to 1e-4 of it (summation order over up to L terms
    through exp). Fully masked rows must give exact zeros. Kernel, plain
    and library (``scaled_dot_product_attention``'s forward, and its
    backward, which computes dq, dk and dv in one call, at the same shapes
    without the key mask: on the device from CUDA graphs of the forward
    and of forward + backward, their difference, and eagerly with the
    host, ``library_eager_ms``) are timed at the training shapes, and
    beside the small-D kernels the FMA kernels they replace."""
    import torch.nn.functional as F

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    bf, f32 = torch.bfloat16, torch.float32
    Bp = LM_W * LM_BATCH
    cases = [
        # (B, L, H, Hkv, D, dtype, causal, window, key mask, timed)
        (Bp, LM_L, LM_HEADS, LM_HEADS, LM_DIM // LM_HEADS, bf, True, None,
         None, True),
        (Bp, CLS_L, CLS_HEADS, CLS_HEADS, CLS_DIM // CLS_HEADS, bf, False,
         None, "ragged", True),
        # the example twins' training shapes: the LM twin's (B'=128, D=16,
        # causal: the small-D kernels) and the long-context twin's
        # flash+remat leg (L=4096, D=64, all-ones key mask)
        (EX_LM_W * EX_LM_BATCH, EX_LM_L, EX_LM_HEADS, EX_LM_HEADS,
         EX_LM_DIM // EX_LM_HEADS, bf, True, None, None, True),
        (EX_LC_B, EX_LC_L, EX_LC_HEADS, EX_LC_HEADS,
         EX_LC_DIM // EX_LC_HEADS, bf, False, None, "ones", True),
        # the zoo's default width (dim 128, 4 heads: D=32) at config 9's
        # length under causal masking
        (Bp, LM_L, 4, 4, 32, bf, True, None, None, True),
        (2, 100, 4, 2, 64, bf, False, 24, "half", False),
        (2, 150, 4, 1, 128, bf, True, 40, "half", False),
        (2, 77, 4, 4, 128, bf, True, None, None, False),
        (2, 130, 8, 2, 64, bf, False, None, "half", False),
        (2, 333, 4, 1, 128, bf, False, 5, "half", False),
        (2, 333, 8, 2, 64, bf, True, None, "holes", False),
        (1, 512, 4, 4, 128, bf, False, None, "holes", False),
        (2, 100, 4, 2, 64, f32, True, 24, "half", False),
        (2, 77, 4, 1, 128, f32, False, None, None, False),
        (2, 77, 4, 2, 24, bf, True, None, "half", False),
        # the small-D kernels' edges at D = 16 and 32: ragged L, masked
        # keys inside whole tiles, a window narrower than a warp's rows,
        # GQA 2 and MQA, fully masked rows, L past one 128-key tile (dq
        # added into an f32 buffer)
        *[(2, 77, 4, 2, d, bf, True, None, "half", False) for d in (16, 32)],
        *[(2, 77, 4, 2, d, bf, True, None, "holes", False)
          for d in (16, 32)],
        *[(2, 333, 4, 1, d, bf, False, 5, "half", False) for d in (16, 32)],
        *[(2, 333, 8, 2, d, bf, True, None, "holes", False)
          for d in (16, 32)],
        *[(2, 100, 4, 1, d, bf, False, 24, "half", False) for d in (16, 32)],
        *[(2, 300, 8, 8, d, bf, True, 40, "ragged", False)
          for d in (16, 32)],
    ]
    fwd_rows, dq_rows, dkv_rows, small_rows = [], [], [], []
    dq_err = dkv_err = small_err = 0.0
    occupancy = {d: fa.small_occupancy(d) for d in (16, 32)}
    for B, L, H, Hkv, D, dt, causal, window, mkind, timed in cases:
        q = torch.randn((B, L, H, D), generator=gen, device=DEVICE).to(dt)
        k = torch.randn((B, L, Hkv, D), generator=gen, device=DEVICE).to(dt)
        v = torch.randn((B, L, Hkv, D), generator=gen, device=DEVICE).to(dt)
        g = torch.randn((B, L, H, D), generator=gen, device=DEVICE).to(dt)
        km = _key_mask(torch, mkind, B, L, gen)
        kw = dict(scale=D ** -0.5, causal=causal, window=window)
        route = fa.flash_route(dt, D, True)
        out, lse = fa._fa_forward(q, k, v, km, **kw)
        ro, rlse = fa._fa_forward_plain(q, k, v, km, **kw)
        torch.cuda.synchronize()
        label = (f"B={B} L={L} H={H}/{Hkv} D={D} {str(dt).split('.')[-1]} "
                 f"causal={causal} window={window} mask={mkind} "
                 f"route={route}")
        o_atol = 2e-2 if dt == bf else 1e-4
        errs = {"o": _err(out, ro), "lse": _err(lse, rlse)}
        if not (errs["o"] <= o_atol and errs["lse"] <= 1e-3
                and torch.isfinite(out.float()).all()):
            raise AssertionError(
                f"flash forward {label}: |O - plain| = {errs['o']} (atol "
                f"{o_atol}), |lse - plain| = {errs['lse']} (atol 1e-3)")
        if mkind == "half" and out[1].abs().max().item() != 0.0:
            raise AssertionError(f"flash forward {label}: fully masked rows "
                                 f"must give 0")
        del ro, rlse
        delta = fa._delta(out, g)
        args = (q, k, v, km, lse, delta, g)
        if route == "small":
            dq, dk, dv = fa._fa_bwd_small(*args, **kw)
        else:
            dq = fa._fa_bwd_dq(*args, **kw)
            dk, dv = fa._fa_bwd_dkv(*args, **kw)
        rq, rk, rv = fa._fa_bwd_plain(*args, **kw)
        torch.cuda.synchronize()
        rel = 2.0 ** -6 if dt == bf else 1e-4
        for name, got, ref in (("dq", dq, rq), ("dk", dk, rk),
                               ("dv", dv, rv)):
            errs[name] = _err(got, ref)
            scale = ref.float().abs().max().item()
            if not (errs[name] <= rel * scale
                    and torch.isfinite(got.float()).all()):
                raise AssertionError(
                    f"flash backward {label} {name}: max |kernel - plain| = "
                    f"{errs[name]} beyond {rel} x {scale}")
        if mkind == "half" and not all(
                t[1].abs().max().item() == 0.0 for t in (dq, dk, dv)):
            raise AssertionError(f"flash backward {label}: fully masked "
                                 f"rows must give zero gradients")
        log(f"flash backward {label}: ok " + json.dumps(errs))
        if route == "small":
            small_err = max(small_err, errs["dq"], errs["dk"], errs["dv"])
        else:
            dq_err = max(dq_err, errs["dq"])
            dkv_err = max(dkv_err, errs["dk"], errs["dv"])
        del rq, rk, rv
        if not timed:
            continue
        pairs = _pairs(torch, fa, B, L, causal, window, km)
        esz = 2 if dt == bf else 4
        peak = PEAK_BF16 if esz == 2 else PEAK_F32
        qb, kvb = B * L * H * D * esz, B * L * Hkv * D * esz
        rowb = 2 * B * H * L * 4 + (0 if km is None else B * L * 4)
        shape = dict(B=B, L=L, H=H, Hkv=Hkv, D=D,
                     dtype=str(dt).split(".")[-1], causal=causal,
                     window=window, key_mask=mkind, route=route)
        lib_fwd, lib_bwd, lib_bwd_eager = _sdpa_ms(torch, F, q, k, v, g,
                                                   causal)
        small = route == "small"
        fma = {}
        if small:   # the FMA kernels the small-D kernels replace
            fma = dict(fma_ms=cuda_ms(torch, lambda: fa._fa_forward_cuda(
                q, k, v, km, route="fma", **kw), iters=5),
                **_small_grid(occupancy[D], B * H * -(-L // 128)))
        fwd_rows.append(dict(
            **shape, max_abs_err=errs["o"], lse_err=errs["lse"],
            kernel_ms=cuda_ms(torch, lambda: fa._fa_forward(
                q, k, v, km, **kw), iters=5),
            eager_ms=eager_ms(torch, lambda: fa._fa_forward(
                q, k, v, km, **kw), iters=5),
            plain_ms=cuda_ms(torch, lambda: fa._fa_forward_plain(
                q, k, v, km, **kw), iters=1, replays=2),
            library_ms=lib_fwd, **fma,
            **bound(2 * qb + 2 * kvb + B * H * L * 4, 4.0 * pairs * H * D,
                    peak)))
        log("flash_attention training shape " + json.dumps(fwd_rows[-1]))
        plain = dict(plain_ms=cuda_ms(torch, lambda: fa._fa_bwd_plain(
            *args, **kw), iters=1, replays=2))
        if small:
            dq_fma = cuda_ms(torch, lambda: fa._fa_bwd_dq(*args, **kw),
                             iters=5)
            dkv_fma = cuda_ms(torch, lambda: fa._fa_bwd_dkv(*args, **kw),
                              iters=5)
            small_rows.append(dict(
                **shape, max_abs_err=max(errs["dq"], errs["dk"], errs["dv"]),
                kernel_ms=cuda_ms(torch, lambda: fa._fa_bwd_small(
                    *args, **kw), iters=5),
                eager_ms=eager_ms(torch, lambda: fa._fa_bwd_small(
                    *args, **kw), iters=5),
                **plain, fma_dq_ms=dq_fma, fma_dkv_ms=dkv_fma,
                fma_ms=dq_fma + dkv_fma, library_ms=lib_bwd,
                library_eager_ms=lib_bwd_eager,
                blocks=B * Hkv * -(-L // 128), **occupancy[D],
                **bound(3 * qb + 4 * kvb + rowb, 10.0 * pairs * H * D,
                        peak)))
            log("flash_attention_bwd_small " + json.dumps(small_rows[-1]))
            continue
        dq_rows.append(dict(
            **shape, max_abs_err=errs["dq"],
            kernel_ms=cuda_ms(torch, lambda: fa._fa_bwd_dq(*args, **kw),
                              iters=5),
            eager_ms=eager_ms(torch, lambda: fa._fa_bwd_dq(*args, **kw),
                              iters=5),
            plain_ms=cuda_ms(torch, lambda: fa._fa_bwd_plain(
                *args, **kw, parts=("dq",)), iters=1, replays=2),
            library_ms=lib_bwd, library_eager_ms=lib_bwd_eager,
            **bound(3 * qb + 2 * kvb + rowb, 6.0 * pairs * H * D, peak)))
        log("flash_attention_bwd_dq " + json.dumps(dq_rows[-1]))
        dkv_rows.append(dict(
            **shape, max_abs_err=max(errs["dk"], errs["dv"]),
            kernel_ms=cuda_ms(torch, lambda: fa._fa_bwd_dkv(*args, **kw),
                              iters=5),
            eager_ms=eager_ms(torch, lambda: fa._fa_bwd_dkv(*args, **kw),
                              iters=5),
            plain_ms=cuda_ms(torch, lambda: fa._fa_bwd_plain(
                *args, **kw, parts=("dkv",)), iters=1, replays=2),
            library_ms=lib_bwd, library_eager_ms=lib_bwd_eager,
            **bound(2 * qb + 4 * kvb + rowb, 8.0 * pairs * H * D, peak)))
        log("flash_attention_bwd_dkv " + json.dumps(dkv_rows[-1]))
    torch.cuda.empty_cache()
    return (fwd_rows, dq_rows, dkv_rows, small_rows, dq_err, dkv_err,
            small_err)


def _sdpa_ms(torch, F, q, k, v, g, causal):
    """SDPA (flash backend) at these shapes, without the key mask: its
    forward on the device (a CUDA graph), its backward on the device (a
    graph of forward + backward less the forward's) and its backward
    issued eagerly, host included."""
    rep = q.shape[2] // k.shape[2]
    qt, kt, vt = (t.repeat_interleave(r, dim=2).transpose(1, 2).contiguous()
                  .requires_grad_() for t, r in ((q, 1), (k, rep), (v, rep)))
    gt = g.transpose(1, 2).contiguous()
    with torch.enable_grad():
        lo = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        eager = eager_ms(torch, lambda: torch.autograd.grad(
            lo, (qt, kt, vt), gt, retain_graph=True), iters=10)
    del lo
    fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt.detach(), kt.detach(), vt.detach(), is_causal=causal))

    def fwd_bwd():
        with torch.enable_grad():
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            return torch.autograd.grad(o, (qt, kt, vt), gt)

    both = cuda_ms(torch, fwd_bwd, iters=5)
    torch.cuda.empty_cache()
    return fwd, both - fwd, eager


# the kernels redesigned on wgmma: kernels-line entry → (library, function)
WGMMA_KERNELS = {
    "flash_attention": ("flash_attention", "fa_fwd_wgmma_kernel"),
    "flash_attention_bwd_dq": ("flash_attention_bwd",
                               "fa_bwd_dq_wgmma_kernel"),
    "flash_attention_bwd_dkv": ("flash_attention_bwd",
                                "fa_bwd_dkv_wgmma_kernel"),
}


# the small-D flash kernels (bf16, D = 16 and 32): the same check at both
# head dims
SMALL_KERNELS = {
    "flash_attention_small": ("flash_attention", "fa_fwd_small_kernel"),
    "flash_attention_bwd_small": ("flash_attention_bwd",
                                  "fa_bwd_small_kernel"),
}


# the same check for the other wgmma kernels, each of its instantiations
WGMMA_KERNELS_ONE = {
    "lstm_backward": ("lstm", "lstm_dwh_wgmma_kernel"),
    "q_matmul_prefill": ("quant", "qmm_prefill_wgmma_kernel"),
}

# kernels on the main paths held to no spills (registers reported), every
# instantiation: K6's cluster scan, K7's two scans (lstm.cu is one
# translation unit, and register allocation there is fragile), K1's split
# decode kernel
NO_SPILL_KERNELS = {
    "lstm_forward": ("lstm", "lstm_fwd_cluster_kernel"),
    "lstm_backward_scan": ("lstm", "lstm_bwd_kernel"),
    "lstm_backward_direct_scan": ("lstm", "lstm_bwd_direct_kernel"),
    "q_matmul": ("quant", "qmm_decode_split_kernel"),
}


def _template_tag(name, fn):
    """``<256,2>`` for a mangled ``fn<256, 2>``; "" if not a template."""
    rest = name[name.index(fn) + len(fn):]
    if not rest.startswith("I"):
        return ""
    inner, args = rest[1:], []
    while inner and not inner.startswith("E"):
        if inner.startswith("13__nv_bfloat16"):
            args.append("bf16")
            inner = inner[len("13__nv_bfloat16"):]
        elif inner.startswith("f"):
            args.append("f32")
            inner = inner[1:]
        elif inner[:2] in ("Li", "Lb"):
            end = inner.index("E")
            val = inner[2:end]
            args.append(val if inner[1] == "i" else ("true" if val == "1"
                                                     else "false"))
            inner = inner[end + 1:]
        else:
            break
    return "<" + ",".join(args) + ">"


def _kernel_rows(lib, fn, report, sass, need_wgmma):
    """Every instantiation of ``fn`` in ``lib``'s build: registers, spills
    and (for a wgmma kernel) its HGMMA / UTMALDG counts, held to no spills
    and, for a wgmma kernel, HGMMA > 0 and UTMALDG > 0."""
    names = [k for k in report if fn in k and
             (k[k.index(fn) + len(fn):][:1] in ("I", "E", "v"))]
    if not names:
        raise AssertionError(f"{fn} not found in the build of {lib}: "
                             f"{list(report)}")
    rows = {}
    for name in names:
        ops = sass.get(name, {})
        row = dict(report[name])
        if need_wgmma:
            row.update(hgmma=ops.get("HGMMA", 0), utmaldg=ops.get("UTMALDG", 0))
        bad = (row.get("spill_stores", 0) or row.get("spill_loads", 0)
               or (need_wgmma and not (row["hgmma"] > 0
                                       and row["utmaldg"] > 0)))
        if bad:
            raise AssertionError(f"{fn} ({name}): {row}")
        rows[_template_tag(name, fn)] = row
    return rows[""] if list(rows) == [""] else rows


def _sass_row(lib, fn, tag, report, sass):
    regs = [v for k, v in report.items() if tag in k]
    ops = [v for k, v in sass.items() if tag in k]
    if len(regs) != 1 or len(ops) != 1:
        raise AssertionError(f"{tag} not found once in the build of {lib}: "
                             f"{list(report)}")
    row = dict(**regs[0], hgmma=ops[0]["HGMMA"], utmaldg=ops[0]["UTMALDG"])
    if not (row["hgmma"] > 0 and row["utmaldg"] > 0
            and row.get("spill_stores", 0) == 0
            and row.get("spill_loads", 0) == 0):
        raise AssertionError(f"{fn} ({tag}): {row}")
    return row


def check_sass(_build):
    """Each kernel redesigned on wgmma (the flash kernels at both head
    dims, the small-D flash kernels at D = 16 and 32, the LSTM's dwh
    product, K1's prefill kernel at every token tile and warpgroup count)
    issues ``HGMMA`` and ``UTMALDG`` (TMA) instructions in its SASS
    (``cuobjdump -sass`` of the built library), spills nothing (``ptxas
    -v``), and ``setmaxnreg`` was not ignored; the scans and K1's decode
    kernel (``NO_SPILL_KERNELS``) spill nothing. Registers are the launch
    count; the flash kernels' consumer warpgroups raise theirs with
    ``setmaxnreg`` (the small-D kernels have no producer warpgroup and
    run at most 128)."""
    out = {}
    kernels = [(entry, lib, fn, {f"D={d}": f"{fn}ILi{d}E" for d in dims})
               for table, dims in ((WGMMA_KERNELS, (64, 128)),
                                   (SMALL_KERNELS, (16, 32)))
               for entry, (lib, fn) in table.items()]
    for entry, lib, fn, tags in kernels:
        text = _build.build_log(lib)
        if "setmaxnreg ignored" in text:
            raise AssertionError(f"{lib}: ptxas ignored setmaxnreg:\n{text}")
        report = _build.ptxas_report(text)
        sass = _build.sass_counts(lib)
        for key, tag in tags.items():
            out.setdefault(entry, {})[key] = _sass_row(lib, fn, tag, report,
                                                       sass)
        log(f"sass {entry} ({fn}): {json.dumps(out[entry])}")
    for table, need_wgmma in ((WGMMA_KERNELS_ONE, True),
                              (NO_SPILL_KERNELS, False)):
        for entry, (lib, fn) in table.items():
            text = _build.build_log(lib)
            if "setmaxnreg ignored" in text:
                raise AssertionError(f"{lib}: ptxas ignored setmaxnreg")
            rows = _kernel_rows(lib, fn, _build.ptxas_report(text),
                                _build.sass_counts(lib) if need_wgmma else {},
                                need_wgmma)
            out[entry] = rows
            log(f"sass {entry} ({fn}): {json.dumps(rows)}")
    return out


def check_ce_rows(torch, fce):
    """The fused cross-entropy's row kernels (``csrc/fused_ce.cu``) against
    their plain versions in ``ops/fused_ce.py``, on the same f32 logits:
    config 9's head chunk (W=2 groups of LM_CHUNK rows, V=16384) with and
    without the bias and bf16 dlogits, a ragged vocabulary (16383: the
    one-element path) and an f32 run with a ragged row count. The backward
    takes the plain forward's lse, so its dlogits repeat the plain ones
    operation by operation (expf, products and sums rounded one by one):
    within one ulp of the output type at the largest magnitude (measured:
    ``dl_equal``). lse and nll are online sums in another order: within
    4e-6 of the largest |lse|. db sums in another order: within 1e-5 of
    the largest column sum of |dlogits|, and bit-equal between two
    launches (the partials are added in a fixed order, no atomics on
    sums). Launch counters count every launch. Times at config 9's chunk
    with the bias: kernel, plain and ``F.cross_entropy`` (the library
    yardstick the port never calls: forward, and forward + backward less
    forward) over the same f32 logits, beside the bytes bound."""
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    bf, f32 = torch.bfloat16, torch.float32
    V = LM_VOCAB
    cases = (("lm9 bf16 bias", LM_W, LM_CHUNK, V, bf, True),
             ("lm9 bf16", LM_W, LM_CHUNK, V, bf, False),
             ("ragged V bf16 bias", LM_W, LM_CHUNK, V - 1, bf, True),
             ("f32 ragged rows bias", 1, 300, V, f32, True))
    rows, timed = [], None
    for label, G, c, v, dt, with_bias in cases:
        x = torch.randn((G, c, v), generator=gen, device=DEVICE) * 4.0
        b = (torch.randn((G, v), generator=gen, device=DEVICE)
             if with_bias else None)
        y = torch.randint(0, v, (G, c), generator=gen, device=DEVICE)
        m = torch.rand((G, c), generator=gen, device=DEVICE) * 2.0
        sc = torch.rand((G,), generator=gen, device=DEVICE) + 0.5
        lse = torch.empty((G, c), device=DEVICE)
        nll = torch.empty_like(lse)
        fce.ce_fwd_rows.launches = fce.ce_bwd_rows.launches = 0
        fce.ce_fwd_rows(x, b, y, lse, nll)
        p_lse, p_nll = fce._rows_fwd_plain(x, b, y)
        tickets = fce.bwd_tickets(G, v, x.device)
        outs = []
        for _ in range(2):
            dl = torch.empty((G, c, v), dtype=dt, device=DEVICE)
            db = torch.zeros((G, v), device=DEVICE)
            fce.ce_bwd_rows(x, b, y, p_lse, m, sc, dl, db, tickets)
            outs.append((dl, db))
        p_dl, p_db = fce._rows_bwd_plain(x, b, y, p_lse, m, sc, dt)
        torch.cuda.synchronize()
        (dl, db), (dl2, db2) = outs
        tol_l = 4e-6 * p_lse.abs().max().item()
        ulp = 2.0 ** -8 if dt == bf else 2.0 ** -23
        tol_d = ulp * p_dl.float().abs().max().item()
        col = (p_dl.float().abs().sum(1).max().item())
        row = dict(case=label, G=G, rows=c, V=v, dtype=str(dt),
                   lse_err=_err(lse, p_lse), nll_err=_err(nll, p_nll),
                   dl_err=_err(dl, p_dl),
                   dl_equal=bool(torch.equal(dl, p_dl)),
                   db_err=_err(db, p_db),
                   db_repeat_equal=bool(torch.equal(db, db2)
                                        and torch.equal(dl, dl2)),
                   fwd_launches=fce.ce_fwd_rows.launches,
                   bwd_launches=fce.ce_bwd_rows.launches,
                   splits=fce.bwd_splits(
                       G, v, c, torch.cuda.get_device_properties(0)
                       .multi_processor_count, 128))
        if not (row["lse_err"] <= tol_l and row["nll_err"] <= tol_l
                and row["dl_err"] <= tol_d and row["db_err"] <= 1e-5 * col
                and row["db_repeat_equal"] and row["fwd_launches"] == 1
                and row["bwd_launches"] == 2):
            raise AssertionError(f"fused CE rows {label}: {json.dumps(row)} "
                                 f"(tolerances lse/nll {tol_l}, dl {tol_d}, "
                                 f"db {1e-5 * col})")
        rows.append(row)
        log("fused_ce rows " + json.dumps(row))
        if timed is None:
            timed = (x, b, y, lse, nll, m, sc, dl, db, tickets)
    x, b, y, lse, nll, m, sc, dl, db, tickets = timed
    G, c, v = x.shape
    fwd_ms = cuda_ms(torch, lambda: fce.ce_fwd_rows(x, b, y, lse, nll))
    bwd_ms = cuda_ms(torch, lambda: fce.ce_bwd_rows(
        x, b, y, lse, m, sc, dl, db, tickets))
    fwd_plain_ms = cuda_ms(torch, lambda: fce._rows_fwd_plain(x, b, y),
                           iters=5)
    bwd_plain_ms = cuda_ms(torch, lambda: fce._rows_bwd_plain(
        x, b, y, lse, m, sc, bf), iters=5)
    xl = (x + b[:, None, :]).reshape(G * c, v).requires_grad_()
    yl = y.reshape(G * c)
    f = torch.nn.functional.cross_entropy
    lib_fwd_ms = cuda_ms(torch, lambda: f(xl.detach(), yl), iters=5)
    lib_fb_ms = cuda_ms(torch, lambda: torch.autograd.grad(f(xl, yl), xl),
                        iters=5)
    n = G * c * v
    out = dict(shape=[G, c, v], fwd_ms=fwd_ms, bwd_ms=bwd_ms,
               fwd_eager_ms=eager_ms(torch, lambda: fce.ce_fwd_rows(
                   x, b, y, lse, nll)),
               bwd_eager_ms=eager_ms(torch, lambda: fce.ce_bwd_rows(
                   x, b, y, lse, m, sc, dl, db, tickets)),
               fwd_plain_ms=fwd_plain_ms, bwd_plain_ms=bwd_plain_ms,
               library_fwd_ms=lib_fwd_ms,
               library_bwd_ms=lib_fb_ms - lib_fwd_ms,
               fwd_bound=bound(4.0 * n, 0.0, PEAK_F32),
               bwd_bound=bound(6.0 * n, 0.0, PEAK_F32))
    log("fused_ce rows timed " + json.dumps(out))
    del xl, timed
    return rows, out


def check_fused_ce(torch):
    """The fused cross-entropy (``ops/fused_ce.py``) on the card: first its
    row kernels against their plain versions (``check_ce_rows``), then in
    bf16 at the LM's head (D=1024, V=16384, chunk 512, bias), 2 workers of
    1024 rows. Each worker's loss equals the plain f32-logit reference (the
    same bf16 operands multiplied in f32) to 1e-5 relative, as the JAX op
    keeps its logits f32 (summation order only; bf16 logits would move it
    ~1e-4). ``vmap(grad)`` over the workers raises no vmap-fallback warning
    (a per-worker loop), launches each row kernel once a chunk for both
    workers, and matches a loop over workers: the loss to 1e-5 relative,
    dh and dkernel to 2^-7 of their largest magnitude (one bf16 ulp there:
    batched and single products may sum in another order, and a last-bit
    f32 difference can flip a bf16 rounding), dbias (f32 sums in another
    order: one worker's launch splits its rows otherwise) to 1e-5 of its
    largest magnitude."""
    import warnings

    from distkeras_tpu_torch.ops import fused_ce as fce

    rows, timed = check_ce_rows(torch, fce)
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    W, N, D, V = 2, 1024, LM_DIM, LM_VOCAB
    bf = torch.bfloat16
    hs = torch.randn((W, N, D), generator=gen, device=DEVICE).to(bf)
    ks = (torch.randn((W, D, V), generator=gen, device=DEVICE)
          * D ** -0.5).to(bf)
    bs = torch.randn((W, V), generator=gen, device=DEVICE)
    ys = torch.randint(0, V, (W, N), generator=gen, device=DEVICE)

    def loss(h, k, b, y):
        return fce.chunked_softmax_cross_entropy(h, y, k, b, chunk=LM_CHUNK)

    grad = torch.func.grad_and_value(loss, argnums=(0, 1, 2))
    fce.ce_fwd_rows.launches = fce.ce_bwd_rows.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (dh, dk, db), vals = torch.func.vmap(grad)(hs, ks, bs, ys)
        torch.cuda.synchronize()
    fallback = [str(w.message) for w in caught if "batching rule"
                in str(w.message)]
    if fallback:
        raise AssertionError(f"fused CE under vmap(grad) fell back to a "
                             f"per-worker loop: {fallback[:2]}")
    launches = (fce.ce_fwd_rows.launches, fce.ce_bwd_rows.launches)
    if launches != (N // LM_CHUNK, N // LM_CHUNK):
        raise AssertionError(f"fused CE under vmap(grad): row kernel "
                             f"launches {launches}, expected one a chunk "
                             f"({N // LM_CHUNK}) a pass")
    errs = dict(loss=0.0, dh=0.0, dk=0.0, db=0.0)
    for w in range(W):
        ref = torch.nn.functional.cross_entropy(
            hs[w].float() @ ks[w].float() + bs[w], ys[w])
        (rh, rk, rb), rv = grad(hs[w], ks[w], bs[w], ys[w])
        for name, got, want, tol in (
                ("loss", vals[w], ref, 1e-5 * ref.abs().item()),
                ("loss", vals[w], rv, 1e-5 * rv.abs().item()),
                ("dh", dh[w], rh, 2.0 ** -7 * rh.float().abs().max().item()),
                ("dk", dk[w], rk, 2.0 ** -7 * rk.float().abs().max().item()),
                ("db", db[w], rb, 1e-5 * rb.abs().max().item())):
            e = _err(got, want)
            errs[name] = max(errs[name], e)
            if not e <= tol:
                raise AssertionError(f"fused CE worker {w} {name}: |got - "
                                     f"want| = {e} beyond {tol}")
    log("fused_ce bf16 vmap(grad) W=2: ok " + json.dumps(errs))
    return rows, timed


def check_flash_vmap(torch, fa):
    """The flash Function under ``torch.func.vmap(grad)`` at W=2: the
    gradients through K2–K4 equal those through the plain versions
    (tolerance as in ``check_flash_bwd``), and each kernel launched once
    for the step, not once per worker."""
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    W, B, L, H, Hkv, D = 2, 2, 130, 4, 2, 64
    bf = torch.bfloat16
    qs = torch.randn((W, B, L, H, D), generator=gen, device=DEVICE).to(bf)
    ks = torch.randn((W, B, L, Hkv, D), generator=gen, device=DEVICE).to(bf)
    vs = torch.randn((W, B, L, Hkv, D), generator=gen, device=DEVICE).to(bf)
    masks = torch.ones((W, B, L), device=DEVICE)
    masks[:, 1, 100:] = 0.0
    probe = torch.randn((B, L, H, D), generator=gen, device=DEVICE)

    def counts():
        return (fa._fa_forward.launches, fa._fa_bwd_dq.launches,
                fa._fa_bwd_dkv.launches)

    grads, launched = {}, {}
    for impl in ("kernel", "plain"):
        def loss(q, k, v, m, impl=impl):
            o = fa.flash_attention(q, k, v, causal=True, key_mask=m,
                                   impl=impl)
            return torch.sum(o.float() * probe)

        before = counts()
        grads[impl] = torch.func.vmap(torch.func.grad(
            loss, argnums=(0, 1, 2)))(qs, ks, vs, masks)
        torch.cuda.synchronize()
        launched[impl] = [a - b for a, b in zip(counts(), before)]
    if launched != {"kernel": [1, 1, 1], "plain": [0, 0, 0]}:
        raise AssertionError(f"flash vmap(grad): launches {launched}, "
                             f"expected one of K2, K3, K4 for the step")
    errs = {}
    for name, got, ref in zip(("dq", "dk", "dv"), grads["kernel"],
                              grads["plain"]):
        errs[name] = _err(got, ref)
        scale = ref.float().abs().max().item()
        if not errs[name] <= 2.0 ** -6 * scale:
            raise AssertionError(f"flash vmap(grad) {name}: max |kernel - "
                                 f"plain| = {errs[name]} beyond 2^-6 x "
                                 f"{scale}")
    log("flash vmap(grad) W=2: ok " + json.dumps(dict(
        errs, launches=launched["kernel"])))


def lm_spec(torch, depth, attn_impl, remat=False):
    from distkeras_tpu_torch.models import transformer_lm_spec

    return transformer_lm_spec(
        vocab=LM_VOCAB, maxlen=LM_L, dim=LM_DIM, heads=LM_HEADS, depth=depth,
        dtype=torch.bfloat16, attn_impl=attn_impl, pos_embedding="rope",
        fused_ce=True, ce_chunk=LM_CHUNK, remat=remat)


def lm_tokens(n, seed=0):
    """A learnable stream: each row counts up by one mod V from a random
    start (uniform tokens, as bench.py's, cannot show a falling loss)."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, LM_VOCAB, (n, 1))
    return ((start + np.arange(LM_L + 1)[None]) % LM_VOCAB).astype(np.int32)


def compare_lm_window(torch):
    """One ADAG window of the config-9 LM at full width and depth
    LM_CMP_DEPTH through K2–K5 and, from the same init on the same
    superbatch, through their plain versions on the card. Bound as in
    ``compare_window``: Adam moves an element by at most ~1.01 lr a step
    whatever its gradient's size, a noise-level gradient may take either
    sign, and ADAG's center is the mean of the W workers, so centers agree
    to 2.02 lr · window; the mean loss to 1e-2."""
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.pallas_kernels import fused_adam
    from distkeras_tpu_torch.parallel import ADAGMerge, LocalSGDEngine
    from distkeras_tpu_torch.trainers import _make_loss_step

    toks = lm_tokens(LM_W * LM_WINDOW * LM_BATCH, seed=1).reshape(
        LM_W, LM_WINDOW, LM_BATCH, LM_L + 1)
    batch = (toks[..., :-1], toks[..., 1:])
    out = {}
    for impl, attn in (("kernel", "flash"), ("plain", "plain")):
        spec = lm_spec(torch, LM_CMP_DEPTH, attn)
        engine = LocalSGDEngine(
            spec, _make_loss_step(spec, get_loss(LOSS), 1, LOSS),
            fused_adam(LM_LR, impl=impl), ADAGMerge(), device=DEVICE,
            num_workers=LM_W, window=LM_WINDOW, batch_size=LM_BATCH)
        params, nt = spec.init(0)
        state, loss = engine.run_window(engine.init_state(params, nt), batch)
        out[impl] = (engine.center_params(state), loss.item())
        del engine, state
        torch.cuda.empty_cache()
    (ck, lk), (cp, lp) = out["kernel"], out["plain"]
    diff = max(_err(ck[k], cp[k]) for k in ck)
    mean = max((ck[k] - cp[k]).abs().mean().item() for k in ck)
    limit = 2.02 * LM_LR * LM_WINDOW
    if not (diff <= limit and abs(lk - lp) <= 1e-2
            and all(torch.isfinite(v).all() for v in ck.values())):
        raise AssertionError(
            f"ADAG LM window kernel vs plain: max |center diff| {diff} "
            f"(limit {limit}), loss {lk} vs {lp}")
    log("LM window kernels vs plain: " + json.dumps(dict(
        depth=LM_CMP_DEPTH, max_center_diff=diff, max_mean_center_diff=mean,
        limit=limit, loss_kernel=lk, loss_plain=lp)))


def train_lm(torch):
    """The slice's main path: config 9 at full width and depth under
    ADAG with fused Adam, the flash kernels and the fused cross-entropy,
    two epochs of LM_WINDOWS windows, random init from seed 0. Returns
    the phase's record; the caller reads the launch counters around it."""
    import warnings

    from distkeras_tpu_torch.data import next_token_dataset
    from distkeras_tpu_torch.trainers import ADAG

    spec = lm_spec(torch, LM_DEPTH, "flash")
    t = ADAG(spec, loss=LOSS, worker_optimizer="fused_adam",
             learning_rate=LM_LR, num_workers=LM_W, batch_size=LM_BATCH,
             communication_window=LM_WINDOW, num_epoch=2, log_metrics=True,
             device=DEVICE)
    ds = next_token_dataset(lm_tokens(
        LM_W * LM_WINDOW * LM_BATCH * LM_WINDOWS))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t.train(ds)
    wall = time.perf_counter() - t0
    fallback = [str(w.message) for w in caught
                if "batching rule" in str(w.message)]
    if fallback:
        raise AssertionError(f"ADAG LM: vmap fell back to a per-worker "
                             f"loop: {fallback[:2]}")
    losses = t.history.losses()
    if len(losses) != 2 * LM_WINDOWS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"ADAG LM: bad loss history {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"ADAG LM: the loss did not fall: {losses}")
    tokens = LM_W * LM_WINDOW * LM_BATCH * LM_L
    rec = dict(
        wall_s=wall, windows=len(losses), tokens_per_window=tokens,
        losses=losses, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        params=sum(v.numel() for v in t.trained_params_.values()),
        epochs=[dict(epoch=m["epoch"],
                     tokens_per_s=m["samples_per_sec"] * LM_L,
                     window_ms=1e3 * m["wall_time"] / LM_WINDOWS)
                for m in t.metrics_ if "samples_per_sec" in m])
    log("train ADAG lm config 9: " + json.dumps(rec))
    return rec


def classifier_data(n, seed=0):
    """Rows of ragged length (L/4 .. L, zero-padded, so the key mask is
    real) labelled by whether most of their tokens lie in the lower half
    of the vocabulary."""
    from distkeras_tpu_torch.data import Dataset

    rng = np.random.default_rng(seed)
    lengths = rng.integers(CLS_L // 4, CLS_L + 1, n)
    mask = (np.arange(CLS_L)[None] < lengths[:, None]).astype(np.float32)
    toks = rng.integers(1, CLS_VOCAB, (n, CLS_L)) * mask.astype(np.int64)
    low = np.sum((toks < CLS_VOCAB // 2) * mask, axis=1)
    label = (2 * low > lengths).astype(np.int32)
    return Dataset({"features": toks.astype(np.int32), "mask": mask,
                    "label": label})


def train_classifier(torch):
    """Config 6's encoder classifier at full width (vocab 8192, L 2048,
    dim 512, 8 heads, depth 8, bf16 compute, f32 params) through the flash
    kernels (non-causal, key mask, D=64) under DOWNPOUR with SGD, for
    CLS_WINDOWS windows on ragged rows."""
    from distkeras_tpu_torch.models import transformer_classifier
    from distkeras_tpu_torch.trainers import DOWNPOUR

    spec = transformer_classifier(
        vocab=CLS_VOCAB, maxlen=CLS_L, dim=CLS_DIM, heads=CLS_HEADS,
        depth=CLS_DEPTH, dtype=torch.bfloat16, attn_impl="flash")
    t = DOWNPOUR(spec, loss=LOSS, worker_optimizer="sgd",
                 learning_rate=CLS_LR, features_col=["features", "mask"],
                 num_workers=CLS_W, batch_size=CLS_BATCH,
                 communication_window=CLS_WINDOW, num_epoch=1,
                 log_metrics=True, device=DEVICE)
    t0 = time.perf_counter()
    t.train(classifier_data(CLS_W * CLS_WINDOW * CLS_BATCH * CLS_WINDOWS))
    wall = time.perf_counter() - t0
    losses = t.history.losses()
    if len(losses) != CLS_WINDOWS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"DOWNPOUR classifier: bad losses {losses}")
    m = t.metrics_[-1]
    log("train DOWNPOUR classifier config 6: " + json.dumps(dict(
        wall_s=wall, windows=len(losses), loss_first=losses[0],
        loss_last=losses[-1], samples_per_sec=m["samples_per_sec"],
        window_ms=1e3 * m["wall_time"] / CLS_WINDOWS)))
    return t


def serve(torch, model, label, draft=None, tower=None, trace_dir=None):
    """Phases 5/6: the served path — server, 4 concurrent clients; with
    ``draft`` the engine serves speculatively at K=SPEC_K. With ``tower``
    (an observability ``Watchtower``) the server carries it and it
    samples the engine while the clients run; its last scrape lands when
    they are done, and the server's ``metrics`` action's reply is in the
    stats under ``metrics_reply``. With ``trace_dir`` the server's flight
    recorder writes its timeline there at stop, and its ``trace_path_`` is
    in the stats under ``trace_path``. Returns ``(prompts, streams, wall
    seconds, the engine's stats)``."""
    from distkeras_tpu_torch.serving import (
        GenerationClient,
        GenerationEngine,
        GenerationServer,
    )

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, (lp,)).astype(np.int32)
               for lp in PROMPTS]
    spec = {} if draft is None else dict(draft=draft, spec_tokens=SPEC_K)
    engine = GenerationEngine(model, max_batch=8, block_size=BLOCK,
                              device=DEVICE, **spec)
    server = GenerationServer(engine, poll_interval=0.01,
                              trace_dir=trace_dir)
    server.start()
    watching = tower is not None
    if watching:
        tower.add_serving(engine)
        server.watchtower = tower
        tower.start()
    results, errors = {}, []

    def client(i):
        try:
            c = GenerationClient("127.0.0.1", server.port)
            try:
                results[i] = c.generate(prompts[i],
                                        max_new_tokens=NEW_TOKENS)
            finally:
                c.close()
        except Exception as e:  # re-raised below, after the server stops
            errors.append((i, repr(e)))

    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        stats = server.stats()
        if watching:
            tower.stop()    # its last scrape, with every request retired
            watching = False
            stats["metrics_reply"] = _metrics_action(server.port)
    finally:
        if watching:
            tower.stop()
        server.stop()
    if trace_dir is not None:
        stats["trace_path"] = server.trace_path_
    if errors or len(results) != len(prompts):
        raise AssertionError(f"{label}: clients failed: {errors}")
    for i, toks in results.items():
        if toks.shape != (NEW_TOKENS,) or toks.min() < 0 \
                or toks.max() >= VOCAB:
            raise AssertionError(f"{label}: bad stream {i}: {toks}")
    if stats["completed"] != len(prompts) or stats["blocks_in_use"] != 0:
        raise AssertionError(f"{label}: engine stats {stats}")
    n_tok = NEW_TOKENS * len(prompts)
    log(f"serve {label}: " + json.dumps(dict(
        wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall,
        steps=stats["steps"], prefills=stats["prefills"],
        mean_batch_occupancy=stats["mean_batch_occupancy"],
        latency=stats["latency"])))
    return prompts, results, wall, stats


def tie_aware_check(torch, model, prompts, results, label, top_ks=None):
    """Every emitted token is the argmax of its context up to one bf16 ulp,
    judged by one full forward over prompt + generated tokens; a sampled
    stream's (``top_ks[i]``, its ``top_k``) is among the ``top_k`` largest
    logits up to the same bound.

    A random-init bf16 model ties logits, and the served path (paged decode:
    bf16 attention scores, the decode matmul kernel) and the full forward
    (flash attention in f32, the prefill matmul kernel) round differently,
    so the streams are legitimate greedy decodes that need not match
    bitwise. The logits both paths compare are themselves bf16 (the head's
    output), each rounded by up to half an ulp: a gap of one ulp between the
    unrounded logits reads as up to two ulps between the rounded ones, so
    that is the bound. An emission bug gaps by whole units."""
    worst, off = 0.0, []
    for i, p in enumerate(prompts):
        lg = _stream_logits(torch, model, p, results[i])
        k = (top_ks[i] if top_ks is not None else None) or 1
        gap, _ = _ulp_gaps(torch, lg, results[i], k)
        if not torch.isfinite(lg).all() or bool((gap > 2.0).any()):
            raise AssertionError(
                f"{label}: stream {i} emits a token beyond one bf16 ulp of "
                f"the full-forward top {k}: max gap {gap.max().item()} ulp")
        worst = max(worst, gap.max().item())
        off += [(i, int(j), gap[j].item())
                for j in torch.nonzero(gap > 0)[:, 0].tolist()]
    log(f"tie-aware check {label}: ok (worst gap {worst:.3f} ulp of the "
        f"rounded logits, {len(off)} of "
        f"{sum(len(results[i]) for i in range(len(prompts)))} tokens not "
        f"in the exact top k)")
    return off


def _stream_logits(torch, model, prompt, toks):
    """One full forward over prompt + ``toks[:-1]``: the f32 logits that
    pick each token of ``toks``, ``[len(toks), vocab]``."""
    seq = torch.from_numpy(np.concatenate([prompt, toks[:-1]]).astype(
        np.int64)).to(DEVICE)[None]
    return model(seq)[0, len(prompt) - 1:].float()


def _ulp_gaps(torch, lg, toks, k):
    """Each emitted token's logit below the ``k``-th largest of its row,
    in bf16 ulps at the row max (2^(exponent - 7)); and that ulp."""
    emitted = torch.from_numpy(toks.astype(np.int64)).to(DEVICE)
    mx = lg.max(dim=-1).values
    kth = lg.topk(k, dim=-1).values[:, -1]
    got = lg.gather(1, emitted[:, None])[:, 0]
    ulp = torch.exp2(torch.floor(torch.log2(
        mx.abs().clamp(min=2.0 ** -120))) - 7)
    return (kth - got) / ulp, ulp


def _chunk_logits(torch, model, ctx):
    """The chunk program's f32 logits for the token after ``ctx``: the
    whole context fed through ``paged_extend_rows`` in FD_CHUNK chunks,
    one row, over a fresh pool (block 0 the scratch block)."""
    from distkeras_tpu_torch.serving import PagedKVCache

    nb = math.ceil(len(ctx) / BLOCK)
    cache = PagedKVCache(model, nb + 1, BLOCK)
    table = torch.arange(1, nb + 1, device=DEVICE)[None]
    for c0 in range(0, len(ctx), FD_CHUNK):
        pos = torch.arange(c0, min(c0 + FD_CHUNK, len(ctx)), device=DEVICE)
        toks = torch.from_numpy(ctx[c0:c0 + FD_CHUNK].astype(np.int64)) \
            .to(DEVICE)[None]
        slots = (table[0, pos // BLOCK] * BLOCK + pos % BLOCK)[None]
        logits, _, _ = model.paged_extend_rows(
            toks, cache.k_pools, cache.v_pools, table, slots, pos[:1],
            BLOCK)
    return logits[0, -1].float()


def probe_gaps(torch, model, prompts, results, off, label, top_ks=None):
    """Where do ``tie_aware_check``'s off-top-k tokens (``off``: its
    ``(stream, token, gap)`` list) come from? Each one's gap under the
    flash full forward (f32 scores), under a full forward whose attention
    rounds as the served path's einsums do (``attn_impl="reference"``:
    bf16 QK scores, bf16 probabilities into PV) and under the chunk
    program itself (``_chunk_logits`` over its context), with each one's
    largest logit difference from the flash forward at that token and,
    over the probed streams' tokens, the reference's median: gaps in bf16
    ulps at their own row's max, differences at the flash row's.
    Information only: prints and returns one record."""
    from distkeras_tpu_torch.models.lm import TransformerLM

    if not off:
        return None
    ref = TransformerLM(**{**model.config, "attn_impl": "reference"},
                        device=DEVICE).eval()
    ref.load_state_dict(model.state_dict())
    rows, diffs = [], []
    for i in sorted({i for i, _, _ in off}):
        p, toks = prompts[i], results[i]
        k = (top_ks[i] if top_ks is not None else None) or 1
        lf = _stream_logits(torch, model, p, toks)
        lr = _stream_logits(torch, ref, p, toks)
        gf, ulp = _ulp_gaps(torch, lf, toks, k)
        gr, _ = _ulp_gaps(torch, lr, toks, k)
        diff = (lf - lr).abs().max(dim=-1).values / ulp
        diffs.append(diff)
        for _, j, _ in (x for x in off if x[0] == i):
            lc = _chunk_logits(torch, model, np.concatenate([p, toks[:j]]))
            gc, _ = _ulp_gaps(torch, lc[None], toks[j:j + 1], k)
            rows.append(dict(
                stream=i, token=j, context=len(p) + j,
                program="chunk" if j == 0 else "decode",
                gap_flash_ulp=gf[j].item(), gap_reference_ulp=gr[j].item(),
                gap_chunk_ulp=gc[0].item(),
                flash_minus_reference_ulp=diff[j].item(),
                flash_minus_chunk_ulp=((lf[j] - lc).abs().max()
                                       / ulp[j]).item()))
    del ref
    rec = dict(phase=f"gap_probe {label}", device=SMI, tokens=rows,
               median_flash_minus_reference_ulp=torch.cat(diffs)
               .median().item())
    log(json.dumps(rec))
    return rec


def _err(got, ref):
    return (got.float() - ref.float()).abs().max().item()


def imdb_leaf_shapes():
    """The stacked [W, …] leaves of the IMDB LSTM at its published width:
    the tree fused Adam sees once per optimizer step."""
    return [(IMDB_W,) + s for s in (
        (IMDB_VOCAB, IMDB_E), (4 * IMDB_H, IMDB_E), (4 * IMDB_H,),
        (IMDB_H, 4 * IMDB_H), (2, IMDB_H), (2,))]


def check_adam(torch, pk):
    """K5 against its plain version at the slice's shapes (f32, one step
    of the 8-worker stack), plus bf16 gradients and misaligned leaves.
    Kernel and plain do the same f32 operations in the same order with
    IEEE sqrt and division: they must agree exactly (tolerance 0)."""
    gen = torch.Generator(device=DEVICE).manual_seed(5)

    def tree(shapes, scale, dtype=torch.float32):
        return [(torch.randn(s, generator=gen, device=DEVICE) * scale)
                .to(dtype) for s in shapes]

    shapes = imdb_leaf_shapes()
    gs, ms = tree(shapes, 1e-2), tree(shapes, 1e-3)
    vs = [v.abs() for v in tree(shapes, 1e-4)]
    cases = [("imdb f32", gs, ms, vs)]
    small = [(3, 1001), (7,), (2, 513)]
    cases.append(("bf16 grads", tree(small, 1e-2, torch.bfloat16),
                  tree(small, 1e-3), [v.abs() for v in tree(small, 1e-4)]))
    odd = [g.reshape(-1)[1:] for g in tree(small, 1e-2)]   # 4-byte aligned
    cases.append(("misaligned", odd, [torch.zeros_like(g) for g in odd],
                  [torch.zeros_like(g) for g in odd]))
    max_err = 0.0
    for label, g_, m_, v_ in cases:
        got = pk.fused_adam_step(g_, m_, v_, 3, IMDB_LR)
        ref = pk.fused_adam_step(g_, m_, v_, 3, IMDB_LR, impl="plain")
        torch.cuda.synchronize()
        err = max(_err(a, b) for outs in zip(got, ref) for a, b in zip(*outs))
        if err != 0.0 or not all(torch.isfinite(u).all() for u in got[2]):
            raise AssertionError(f"fused_adam {label}: max |kernel - plain| "
                                 f"= {err}, expected 0")
        max_err = max(max_err, err)
        log(f"fused_adam {label}: ok")
    k = pk._coefficients(3, IMDB_LR, 0.9, 0.999, 1e-8)
    outs = ([torch.empty_like(m) for m in ms], [torch.empty_like(v)
                                               for v in vs],
            [torch.empty_like(g) for g in gs])
    table = pk._adam_table(gs, ms, vs, *outs)
    kernel_ms = cuda_ms(torch, lambda: pk._adam_launch(table, k))
    call_ms = eager_ms(torch, lambda: pk.fused_adam_step(gs, ms, vs, 3,
                                                         IMDB_LR))
    plain_ms = cuda_ms(torch, lambda: pk.fused_adam_step(
        gs, ms, vs, 3, IMDB_LR, impl="plain"), iters=5)
    params = [torch.zeros_like(g, requires_grad=True) for g in gs]
    for p, g in zip(params, gs):
        p.grad = g.clone()
    lib_opt = torch.optim.Adam(params, lr=IMDB_LR, fused=True)
    library_ms = eager_ms(torch, lib_opt.step)
    n = sum(g.numel() for g in gs)
    row = dict(elements=n, leaves=len(gs), max_abs_err=max_err,
               kernel_ms=kernel_ms, eager_ms=call_ms, plain_ms=plain_ms,
               library_ms=library_ms,
               **bound(24.0 * n, 12.0 * n, PEAK_F32))
    log("fused_adam " + json.dumps(row))
    del lib_opt, params
    return [row], max_err


def check_lstm(torch, rec):
    """K6 and K7 against their plain versions at the slice's shape (bf16,
    G=8 workers, B=64, T=200, H=128), at the parameter-server path's (G=1:
    each worker thread launches alone; its row names the launch plan) and
    at small cases: B=20, B=17 and
    B=33 are not multiples of the 16-row tile, T=1 and T=2 the edges of
    the scans' prefetch rings (K6's cluster scan at H 32, 64 and 128, and
    K7's backward), T=70 a ragged last chunk of the tensor-core dwh
    product (H=64, bf16), H=144 (bf16) and H=256 (f32) the scans whose
    staged step inputs do not fit in shared memory (and the forward's
    per-block scan). Every case also runs the forward without saving the
    cell states (the eval path's launch): the same hs bits, no cs. The
    ``lstm_forward`` rows name the launch (cluster size, rows, blocks).
    Tolerance: bf16 kernel and plain round the same f32 values to bf16
    each step, and a one-ulp flip of h feeds the next steps, so outputs
    agree to 2^-6 of the plain output's largest magnitude (two bf16 ulps);
    f32 to 1e-5 of it (summation order only). K7 is deterministic: a
    second launch gives the same bits. At the two training shapes K7's two
    launches, the reverse scan and the dwh product, are also timed apart
    (``scan_ms``, ``dwh_ms``)."""
    import torch.nn as nn

    gen = torch.Generator(device=DEVICE).manual_seed(6)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(IMDB_W, IMDB_BATCH, IMDB_T, IMDB_H, bf),
             # the parameter-server path: each worker launches alone (G=1)
             (1, IMDB_BATCH, IMDB_T, IMDB_H, bf),
             (2, 20, 7, 32, f32), (2, 20, 7, 32, bf), (2, 17, 70, 64, bf),
             (2, 17, 2, 64, bf), (3, 17, 1, 64, bf), (2, 17, 2, 32, f32),
             # the cluster scan's edges at the IMDB width: one step, two
             # steps, and a third 16-row group holding one row
             (1, 17, 1, 128, bf), (2, 33, 2, 128, bf),
             # the scans whose staged inputs do not fit in shared memory
             # (step inputs read in the step), the tensor-core and the FMA
             # paths, and the FMA dwh for bf16 at H not a multiple of 64;
             # neither takes the forward's cluster scan
             (1, 17, 3, 144, bf), (1, 17, 3, 256, f32)]
    fwd_rows, bwd_rows, max_err = [], [], 0.0
    for G, B, T, H, dt in cases:
        gx = (torch.randn((G, B, T, 4 * H), generator=gen, device=DEVICE)
              * 0.5).to(dt)
        wh = torch.randn((G, H, 4 * H), generator=gen, device=DEVICE) \
            / H ** 0.5
        dhs = torch.randn((G, B, T, H), generator=gen, device=DEVICE).to(dt)
        launch = rec.forward_launch(gx)
        hs, cs = rec.lstm_forward(gx, wh, True)
        hp, cp = rec.lstm_forward(gx, wh, True, impl="plain")
        # the eval path's launch: no cell states saved, the same hs
        hn, cn = rec.lstm_forward(gx, wh, False)
        dgx, dwh = rec.lstm_backward(gx, wh, hs, cs, dhs)
        dgx2, dwh2 = rec.lstm_backward(gx, wh, hs, cs, dhs)
        dgp, dwp = rec.lstm_backward(gx, wh, hp, cp, dhs, impl="plain")
        torch.cuda.synchronize()
        label = f"G={G} B={B} T={T} H={H} {str(dt).split('.')[-1]}"
        if not (torch.equal(dgx, dgx2) and torch.equal(dwh, dwh2)):
            raise AssertionError(f"lstm {label}: two backward launches "
                                 f"differ (K7 must be deterministic)")
        if cn.numel() != 0 or not torch.equal(hn, hs):
            raise AssertionError(f"lstm {label}: the forward without cell "
                                 f"states gives other hs")
        rel = 2.0 ** -6 if dt == bf else 1e-5
        errs = {}
        for name, got, ref in (("hs", hs, hp), ("hs_no_cells", hn, hp),
                               ("cs", cs, cp),
                               ("dgx", dgx, dgp), ("dwh", dwh, dwp)):
            errs[name] = _err(got, ref)
            scale = ref.float().abs().max().item()
            if not (errs[name] <= rel * scale
                    and torch.isfinite(got.float()).all()):
                raise AssertionError(
                    f"lstm {label} {name}: max |kernel - plain| = "
                    f"{errs[name]} beyond {rel} x {scale}")
        max_err = max(max_err, errs["hs"], errs["dgx"])
        log(f"lstm {label}: ok " + json.dumps(dict(errs, forward=launch)))
        if (B, T, H) != (IMDB_BATCH, IMDB_T, IMDB_H) or G not in (IMDB_W, 1):
            continue
        path = "collective" if G == IMDB_W else "ps"
        esz = 2 if dt == torch.bfloat16 else 4
        seq, gates, wbytes = G * B * T * H, G * B * T * 4 * H, G * H * 4 * H
        mac = 2.0 * G * B * T * H * 4 * H
        lstm_lib = nn.LSTM(H, H, batch_first=True, device=DEVICE, dtype=dt)
        lstm_lib.flatten_parameters()
        x = torch.randn((G * B, T, H), generator=gen, device=DEVICE).to(dt)
        with torch.no_grad():
            lib_fwd = eager_ms(torch, lambda: lstm_lib(x), iters=10)
        xr = x.clone().requires_grad_()
        out = lstm_lib(xr)[0]
        dout = torch.randn_like(out)
        lib_bwd = eager_ms(torch, lambda: torch.autograd.grad(
            out, [xr, *lstm_lib.parameters()], dout, retain_graph=True),
            iters=10)
        fwd_rows.append(dict(
            path=path, G=G, B=B, T=T, H=H, dtype=str(dt).split(".")[-1],
            launch=launch,
            max_abs_err=max(errs["hs"], errs["hs_no_cells"], errs["cs"]),
            kernel_ms=cuda_ms(torch, lambda: rec.lstm_forward(gx, wh, True),
                              iters=5),
            kernel_no_cells_ms=cuda_ms(torch, lambda: rec.lstm_forward(
                gx, wh, False), iters=5),
            eager_ms=eager_ms(torch, lambda: rec.lstm_forward(gx, wh, True),
                              iters=5),
            plain_ms=cuda_ms(torch, lambda: rec.lstm_forward(
                gx, wh, True, impl="plain"), iters=1, replays=2),
            library_ms=lib_fwd,
            **bound(gates * esz + wbytes * 4 + 2 * seq * esz, mac,
                    PEAK_BF16)))
        log("lstm_forward " + json.dumps(fwd_rows[-1]))
        dgx_, dwh_ = torch.empty_like(dgx), torch.empty_like(dwh)
        bwd_rows.append(dict(
            path=path, G=G, B=B, T=T, H=H, dtype=str(dt).split(".")[-1],
            max_abs_err=max(errs["dgx"], errs["dwh"]),
            kernel_ms=cuda_ms(torch, lambda: rec.lstm_backward(
                gx, wh, hs, cs, dhs), iters=5),
            scan_ms=cuda_ms(torch, lambda: rec._lstm_bwd_into(
                dgx_, dwh_, gx, wh, hs, cs, dhs, parts=1), iters=5),
            dwh_ms=cuda_ms(torch, lambda: rec._lstm_bwd_into(
                dgx_, dwh_, gx, wh, hs, cs, dhs, parts=2), iters=5),
            eager_ms=eager_ms(torch, lambda: rec.lstm_backward(
                gx, wh, hs, cs, dhs), iters=5),
            plain_ms=cuda_ms(torch, lambda: rec.lstm_backward(
                gx, wh, hs, cs, dhs, impl="plain"), iters=1, replays=2),
            library_ms=lib_bwd,
            **bound(2 * gates * esz + 3 * seq * esz + wbytes * 4
                    + wbytes * 4, 3.0 * mac, PEAK_BF16)))
        log("lstm_backward " + json.dumps(bwd_rows[-1]))
        del lstm_lib, x, xr, out, dout, dgx_, dwh_
    return fwd_rows, bwd_rows, max_err


def imdb_data():
    from distkeras_tpu_torch.datasets import imdb

    n = IMDB_W * IMDB_WINDOW * IMDB_BATCH * IMDB_WINDOWS
    return imdb(n_train=n, n_test=64, vocab=IMDB_VOCAB, maxlen=IMDB_T)


def compare_window(torch, train):
    """One DynSGD window at full width through the kernels and, from the
    same init on the same superbatch, through their plain versions on the
    card. bf16 forward and backward round at different places in the two,
    so gradients differ by bf16 noise. Adam's first steps move an element
    by at most ~lr (1.01 lr over four steps at b1=0.9, b2=0.999) whatever
    its gradient's size, and a noise-level gradient may take either sign:
    a worker's element can part by 2 lr per step, and the DynSGD fold sums
    the W workers' displacements with weights 1/(i+1). So centers agree
    to 2.02 lr · window · sum 1/(i+1); the mean loss to 1e-2."""
    from distkeras_tpu_torch.models import lstm_classifier
    from distkeras_tpu_torch.ops.pallas_kernels import fused_adam
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.parallel import DynSGDMerge, LocalSGDEngine
    from distkeras_tpu_torch.trainers import _make_loss_step

    batch = next(train.superbatches(IMDB_W, IMDB_BATCH, IMDB_WINDOW,
                                    ["features", "mask", "label"]))
    loss_fn = get_loss("sparse_softmax_cross_entropy")
    out = {}
    for impl in ("kernel", "plain"):
        spec = lstm_classifier(vocab=IMDB_VOCAB, maxlen=IMDB_T,
                               embed_dim=IMDB_E, hidden_dim=IMDB_H,
                               scan_impl=impl)
        engine = LocalSGDEngine(
            spec, _make_loss_step(spec, loss_fn, 2),
            fused_adam(IMDB_LR, impl=impl), DynSGDMerge(), device=DEVICE,
            num_workers=IMDB_W, window=IMDB_WINDOW, batch_size=IMDB_BATCH)
        params, nt = spec.init(0)
        state, loss = engine.run_window(engine.init_state(params, nt), batch)
        out[impl] = (state.center, loss.item())
    (ck, lk), (cp, lp) = out["kernel"], out["plain"]
    diff = max(_err(ck[k], cp[k]) for k in ck)
    mean = max((ck[k] - cp[k]).abs().mean().item() for k in ck)
    limit = 2.02 * IMDB_LR * IMDB_WINDOW * sum(
        1.0 / (i + 1) for i in range(IMDB_W))
    if not (diff <= limit and abs(lk - lp) <= 1e-2
            and all(torch.isfinite(v).all() for v in ck.values())):
        raise AssertionError(
            f"DynSGD window kernel vs plain: max |center diff| {diff} "
            f"(limit {limit}), loss {lk} vs {lp}")
    log("window kernels vs plain: " + json.dumps(dict(
        max_center_diff=diff, max_mean_center_diff=mean, limit=limit,
        loss_kernel=lk, loss_plain=lp)))
    return diff


def train_dynsgd(torch, train, test):
    """The slice's main path: DynSGD on the full-width IMDB LSTM with
    fused Adam (BASELINE config 5), two epochs of IMDB_WINDOWS windows on
    the synthetic IMDB stand-in, random init from seed 0. Returns the
    phase's record; the caller reads the launch counters around it."""
    from distkeras_tpu_torch.models import lstm_classifier
    from distkeras_tpu_torch.trainers import DynSGD

    spec = lstm_classifier(vocab=IMDB_VOCAB, maxlen=IMDB_T, embed_dim=IMDB_E,
                           hidden_dim=IMDB_H)
    t = DynSGD(spec, loss="sparse_softmax_cross_entropy",
               worker_optimizer="fused_adam", learning_rate=IMDB_LR,
               features_col=["features", "mask"], num_workers=IMDB_W,
               batch_size=IMDB_BATCH, communication_window=IMDB_WINDOW,
               num_epoch=2, log_metrics=True, device=DEVICE)
    t0 = time.perf_counter()
    center = t.train(train)
    wall = time.perf_counter() - t0
    losses = t.history.losses()
    if len(losses) != 2 * IMDB_WINDOWS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"DynSGD: bad loss history {losses}")
    if not np.mean(losses[-2:]) < np.mean(losses[:2]):
        raise AssertionError(f"DynSGD: the loss did not fall: {losses}")
    # the trained center through the eval path (no autograd: the forward
    # kernel without saved cell states) against the plain-torch reference
    toks = torch.from_numpy(test["features"][:64]).to(DEVICE)
    mask = torch.from_numpy(test["mask"][:64]).to(DEVICE)
    params = {k: v.to(DEVICE) for k, v in center.items()}
    ref_spec = lstm_classifier(vocab=IMDB_VOCAB, maxlen=IMDB_T,
                               embed_dim=IMDB_E, hidden_dim=IMDB_H,
                               scan_impl="reference")
    with torch.no_grad():
        got, _ = spec.apply(params, {}, (toks, mask), False)
        ref, _ = ref_spec.apply(params, {}, (toks, mask), False)
    eval_err = _err(got, ref)
    if got.shape != (64, 2) or not torch.isfinite(got).all() \
            or eval_err > 0.05 * max(1.0, ref.abs().max().item()):
        raise AssertionError(f"DynSGD eval: logits off the reference by "
                             f"{eval_err}")
    acc = float((got.argmax(-1).cpu().numpy() == test["label"][:64]).mean())
    epochs = [m for m in t.metrics_ if "samples_per_sec" in m]
    rec = dict(wall_s=wall, windows=len(losses),
               rows_per_window=IMDB_W * IMDB_WINDOW * IMDB_BATCH,
               loss_first=losses[0], loss_last=losses[-1],
               eval_logit_err_vs_reference=eval_err, eval_accuracy_64=acc,
               epochs=[dict(epoch=m["epoch"],
                            samples_per_sec=m["samples_per_sec"],
                            window_ms=1e3 * m["wall_time"] / IMDB_WINDOWS)
                       for m in epochs])
    log("train DynSGD imdb_lstm: " + json.dumps(rec))
    return rec


def train_adag_lenet(torch):
    """The flagship beside the main path: LeNet under ADAG (BASELINE
    config 2) on the synthetic MNIST stand-in, 8 stacked workers, held to
    the JAX package's own accuracy gate for it (test accuracy > 0.95, the
    verify recipe's)."""
    from distkeras_tpu_torch.datasets import mnist
    from distkeras_tpu_torch.models import lenet
    from distkeras_tpu_torch.ops.metrics import accuracy
    from distkeras_tpu_torch.trainers import ADAG

    train, test = mnist(n_train=32768, n_test=1024)
    spec = lenet()
    t = ADAG(spec, loss="sparse_softmax_cross_entropy",
             worker_optimizer="adam", learning_rate=1e-3, num_workers=8,
             batch_size=128, communication_window=4, num_epoch=2,
             device=DEVICE)
    t0 = time.perf_counter()
    center = t.train(train, shuffle=True)
    wall = time.perf_counter() - t0
    params = {k: v.to(DEVICE) for k, v in center.items()}
    with torch.no_grad():
        out, _ = spec.apply(params, {}, torch.from_numpy(
            test["features"]).to(DEVICE), False)
    acc = accuracy(torch.from_numpy(test["label"]).to(DEVICE), out).item()
    losses = t.history.losses()
    log("train ADAG lenet: " + json.dumps(dict(
        wall_s=wall, windows=len(losses), loss_first=losses[0],
        loss_last=losses[-1], test_accuracy=acc)))
    if not acc > 0.95:
        raise AssertionError(f"ADAG lenet: test accuracy {acc} <= 0.95")


def _ps_launch_counters():
    """Every kernel wrapper's launch counter, by its kernels-line name."""
    from distkeras_tpu_torch.ops import flash_attention as fa
    from distkeras_tpu_torch.ops import pallas_kernels as pk
    from distkeras_tpu_torch.ops import quant
    from distkeras_tpu_torch.ops import recurrent as rec

    return {"q_matmul": (quant.q_matmul, "launches"),
            "q_matmul_prefill": (quant.q_matmul, "prefill_launches"),
            "flash_attention": (fa._fa_forward, "launches"),
            "flash_attention_bwd_dq": (fa._fa_bwd_dq, "launches"),
            "flash_attention_bwd_dkv": (fa._fa_bwd_dkv, "launches"),
            "flash_attention_small": (fa._fa_forward, "small_launches"),
            "flash_attention_bwd_small": (fa._fa_bwd_small, "launches"),
            "fused_adam": (pk.fused_adam_step, "launches"),
            "lstm_forward": (rec.lstm_forward, "launches"),
            "lstm_backward": (rec.lstm_backward, "launches")}


def zero_launches():
    """Set every launch counter to 0."""
    for fn, attr in _ps_launch_counters().values():
        setattr(fn, attr, 0)


def read_launches():
    """Every launch counter: ``{kernel: launches}``."""
    return {k: getattr(fn, attr)
            for k, (fn, attr) in _ps_launch_counters().items()}


def counted(run):
    """Run ``run()`` with every launch counter set to 0 just before and
    read just after: ``(run's result, {kernel: launches})``."""
    zero_launches()
    out = run()
    return out, read_launches()


def _phase_summary(phases):
    return {k: dict(count=v["count"], mean_ms=v["mean_ms"],
                    max_ms=v["max_ms"], total_ms=v["total_ms"])
            for k, v in phases.items()}


def _worker_loss_fell(history, workers, epochs):
    """Each epoch's mean window loss over every worker: the last epoch's
    must be below the first's."""
    by_epoch = [[r["loss"] for r in history if r.get("epoch") == e
                 and "loss" in r] for e in range(epochs)]
    means = [float(np.mean(v)) for v in by_epoch]
    ok = (all(len(v) > 0 for v in by_epoch) and means[-1] < means[0]
          and all(np.isfinite(means)))
    return ok, means


@contextlib.contextmanager
def _servers_built(module, name: str):
    """Record every parameter server the class ``module.name`` builds
    inside the block (the trainer starts its own; this reads its
    ``stats()`` and τ after the run)."""
    cls = getattr(module, name)
    made = []

    class Recording(cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    setattr(module, name, Recording)
    try:
        yield made
    finally:
        setattr(module, name, cls)


class _NativeTaus:
    """τ of every native exchange, from the versions the C++ server
    returns: a pull and an exchange answer with the center version they
    recorded (an exchange's is its post-fold version), so an exchange
    folded at ``v`` was priced ``τ = v − 1 − pv``, ``pv`` the version of
    the worker's latest record before it, or of the one before that for
    an exchange with the lag flag (``native_ps._XCHG_LAG``). Stands in
    for ``native_ps.load_dkps`` over the block."""

    def __init__(self, native_ps):
        self._mod = native_ps
        self._load = native_ps.load_dkps
        self._lib = None
        self._records: dict = {}
        self.taus: list[int] = []

    def __enter__(self):
        self._lib = self._load()
        self._mod.load_dkps = lambda: self
        return self

    def __exit__(self, *exc):
        self._mod.load_dkps = self._load

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def dkps_client_pull(self, handle, out):
        v = self._lib.dkps_client_pull(handle, out)
        if v >= 0:
            self._records.setdefault(handle, []).append(v)
        return v

    def dkps_client_exchange(self, handle, flags, *args):
        v = self._lib.dkps_client_exchange(handle, flags, *args)
        rec = self._records.setdefault(handle, [])
        if v >= 0 and rec:
            lag = flags & self._mod._XCHG_LAG and len(rec) >= 2
            self.taus.append(int(v - 1 - rec[-2 if lag else -1]))
            rec.append(v)
        return v


def _staleness(taus) -> dict:
    return dict(max=max(taus, default=0),
                mean=float(np.mean(taus)) if taus else 0.0,
                count=len(taus),
                histogram={str(k): taus.count(k) for k in sorted(set(taus))})


def _each_worker_loss_fell(history, workers, epochs):
    """Per worker: its last epoch's mean window loss below its first's."""
    out = []
    for w in range(workers):
        means = [np.mean([r["loss"] for r in history
                          if r.get("worker") == w and r.get("epoch") == e])
                 for e in (0, epochs - 1)]
        out.append(bool(np.all(np.isfinite(means)) and means[1] < means[0]))
    return out


def run_ps_vgg(torch, window: int, lr: float, batch: int, windows: int,
               device: str, transport: str = "socket", depth: int = 0,
               epochs: int = PS3_EPOCHS, num_shards: int = 1) -> dict:
    """Config 3 (bench.py:316-324: CIFAR-10 VGG-small under DOWNPOUR,
    the stale-gradient PS) through ``transport`` at ``ps_pipeline_depth``
    ``depth``. On the socket transport a ``SocketParameterServer`` started
    here, the trainer's PS3_W worker threads pointed at it
    (``ps_host``/``ps_port``); on ``"native"`` and ``"shm"`` the trainer's
    own server, recorded as it is built (``_servers_built``). Either way
    the server's ``stats()`` and τ are read after the run (τ from
    ``recent_staleness()``, or on native from the versions the server
    returns: ``_NativeTaus``); with ``num_shards`` > 1 the trainer's own
    sharded center (``ps_num_shards``), its ``commits`` the fewest any
    shard counted and ``per_shard`` each shard's. ``vgg_small()`` in bf16
    with f32 params on
    the synthetic CIFAR-10 stand-in, fused Adam at ``lr``, ``epochs``
    epochs of ``windows`` windows of ``window`` steps of ``batch`` rows a
    worker; then held-out accuracy (``ModelPredictor`` +
    ``AccuracyEvaluator``) on PS3_TEST rows. Returns the run's record.
    (``ps_sweep.py`` runs this path at other windows and rates, in either
    package.)"""
    from distkeras_tpu_torch.datasets import cifar10
    from distkeras_tpu_torch.evaluators import AccuracyEvaluator
    from distkeras_tpu_torch.models import vgg_small
    from distkeras_tpu_torch.parallel.merge_rules import DownpourMerge
    from distkeras_tpu_torch.parameter_servers import SocketParameterServer
    from distkeras_tpu_torch.predictors import ModelPredictor
    from distkeras_tpu_torch.trainers import DOWNPOUR

    rows = PS3_W * batch * window * windows
    train, test = cifar10(n_train=rows, n_test=PS3_TEST)
    spec = vgg_small()
    kw = dict(loss=LOSS, worker_optimizer="fused_adam", learning_rate=lr,
              num_workers=PS3_W, batch_size=batch,
              communication_window=window, num_epoch=epochs,
              backend="ps", ps_transport=transport,
              ps_pipeline_depth=depth, device=device)
    if num_shards > 1:
        kw["ps_num_shards"] = num_shards
    if transport == "socket":
        init, _ = spec.init_np(0)
        server = SocketParameterServer(init, DownpourMerge(), PS3_W)
        server.initialize()
        server.start()
        try:
            t = DOWNPOUR(spec, ps_host="127.0.0.1", ps_port=server.port,
                         **kw)
            t0 = time.perf_counter()
            center = t.train(train, shuffle=True)
            wall = time.perf_counter() - t0
            stats = server.stats()
            taus = server.recent_staleness()
        finally:
            server.stop()
    else:
        t = DOWNPOUR(spec, **kw)
        t0 = time.perf_counter()
        center, servers, taus = _train_recording(t, train, True, transport,
                                                 num_shards)
        wall = time.perf_counter() - t0
        stats = t.ps_stats_
    t1 = time.perf_counter()
    acc = AccuracyEvaluator().evaluate(ModelPredictor(
        spec, center, device=device).predict(test))
    eval_s = time.perf_counter() - t1
    commits = PS3_W * windows * epochs
    fell, means = _worker_loss_fell(t.history, PS3_W, epochs)
    per_shard = [dict(commits=p["commits"], num_updates=p["num_updates"],
                      shard_nbytes=p["shard_nbytes"])
                 for p in stats.get("per_shard", ())]
    return dict(transport=transport, pipeline_depth=depth, window=window,
                lr=lr, batch=batch, epochs=epochs, num_shards=num_shards,
                windows_a_worker_an_epoch=windows, wall_s=wall,
                eval_s=eval_s, expected_commits=commits,
                commits=min([stats["commits"]]
                            + [p["commits"] for p in per_shard]),
                num_updates=stats["num_updates"], per_shard=per_shard,
                bytes_in=stats["bytes_in"], bytes_out=stats["bytes_out"],
                center_lock_mean_hold_ns=stats["center_lock_mean_hold_ns"],
                staleness=_staleness(taus),
                loss_fell=fell, epoch_mean_loss=means,
                worker_loss_fell=_each_worker_loss_fell(t.history, PS3_W,
                                                        epochs),
                test_accuracy=acc,
                window_wall_ms=1e3 * wall / (commits / PS3_W),
                exchange_phases=_phase_summary(t.exchange_phases_))


def _train_recording(t, ds, shuffle: bool, transport: str,
                     num_servers: int = 1):
    """``t.train(ds)`` on the trainer's own ``transport`` server (or its
    ``num_servers`` shard servers), recorded as they are built: ``(center,
    [server], τ of every commit)``."""
    import distkeras_tpu_torch.workers as workers

    if transport == "native":
        from distkeras_tpu_torch import native_ps as module

        name = "NativeSocketParameterServer"
    elif transport == "shm":
        from distkeras_tpu_torch import shm as module

        name = "ShmParameterServer"
    else:
        module, name = workers, "ParameterServer"
    with contextlib.ExitStack() as stack:
        servers = stack.enter_context(_servers_built(module, name))
        tap = (stack.enter_context(_NativeTaus(module))
               if transport == "native" else None)
        center = t.train(ds, shuffle=shuffle)
    if len(servers) != num_servers:
        raise AssertionError(f"{transport}: {len(servers)} servers built, "
                             f"expected {num_servers}")
    taus = tap.taus if tap is not None else [
        tau for srv in servers for tau in srv.recent_staleness()]
    return center, servers, taus


def train_ps_vgg(torch):
    """Config 3 at PS3_WINDOW, PS3_LR, PS3_BATCH and PS3_WINDOWS through a
    socket PS (``run_ps_vgg``). Returns the run's record; its gates are
    read by ``ps3_failures`` after the ``kernels`` line."""
    rec = run_ps_vgg(torch, PS3_WINDOW, PS3_LR, PS3_BATCH, PS3_WINDOWS,
                     DEVICE)
    log("train DOWNPOUR vgg_small via the socket PS: " + json.dumps(rec))
    return rec


def ps3_failures(name: str, rec: dict, launches: dict,
                 each_worker: bool) -> list:
    """Config 3's gates on one run, as messages (empty when it passed):
    one commit and one fold a window a worker; K5 once a step; some commit
    priced τ ≥ 1 (the run was asynchronous); the loss falls (with
    ``each_worker``, every worker's own too); held-out accuracy above
    PS3_ACC_BAR."""
    out = []
    commits = rec["expected_commits"]
    k5 = PS3_W * rec["windows_a_worker_an_epoch"] * rec["window"] \
        * rec["epochs"]
    if rec["commits"] != commits or rec["num_updates"] != commits:
        out.append(f"{name}: {rec['commits']} commits and "
                   f"{rec['num_updates']} folds, expected {commits}")
    if launches["fused_adam"] != k5:
        out.append(f"{name}: K5 launched {launches['fused_adam']} times, "
                   f"expected {k5}")
    if not rec["staleness"]["max"] >= 1:
        out.append(f"{name}: no commit was stale ({rec['staleness']}): "
                   f"the run was not asynchronous")
    if not (rec["loss_fell"]
            and (all(rec["worker_loss_fell"]) or not each_worker)):
        out.append(f"{name}: the loss did not fall: "
                   f"{rec['epoch_mean_loss']}, by worker "
                   f"{rec['worker_loss_fell']}")
    if not rec["test_accuracy"] > PS3_ACC_BAR:
        out.append(f"{name}: held-out accuracy {rec['test_accuracy']} <= "
                   f"{PS3_ACC_BAR}")
    return out


def run_ps_lstm(torch, train, transport: str, depth: int) -> dict:
    """Config 5 (the IMDB LSTM at full width, bf16 compute, f32 params)
    under DynSGD through the trainer's own ``transport`` server at
    ``ps_pipeline_depth`` ``depth``: PS5_W worker threads of batch
    IMDB_BATCH, window IMDB_WINDOW, fused Adam, PS5_EPOCHS epochs of
    PS5_WINDOWS windows a worker, unshuffled. Gates: one commit and one
    fold a window a worker; the loss falls. Returns the run's record (τ
    of every commit included); the caller reads K5, K6 and K7."""
    from distkeras_tpu_torch.models import lstm_classifier
    from distkeras_tpu_torch.trainers import DynSGD

    rows = PS5_W * IMDB_BATCH * IMDB_WINDOW * PS5_WINDOWS
    ds = train.gather(np.arange(rows))
    spec = lstm_classifier(vocab=IMDB_VOCAB, maxlen=IMDB_T, embed_dim=IMDB_E,
                           hidden_dim=IMDB_H)
    t = DynSGD(spec, loss=LOSS, worker_optimizer="fused_adam",
               learning_rate=IMDB_LR, features_col=["features", "mask"],
               num_workers=PS5_W, batch_size=IMDB_BATCH,
               communication_window=IMDB_WINDOW, num_epoch=PS5_EPOCHS,
               backend="ps", ps_transport=transport,
               ps_pipeline_depth=depth, device=DEVICE)
    t0 = time.perf_counter()
    _, _, taus = _train_recording(t, ds, False, transport)
    wall = time.perf_counter() - t0
    stats = t.ps_stats_
    commits = PS5_W * PS5_WINDOWS * PS5_EPOCHS
    fell, means = _worker_loss_fell(t.history, PS5_W, PS5_EPOCHS)
    rec = dict(transport=transport, pipeline_depth=depth, wall_s=wall,
               commits=stats["commits"], num_updates=stats["num_updates"],
               batched_folds=stats["batched_folds"],
               center_lock_mean_hold_ns=stats["center_lock_mean_hold_ns"],
               staleness=_staleness(taus), epoch_mean_loss=means,
               window_wall_ms=1e3 * wall / (commits / PS5_W),
               exchange_phases=_phase_summary(stats["exchange_phases"]))
    label = f"{transport} PS at depth {depth}"
    log(f"train DynSGD imdb_lstm via the {label}: " + json.dumps(rec))
    if stats["commits"] != commits or stats["num_updates"] != commits:
        raise AssertionError(f"{label}: {stats['commits']} commits and "
                             f"{stats['num_updates']} folds, expected "
                             f"{commits}")
    if not fell:
        raise AssertionError(f"{label}: the loss did not fall: {means}")
    return rec


def train_ps_lstm(torch, train):
    """Config 5 through the in-process PS, serially (``run_ps_lstm``)."""
    return run_ps_lstm(torch, train, "inprocess", 0)


def train_ps_lstm_native_pipelined(torch, train, serial):
    """Config 5 through the native PS at depth 1 (``run_ps_lstm``). Gate:
    some commit was priced τ ≥ 1. Prints its τ beside ``serial``'s (the
    in-process run's); timing moves τ from run to run, so the strict
    check that ``lag`` prices from the previous pull is the CPU test's."""
    rec = run_ps_lstm(torch, train, "native", 1)
    log("config 5 staleness, native pipelined vs in-process serial: "
        + json.dumps(dict(native_pipelined=rec["staleness"],
                          inprocess_serial=serial["staleness"])))
    if not rec["staleness"]["max"] >= 1:
        raise AssertionError(f"native pipelined PS: no commit was priced "
                             f"τ >= 1 ({rec['staleness']})")
    return rec


def train_ps_vgg_transports(torch):
    """Config 3 at PS3_WINDOW, PS3_BATCH and PS3_WINDOWS through the native
    transport serially (PS3_LR, PS3_EPOCHS, as ``train_ps_vgg`` runs it)
    and pipelined, and through shm pipelined (both at PS3_PIPE_LR for
    PS3_PIPE_EPOCHS: the same rate times steps, and about the same rate
    times τ, since pipelining doubles τ), each counted alone
    (``counted``). Returns ``{run: (record, launches)}``;
    ``ps3_failures`` reads each run's gates (every worker's loss falls
    among them) after the ``kernels`` line."""
    out = {}
    for transport, depth in (("native", 0), ("native", 1), ("shm", 1)):
        name = f"config3_{transport}" + ("_pipelined" if depth else "")
        lr, epochs = ((PS3_PIPE_LR, PS3_PIPE_EPOCHS) if depth
                      else (PS3_LR, PS3_EPOCHS))
        out[name] = counted(lambda: run_ps_vgg(
            torch, PS3_WINDOW, lr, PS3_BATCH, PS3_WINDOWS, DEVICE,
            transport=transport, depth=depth, epochs=epochs))
        log(f"train DOWNPOUR vgg_small via the {transport} PS at depth "
            f"{depth}: " + json.dumps(out[name][0]))
        log(f"launches on the {name} path: {json.dumps(out[name][1])}")
    return out


def compare_ps_pipeline(torch, train):
    """One DOWNPOUR worker on config 5 through the kernels over the
    native transport, serially and then at depth 1, from the same init on
    the same PS_PIPE_WINDOWS windows, unshuffled. The JAX package pins the
    two to the same bits (one worker's deferred re-base telescopes:
    ``C_N = C_{N-1} + sent_N`` at fold scale 1); on the card the two runs
    may part where a kernel's sums are not run-to-run deterministic (the
    embedding's backward adds its rows with atomics). The centers are held
    to ``compare_ps_window``'s bound and displacement check; the largest
    difference is printed."""
    from distkeras_tpu_torch.models import lstm_classifier
    from distkeras_tpu_torch.trainers import DOWNPOUR

    rows = IMDB_BATCH * IMDB_WINDOW * PS_PIPE_WINDOWS
    ds = train.gather(np.arange(rows))
    out = {}
    for depth in (0, 1):
        spec = lstm_classifier(vocab=IMDB_VOCAB, maxlen=IMDB_T,
                               embed_dim=IMDB_E, hidden_dim=IMDB_H)
        t = DOWNPOUR(spec, loss=LOSS, worker_optimizer="fused_adam",
                     learning_rate=IMDB_LR,
                     features_col=["features", "mask"], num_workers=1,
                     batch_size=IMDB_BATCH, communication_window=IMDB_WINDOW,
                     num_epoch=1, backend="ps", ps_transport="native",
                     ps_pipeline_depth=depth, device=DEVICE)
        out[depth] = (t.train(ds), t.history.losses())
        init = spec.init_np(t.seed)[0]
    (c0, l0), (c1, l1) = out[0], out[1]
    diff = max(_err(c1[k], c0[k]) for k in c0)
    bits_equal = all(torch.equal(c1[k], c0[k]) for k in c0)
    limit = 2.02 * IMDB_LR * IMDB_WINDOW * PS_PIPE_WINDOWS
    disp, moved = {}, {}
    for k in c0:
        i0 = torch.as_tensor(init[k], dtype=torch.float32)
        d0, d1 = c0[k].float() - i0, c1[k].float() - i0
        moved[k] = d0.norm().item()
        disp[k] = (d1 - d0).norm().item() / max(moved[k], 1e-30)
    rec = dict(max_center_diff=diff, bits_equal=bits_equal, limit=limit,
               max_displacement_rel_diff=max(disp.values()),
               displacement_limit=PS_DISP_FRAC, losses_serial=l0,
               losses_pipelined=l1)
    log("one-worker native PS serial vs pipelined: " + json.dumps(rec))
    if not (diff <= limit and len(l1) == len(l0) == PS_PIPE_WINDOWS
            and all(v <= PS_DISP_FRAC for v in disp.values())
            and all(v > 0 for v in moved.values())
            and all(torch.isfinite(v).all() for v in c1.values())):
        raise AssertionError(f"one-worker native PS serial vs pipelined: "
                             f"max |center diff| {diff} (limit {limit}), "
                             f"displacement parts by {disp}, serial "
                             f"displacement {moved}, losses {l0} vs {l1}")
    return rec


def compare_ps_window(torch, train):
    """One worker through the in-process PS (DynSGD, the IMDB LSTM at full
    width, PS_PARITY_WINDOWS windows, unshuffled) through the kernels and,
    from the same init on the same rows, through every kernel's plain
    version. The bound is ``compare_window``'s for the Adam steps taken:
    2.02 lr a step (W=1, τ=0: the center is the worker's own sum). That
    bound is about twice the furthest Adam can move an element, so it
    cannot catch a kernel that yields no gradient or a wrong one: each
    leaf's displacement from the init must also match the plain run's,
    ``|Δkernel − Δplain| <= PS_DISP_FRAC |Δplain|`` (L2 norms; a plain bf16
    run against a plain f32 one parts by 4.1% at most on the CPU), and
    the plain run must have moved every leaf."""
    from distkeras_tpu_torch.models import lstm_classifier
    from distkeras_tpu_torch.ops.pallas_kernels import fused_adam
    from distkeras_tpu_torch.trainers import DynSGD

    rows = IMDB_BATCH * IMDB_WINDOW * PS_PARITY_WINDOWS
    ds = train.gather(np.arange(rows))
    out = {}
    for impl in ("kernel", "plain"):
        spec = lstm_classifier(vocab=IMDB_VOCAB, maxlen=IMDB_T,
                               embed_dim=IMDB_E, hidden_dim=IMDB_H,
                               scan_impl=impl)
        t = DynSGD(spec, loss=LOSS, worker_optimizer=fused_adam(
                       IMDB_LR, impl=impl), learning_rate=IMDB_LR,
                   features_col=["features", "mask"], num_workers=1,
                   batch_size=IMDB_BATCH, communication_window=IMDB_WINDOW,
                   num_epoch=1, backend="ps", device=DEVICE)
        out[impl] = (t.train(ds), t.history.losses())
        init = spec.init_np(t.seed)[0]   # the run's init, both impls alike
    (ck, lk), (cp, lp) = out["kernel"], out["plain"]
    diff = max(_err(ck[k], cp[k]) for k in ck)
    limit = 2.02 * IMDB_LR * IMDB_WINDOW * PS_PARITY_WINDOWS
    loss_diff = max(abs(a - b) for a, b in zip(lk, lp))
    disp, moved = {}, {}
    for k in ck:
        i0 = torch.as_tensor(init[k], dtype=torch.float32)
        dp, dk = cp[k].float() - i0, ck[k].float() - i0
        moved[k] = dp.norm().item()
        disp[k] = (dk - dp).norm().item() / max(moved[k], 1e-30)
    rec = dict(max_center_diff=diff, limit=limit,
               max_displacement_rel_diff=max(disp.values()),
               displacement_rel_diff=disp, displacement_limit=PS_DISP_FRAC,
               losses_kernel=lk, losses_plain=lp)
    log("one-worker PS window kernels vs plain: " + json.dumps(rec))
    if not (diff <= limit and len(lk) == PS_PARITY_WINDOWS
            and loss_diff <= 1e-2
            and all(v <= PS_DISP_FRAC for v in disp.values())
            and all(v > 0 for v in moved.values())
            and all(torch.isfinite(v).all() for v in ck.values())):
        raise AssertionError(f"one-worker PS kernels vs plain: max |center "
                             f"diff| {diff} (limit {limit}), displacement "
                             f"parts by {disp} (limit {PS_DISP_FRAC}), plain "
                             f"displacement {moved}, losses {lk} vs {lp}")
    return rec


def _config5(transport: str, epochs: int = PS5_EPOCHS, **kw):
    """Config 5 as ``run_ps_lstm`` runs it (PS5_W workers of batch
    IMDB_BATCH, window IMDB_WINDOW, fused Adam, ``epochs`` epochs of
    PS5_WINDOWS windows) on ``transport`` with the resilience ``kw``:
    ``(trainer, its rows)``."""
    from distkeras_tpu_torch.models import lstm_classifier
    from distkeras_tpu_torch.trainers import DynSGD

    spec = lstm_classifier(vocab=IMDB_VOCAB, maxlen=IMDB_T, embed_dim=IMDB_E,
                           hidden_dim=IMDB_H)
    t = DynSGD(spec, loss=LOSS, worker_optimizer="fused_adam",
               learning_rate=IMDB_LR, features_col=["features", "mask"],
               num_workers=PS5_W, batch_size=IMDB_BATCH,
               communication_window=IMDB_WINDOW, num_epoch=epochs,
               backend="ps", ps_transport=transport, device=DEVICE, **kw)
    return t, PS5_W * IMDB_BATCH * IMDB_WINDOW * PS5_WINDOWS


def _fs_type(path: str) -> str:
    return subprocess.run(["stat", "-f", "-c", "%T", path],
                          capture_output=True, text=True, timeout=30,
                          check=True).stdout.strip()


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, n))
               for n in os.listdir(path))


@contextlib.contextmanager
def _traced():
    """Span recording over the block (the trainer leaves a tracer it did
    not enable on); yields a list that receives the events."""
    from distkeras_tpu_torch.observability import trace as _trace

    _trace.enable()
    out: list = []
    try:
        yield out
        out.extend(_trace.events())
    finally:
        _trace.disable()


def _windows_run(history) -> int:
    return sum(1 for r in history if "loss" in r)


def _phase_gates(name, t, launches, extra) -> list:
    """The gates every resilience phase shares, as messages: the
    exactly-once oracle (lifetime folds equal the commits the clients saw
    acknowledged; ``extra`` says whether ``commits`` counts the run too),
    the loss falling, and K5, K6 and K7 launched once a step actually
    taken."""
    out = []
    s, r = t.ps_stats_, t.resilience_stats_
    windows = _windows_run(t.history.records)
    if not s["num_updates"] == r["logical_commits"] == windows:
        out.append(f"{name}: {s['num_updates']} folds, "
                   f"{r['logical_commits']} logical commits, {windows} "
                   f"windows exchanged: not exactly once")
    if extra and s["commits"] != r["logical_commits"]:
        out.append(f"{name}: {s['commits']} commits counted against "
                   f"{r['logical_commits']} logical")
    fell, means = _worker_loss_fell(t.history.records, PS5_W, PS5_EPOCHS)
    if not fell:
        out.append(f"{name}: the loss did not fall: {means}")
    steps = windows * IMDB_WINDOW
    for k in ("fused_adam", "lstm_forward", "lstm_backward"):
        if launches[k] != steps:
            out.append(f"{name}: {k} launched {launches[k]} times, expected "
                       f"{steps} (once a step actually taken)")
    return out


def train_ps_lstm_chaos(torch, train, serial):
    """Config 5 through the socket PS under chaos: a write-ahead log
    (``ps_wal_dir`` in a fresh temporary directory, a snapshot every
    PS5_SNAPSHOT_EVERY commits, so the log rotates and truncates),
    ``RetryPolicy(seed=0)``, heartbeats with a lease shorter than the
    restart delay, and ``FaultPlan(seed=0, drop_recv=PS5_DROP,
    kill_at=PS5_KILL)`` installed with ``with plan:``, a restart budget of
    one. Gates: exactly once (``commits == logical_commits``), some replay
    refused (``dup_commits >= 1``), one restart, some eviction, every
    worker's loss falling, ``recover_ps_state`` of the log equal to the
    final center bit for bit (``num_updates`` too), the ``wal`` CLI's
    verify clean, and K5/K6/K7 once a step actually taken. Prints the
    durability cost beside ``serial``'s (the in-process run's) window."""
    from distkeras_tpu_torch import workers
    from distkeras_tpu_torch.parallel.merge_rules import DynSGDMerge
    from distkeras_tpu_torch.resilience import (
        FaultPlan,
        RetryPolicy,
        recover_ps_state,
    )

    wal_dir = tempfile.mkdtemp(prefix="dk-wal-chaos-")
    try:
        plan = FaultPlan(seed=0, drop_recv=PS5_DROP, kill_at=dict(PS5_KILL))
        t, rows = _config5(
            "socket", ps_wal_dir=wal_dir,
            ps_snapshot_every=PS5_SNAPSHOT_EVERY,
            retry_policy=RetryPolicy(seed=0, max_attempts=PS5_ATTEMPTS,
                                     max_delay=PS5_MAX_DELAY),
            heartbeat_interval=PS5_HEARTBEAT, lease_timeout=PS5_LEASE,
            worker_restart_budget=1, worker_restart_delay=PS5_RESTART_DELAY,
            fault_plan=plan)

        def run():
            with _traced() as events, \
                    _servers_built(workers, "SocketParameterServer") as made, \
                    warnings.catch_warnings(), plan:
                warnings.simplefilter("ignore")   # the restart warning
                t0 = time.perf_counter()
                center = t.train(train.gather(np.arange(rows)))
                wall = time.perf_counter() - t0
            return center, wall, events, made

        (center, wall, events, made), launches = counted(run)
        s, r = t.ps_stats_, t.resilience_stats_
        state = recover_ps_state(wal_dir, DynSGDMerge(), PS5_W, None)
        recovered_equal = state is not None and all(
            np.array_equal(state["center"][k], center[k].numpy())
            for k in center)
        cli = subprocess.run(
            [sys.executable, "-m", "distkeras_tpu_torch.resilience.wal",
             "verify", wal_dir], capture_output=True, text=True, timeout=120)
        verify = json.loads(cli.stdout) if cli.stdout else {}
        phases = _phase_summary(s["exchange_phases"])
        rec = dict(
            phase="ps_config5_chaos_socket", wall_s=wall,
            window_ms=sum(v["mean_ms"] for v in phases.values()),
            inprocess_window_ms=serial["window_wall_ms"],
            inprocess_window_ms_from_phases=sum(
                v["mean_ms"] for v in serial["exchange_phases"].values()),
            wal_wait_total_ms=sum(e["dur_ns"] for e in events
                                  if e["name"] == "ps.wal_wait") / 1e6,
            wal_fsyncs=s["wal_fsyncs"], wal_records=s["wal_records"],
            wal_group_max=s["wal_group_max"],
            wal_bytes_written=made[0]._wal.bytes_written,
            wal_fs=_fs_type(wal_dir),
            commits=s["commits"], num_updates=s["num_updates"],
            logical_commits=r["logical_commits"],
            dup_commits=s["dup_commits"], retries=r["retries"],
            reconnects=r["reconnects"], restarts=r["restarts"],
            evicted_workers=s["evicted_workers"],
            heartbeats=s["heartbeats"], worker_retries=s["worker_retries"],
            faults=plan.stats(), recovered_num_updates=(
                None if state is None else state["num_updates"]),
            recovered_equal=recovered_equal, verify_rc=cli.returncode,
            verify_ok=verify.get("ok"),
            verify_torn_tail_bytes=verify.get("torn_tail_bytes"),
            verify_record_totals=verify.get("record_totals"),
            snapshots=[x["version"] for x in verify.get("snapshots", [])],
            worker_loss_fell=_each_worker_loss_fell(
                t.history.records, PS5_W, PS5_EPOCHS),
            launches=launches, exchange_phases=phases)
        log(json.dumps(rec))
        fails = _phase_gates("chaos", t, launches, extra=True)
        if s["dup_commits"] < 1:
            fails.append(f"chaos: no replay was refused (dup_commits "
                         f"{s['dup_commits']}, faults {plan.stats()})")
        if r["restarts"] != 1 or plan.stats()["kills"] != 1:
            fails.append(f"chaos: {r['restarts']} restarts after "
                         f"{plan.stats()['kills']} kills, expected 1")
        if s["evicted_workers"] < 1:
            fails.append("chaos: no worker was evicted")
        if not all(rec["worker_loss_fell"]):
            fails.append(f"chaos: a worker's loss did not fall: "
                         f"{rec['worker_loss_fell']}")
        if not (recovered_equal
                and rec["recovered_num_updates"] == s["num_updates"]):
            fails.append(f"chaos: the log recovers to "
                         f"{rec['recovered_num_updates']} updates, equal "
                         f"centers {recovered_equal}")
        if not (cli.returncode == 0 and verify.get("ok")
                and verify.get("torn_tail_bytes") == 0
                and len(rec["snapshots"]) == 1):
            fails.append(f"chaos: wal verify rc {cli.returncode}: "
                         f"{cli.stdout[-2000:]} {cli.stderr[-2000:]}")
        if fails:
            raise AssertionError("; ".join(fails))
        return rec
    finally:
        shutil.rmtree(wal_dir, ignore_errors=True)


@contextlib.contextmanager
def _timed_servers(module=None):
    """The socket servers (primary, standby) the trainer builds inside the
    block (through ``module``'s names: ``workers`` by default; a sharded
    group builds through ``parameter_servers``), each stamping when it
    crashed (``t_crash``) and when it first folded a commit
    (``t_first_fold``; a standby folds only once promoted): yields the
    list they land in."""
    if module is None:
        from distkeras_tpu_torch import workers as module

    made: list = []
    names = ("SocketParameterServer", "StandbySocketParameterServer")
    saved = {n: getattr(module, n) for n in names}

    def timed(cls):
        class Timed(cls):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                self.t_crash = self.t_first_fold = None
                made.append(self)

            def _crash(self):
                self.t_crash = time.perf_counter()
                super()._crash()

            def _fold_one_locked(self, work):
                super()._fold_one_locked(work)
                if self.t_first_fold is None and work.version:
                    self.t_first_fold = time.perf_counter()

        return Timed

    for n, cls in saved.items():
        setattr(module, n, timed(cls))
    try:
        yield made
    finally:
        for n, cls in saved.items():
            setattr(module, n, cls)


def train_ps_lstm_failover(torch, train):
    """Config 5 through the socket PS with a hot standby and a write-ahead
    log, the primary crash-stopped once half the run's commits folded
    (``FaultPlan(kill_ps_after_commits=...)``). Gates: one failover, via
    the standby, promoted at fence epoch 1; exactly once (lifetime folds
    equal the logical commits); the loss falls; the final center is the
    promoted standby's, and its own log replays to it bit for bit; K5/K6/K7
    once a step actually taken. Prints the failover time (the kill to the
    standby's first fold) and the failover timeout."""
    from distkeras_tpu_torch.parallel.merge_rules import DynSGDMerge
    from distkeras_tpu_torch.resilience import FaultPlan, recover_ps_state

    wal_dir = tempfile.mkdtemp(prefix="dk-wal-failover-")
    try:
        kill_after = PS5_W * PS5_WINDOWS * PS5_EPOCHS // 2
        plan = FaultPlan(kill_ps_after_commits=kill_after)
        t, rows = _config5("socket", ps_standby=True, ps_wal_dir=wal_dir,
                           ps_failover_timeout=PS5_FAILOVER_TIMEOUT,
                           fault_plan=plan)

        def run():
            with _timed_servers() as made, warnings.catch_warnings(), plan:
                warnings.simplefilter("ignore")   # the failover warning
                t0 = time.perf_counter()
                center = t.train(train.gather(np.arange(rows)))
                wall = time.perf_counter() - t0
            return center, wall, made

        (center, wall, made), launches = counted(run)
        s, r = t.ps_stats_, t.resilience_stats_
        fo = r["ps_failover"]
        primary = next(m for m in made if not hasattr(m, "is_standby"))
        standby = next(m for m in made if hasattr(m, "is_standby"))
        from_standby = all(np.array_equal(center[k].numpy(), v)
                           for k, v in standby.get_model().items())
        state = recover_ps_state(os.path.join(wal_dir, "standby"),
                                 DynSGDMerge(), PS5_W, None)
        replay_equal = state is not None and all(
            np.array_equal(state["center"][k], center[k].numpy())
            for k in center)
        rec = dict(
            phase="ps_config5_failover", wall_s=wall,
            kill_after_commits=kill_after, failovers=fo["failovers"],
            failover_log=fo["failover_log"],
            failover_s=(None if None in (primary.t_crash,
                                         standby.t_first_fold)
                        else standby.t_first_fold - primary.t_crash),
            failover_timeout_s=PS5_FAILOVER_TIMEOUT,
            promoted=standby.promoted_, fence_epoch=standby.fence_epoch,
            num_updates=s["num_updates"],
            logical_commits=r["logical_commits"], retries=r["retries"],
            reconnects=r["reconnects"], standby_num_updates=(
                standby.num_updates), center_from_standby=from_standby,
            standby_log_replays_equal=replay_equal,
            epoch_mean_loss=_worker_loss_fell(t.history.records, PS5_W,
                                              PS5_EPOCHS)[1],
            launches=launches)
        rec["exchange_phases"] = _phase_summary(s["exchange_phases"])
        rec["window_ms"] = sum(v["mean_ms"]
                               for v in rec["exchange_phases"].values())
        log(json.dumps(rec))
        fails = _phase_gates("failover", t, launches, extra=False)
        if not (fo["failovers"] == 1 and plan.stats()["ps_kills"] == 1
                and fo["failover_log"][0]["via"] == "standby"):
            fails.append(f"failover: {fo['failovers']} failovers after "
                         f"{plan.stats()['ps_kills']} kills: "
                         f"{fo['failover_log']}")
        if not (standby.promoted_ and standby.fence_epoch == 1
                and fo["failover_log"][0]["epoch"] == 1):
            fails.append(f"failover: the standby promoted "
                         f"{standby.promoted_} at fence epoch "
                         f"{standby.fence_epoch}, expected 1")
        if not (from_standby and standby.num_updates == s["num_updates"]
                and replay_equal):
            fails.append(f"failover: the final center is the standby's "
                         f"{from_standby}, its log replays to it "
                         f"{replay_equal}")
        if fails:
            raise AssertionError("; ".join(fails))
        return rec
    finally:
        shutil.rmtree(wal_dir, ignore_errors=True)


@contextlib.contextmanager
def _crash_at_first_close():
    """The native server the trainer builds inside the block, with its C++
    span ring armed, crash()ed at the first client close (every worker
    done, none deregistered yet). Every commit is ACKed, so durable, by
    then; the crash waits for the flusher to drain the log's other records
    (an eviction a worker's last heartbeat made), so that every eviction
    the core counted is on disk. Just before the crash, the live state is
    read into the yielded dict: ``center``, ``ema`` (None without
    ``ema_decay``), ``num_updates``, ``fence_epoch``, ``last_seq`` (each
    worker's last sent seqno, from its client), ``evicted`` (the core's
    evictions, read without an expiry pass: a lease that lapses after
    the crash is evicted by the next ``stats()`` alone, with no log to
    hold it) and the ring's ``spans``."""
    from distkeras_tpu_torch import native_ps
    from distkeras_tpu_torch.resilience import retry

    cap: dict = {}
    servers: list = []
    clients: list = []
    srv_cls, cli_cls = native_ps.NativeSocketParameterServer, \
        retry.ResilientPSClient

    class Armed(srv_cls):
        def initialize(self):
            super().initialize()
            self.set_trace(True)
            servers.append(self)

    class CrashAtClose(cli_cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            clients.append(self)

        def close(self):
            if not cap:
                ps = servers[0]
                deadline = time.monotonic() + 20 * ps.wal_group_interval
                while ps.wal_pending() and time.monotonic() < deadline:
                    time.sleep(0.01)
                ema = ps.get_ema()
                cap.update(
                    center=ps.spec.flatten(ps.get_model()),
                    ema=None if ema is None else ps.spec.flatten(ema),
                    num_updates=ps.num_updates, fence_epoch=ps.fence_epoch,
                    last_seq={c.worker_id: c._seq_epoch + c._wire_seq
                              for c in clients if c.seq},
                    wal_pending=ps.wal_pending(),
                    evicted=ps.evicted_count(),
                    spans=ps.scrape_trace_events())
                ps.crash()
            super().close()

    native_ps.NativeSocketParameterServer = Armed
    retry.ResilientPSClient = CrashAtClose
    try:
        yield cap
    finally:
        native_ps.NativeSocketParameterServer = srv_cls
        retry.ResilientPSClient = cli_cls


def train_ps_lstm_native_wal(torch, train, serial):
    """Config 5 through the native PS, serially, with the C++ write-ahead
    log (``ps_wal_dir``), heartbeats and a lease as the chaos phase's
    (PS5_HEARTBEAT, PS5_LEASE: each request renews it in the C++ core) and
    ``RetryPolicy(seed=0)``, and the center's EMA (``ema_decay=EMA_DECAY``,
    folded by the C++ core); the server crash()ed after the last exchange.
    Gates: folds equal the logical commits; the port's
    ``recover_ps_state`` rebuilds from the C++ log the center and the EMA
    last served, bit for bit, with ``num_updates``, ``last_seq`` and
    ``fence_epoch`` equal; K5/K6/K7 once a step. Prints the durability
    cost beside ``serial``'s window."""
    from distkeras_tpu_torch.parallel.merge_rules import DynSGDMerge
    from distkeras_tpu_torch.resilience import RetryPolicy, recover_ps_state

    wal_dir = tempfile.mkdtemp(prefix="dk-wal-native-")
    try:
        t, rows = _config5(
            "native", ps_wal_dir=wal_dir,
            retry_policy=RetryPolicy(seed=0, max_attempts=PS5_ATTEMPTS),
            heartbeat_interval=PS5_HEARTBEAT, lease_timeout=PS5_LEASE,
            ema_decay=EMA_DECAY)

        def run():
            with _crash_at_first_close() as cap:
                t0 = time.perf_counter()
                t.train(train.gather(np.arange(rows)))
                wall = time.perf_counter() - t0
            return cap, wall

        (cap, wall), launches = counted(run)
        s, r = t.ps_stats_, t.resilience_stats_
        spec = t.spec
        template, _ = spec.init_np(t.seed)
        state = recover_ps_state(wal_dir, DynSGDMerge(), PS5_W, EMA_DECAY,
                                 template=template)
        from distkeras_tpu_torch.native_ps import FlatSpec

        flat = None if state is None else FlatSpec(template).flatten(
            state["center"])
        # a worker whose lease lapsed is evicted, and the core retires its
        # dedup entry and logs the eviction; one evicted after its last
        # commit (it waited on a slower peer) stays out of the recovered
        # table, one evicted mid-run (a long window) re-registers with its
        # next commit
        log_evictions = _wal_evictions(wal_dir)
        dropped = log_evictions["dropped"]
        want_seq = {w: q for w, q in cap["last_seq"].items()
                    if w not in dropped}
        equal = flat is not None and np.array_equal(flat, cap["center"])
        ema_equal = (state is not None and state.get("ema") is not None
                     and cap["ema"] is not None and np.array_equal(
                         FlatSpec(template).flatten(state["ema"]),
                         cap["ema"]))
        phases = _phase_summary(s["exchange_phases"])
        rec = dict(
            phase="ps_config5_native_wal", wall_s=wall,
            window_wall_ms=1e3 * wall / (PS5_WINDOWS * PS5_EPOCHS),
            window_ms=sum(v["mean_ms"] for v in phases.values()),
            inprocess_window_ms=serial["window_wall_ms"],
            inprocess_window_ms_from_phases=sum(
                v["mean_ms"] for v in serial["exchange_phases"].values()),
            wal_wait_total_ms=sum(e["dur_ns"] for e in cap["spans"]
                                  if e["name"] == "ps.wal_wait") / 1e6,
            wal_fsync_total_ms=sum(e["dur_ns"] for e in cap["spans"]
                                   if e["name"] == "wal.fsync") / 1e6,
            wal_fsyncs=s["wal_fsyncs"], wal_records=s["wal_records"],
            wal_group_max=s["wal_group_max"],
            wal_bytes_written=_dir_bytes(wal_dir), wal_fs=_fs_type(wal_dir),
            num_updates=cap["num_updates"],
            recovered_num_updates=(None if state is None
                                   else state["num_updates"]),
            center_bits_equal=equal, ema_decay=EMA_DECAY,
            ema_bits_equal=ema_equal,
            ema_moved=(cap["ema"] is not None and not np.array_equal(
                cap["ema"], FlatSpec(template).flatten(template))),
            last_seq_equal=(state is not None
                            and state["last_seq"] == want_seq),
            evicted_after_last_commit=sorted(dropped),
            log_evictions=log_evictions["evictions"],
            evicted_by_crash=cap["evicted"],
            commits_after_evictions=log_evictions["commits_after"],
            log_commits=log_evictions["commits"],
            wal_dir_kept=None,
            fence_epoch=cap["fence_epoch"], recovered_fence_epoch=(
                None if state is None else state["fence_epoch"]),
            heartbeats=s["heartbeats"], lease_timeout_s=PS5_LEASE,
            evicted_workers=s["evicted_workers"],
            dup_commits=s["dup_commits"], commits=s["commits"],
            logical_commits=r["logical_commits"],
            launches=launches, exchange_phases=phases)
        fails = _phase_gates("native_wal", t, launches, extra=True)
        if not (ema_equal and rec["ema_moved"]):
            fails.append(f"native_wal: the C++ log's EMA recovers bit-equal "
                         f"{ema_equal} (the live EMA moved from the init: "
                         f"{rec['ema_moved']})")
        if cap["wal_pending"]:
            fails.append(f"native_wal: {cap['wal_pending']} log records "
                         f"were still unsynced at the crash")
        if (cap["evicted"] != log_evictions["evictions"]
                or s["evicted_workers"] < cap["evicted"]):
            fails.append(f"native_wal: the log holds "
                         f"{log_evictions['evictions']} evictions but the "
                         f"core counted {cap['evicted']} by the crash "
                         f"({s['evicted_workers']} after it)")
        if log_evictions["refolded"]:
            fails.append(f"native_wal: commits folded twice after an "
                         f"eviction: {log_evictions['refolded']}")
        if log_evictions["commits"] != cap["num_updates"]:
            fails.append(f"native_wal: the log folds "
                         f"{log_evictions['commits']} commits, the core "
                         f"acknowledged {cap['num_updates']}")
        if not (equal and rec["last_seq_equal"]
                and rec["recovered_num_updates"] == cap["num_updates"]
                and rec["recovered_fence_epoch"] == cap["fence_epoch"]
                and len(cap["last_seq"]) == PS5_W):
            fails.append(f"native_wal: the C++ log recovers to "
                         f"{rec['recovered_num_updates']} updates (live "
                         f"{cap['num_updates']}), center bits equal {equal}, "
                         f"last_seq equal {rec['last_seq_equal']}, fence "
                         f"{rec['recovered_fence_epoch']} (live "
                         f"{cap['fence_epoch']})")
        if fails:
            # keep the log for a post-mortem: its path is in the record
            rec["wal_dir_kept"] = wal_dir
        log(json.dumps(rec))
        if fails:
            raise AssertionError("; ".join(fails) + f" (log kept in "
                                 f"{wal_dir})")
        shutil.rmtree(wal_dir, ignore_errors=True)
        return rec
    except BaseException:
        log(f"ps_config5_native_wal: the WAL directory is kept at {wal_dir}")
        raise


def _wal_evictions(wal_dir: str) -> dict:
    """What a PS log records of evictions, read from its records in order:
    ``evictions`` (worker ids over every evict record, the core's
    ``evicted_workers`` count), ``dropped`` (workers whose last evict record
    follows their last commit: no dedup entry recovers for them),
    ``commits_after`` ({worker: commit records after its first eviction}),
    ``commits`` (every commit record: one a fold) and ``refolded`` (a
    worker's (worker, seq) folded twice, which must stay empty: a replay
    after an eviction folds once). The server publishes its base snapshot
    at version 0 and the phase's commits stay under the snapshot
    interval, so the segments hold every record of the run; a later
    snapshot would have folded some away, and raises here."""
    from distkeras_tpu_torch.resilience import wal

    names = sorted(os.listdir(wal_dir))
    later = [n for n in names if n.startswith(wal._SNAP_PREFIX)
             and int(n[len(wal._SNAP_PREFIX):-len(wal._SNAP_SUFFIX)]) > 0]
    if later:
        raise AssertionError(f"{wal_dir} holds snapshots {later}: the "
                             f"log's records before them are gone")
    last_commit, evicted_at, first_evict, i = {}, {}, {}, 0
    evictions, commits, seen, refolded = 0, 0, set(), []
    commits_after: dict = {}
    for name in names:
        if not (name.startswith(wal._SEG_PREFIX)
                and name.endswith(wal._SEG_SUFFIX)):
            continue
        with open(os.path.join(wal_dir, name), "rb") as f:
            data = f.read()
        for rec_type, body in wal.iter_records(data):
            i += 1
            kind = wal._REC_NAMES.get(rec_type)
            if kind == "commit":
                w, seq = int(body[0]), body[1]
                commits += 1
                last_commit[w] = i
                if w in first_evict:
                    commits_after[w] = commits_after.get(w, 0) + 1
                if seq is not None:
                    if (w, seq) in seen:
                        refolded.append((w, seq))
                    seen.add((w, seq))
            elif kind == "evict":
                for w in body[0]:
                    evictions += 1
                    evicted_at[int(w)] = i
                    first_evict.setdefault(int(w), i)
    dropped = {w for w, at in evicted_at.items()
               if at > last_commit.get(w, 0)}
    return dict(evictions=evictions, dropped=dropped, commits=commits,
                commits_after={str(w): n for w, n in commits_after.items()},
                refolded=refolded)


def _wal_verify(root: str) -> tuple[int, dict, str]:
    """``python -m distkeras_tpu_torch.resilience.wal verify root``:
    ``(rc, report, the output's tail)``."""
    cli = subprocess.run(
        [sys.executable, "-m", "distkeras_tpu_torch.resilience.wal",
         "verify", root], capture_output=True, text=True, timeout=120)
    report = json.loads(cli.stdout) if cli.stdout else {}
    return cli.returncode, report, (cli.stdout[-2000:] + cli.stderr[-2000:])


def _span_totals(events, *names) -> dict:
    return {n: dict(count=sum(1 for e in events if e["name"] == n),
                    total_ms=sum(e["dur_ns"] for e in events
                                 if e["name"] == n) / 1e6)
            for n in names}


def _config5_init():
    """Config 5's initial center, as ``_config5``'s trainers make it (seed
    0)."""
    from distkeras_tpu_torch.models import lstm_classifier

    return lstm_classifier(vocab=IMDB_VOCAB, maxlen=IMDB_T,
                           embed_dim=IMDB_E, hidden_dim=IMDB_H).init_np(0)[0]


def _replays_equal(splan, init, live, logs) -> dict:
    """Each shard's log (``logs[sid]``) replayed with DynSGD at PS5_W
    workers against its live server's part: equal fold count and every
    leaf bit for bit."""
    from distkeras_tpu_torch.parallel.merge_rules import DynSGDMerge
    from distkeras_tpu_torch.resilience import recover_ps_state

    out = {}
    for sid, d in logs.items():
        state = recover_ps_state(d, DynSGDMerge(), PS5_W, None,
                                 template=splan.shard_template(init, sid))
        part = live[sid].get_model()
        out[sid] = (state is not None
                    and state["num_updates"] == live[sid].num_updates
                    and sorted(state["center"]) == sorted(part)
                    and all(np.array_equal(state["center"][p], v)
                            for p, v in part.items()))
    return out


def train_ps_lstm_sharded_chain(torch, train, failover):
    """Config 5 through a sharded center on the socket transport:
    ``ps_num_shards=PS_SHARDS``, ``ps_chain_length=PS_CHAIN`` (a replica
    behind each shard's primary), a WAL a server under one root, and the
    primary of the shard that holds ``Embed_0.weight`` (10.24 MB of the
    10.77 MB center) crash-stopped once it folded half the run's commits
    (``FaultPlan(kill_ps_after_commits=..., kill_shard_id=...)``). Gates:
    one kill and one failover, on that shard only, via its chain's link, at
    fence epoch 1; every shard's lifetime folds equal the logical commits
    (``num_updates == num_updates_max``); the final center is
    ``plan.join`` of the live servers' parts; each shard's log replays bit
    for bit to its part (the promoted link's ``chain-1`` log for the killed
    shard, ``shard-NN`` for the other); the WAL root verifies clean; every
    worker's loss falls; K5/K6/K7 once a step actually taken. Prints the
    shards' bytes, the failover time (the kill to the promoted link's
    first fold), the chain's ``ps.chain_apply`` and ``ps.chain_forward``
    totals and the window's phases beside ``failover``'s (PR 9's single
    standby)."""
    from distkeras_tpu_torch import parameter_servers, sharding
    from distkeras_tpu_torch.resilience import FaultPlan

    wal_root = tempfile.mkdtemp(prefix="dk-wal-sharded-")
    try:
        init = _config5_init()
        splan = sharding.ShardPlan(init, PS_SHARDS)
        heavy = splan.assignment["['Embed_0.weight']"]
        kill_after = PS5_W * PS5_WINDOWS * PS5_EPOCHS // 2
        plan = FaultPlan(kill_ps_after_commits=kill_after,
                         kill_shard_id=heavy)
        t, rows = _config5("socket", ps_num_shards=PS_SHARDS,
                           ps_chain_length=PS_CHAIN, ps_wal_dir=wal_root,
                           ps_failover_timeout=PS5_FAILOVER_TIMEOUT,
                           fault_plan=plan)

        def run():
            with _traced() as events, \
                    _timed_servers(parameter_servers), \
                    _servers_built(sharding, "ShardedPSGroup") as groups, \
                    warnings.catch_warnings(), plan:
                warnings.simplefilter("ignore")   # the failover warning
                t0 = time.perf_counter()
                center = t.train(train.gather(np.arange(rows)))
                wall = time.perf_counter() - t0
            return center, wall, events, groups

        (center, wall, events, groups), launches = counted(run)
        s, r = t.ps_stats_, t.resilience_stats_
        group = groups[0]
        fo = r["ps_failover"]
        per = fo["per_shard"]
        victim = group.servers[heavy]
        promoted = group.supervisors[heavy].active
        live = group.active_servers
        joined = group.plan.join([srv.get_model() for srv in live])
        center_equal = sorted(joined) == sorted(center) and all(
            np.array_equal(center[k].numpy(), joined[k]) for k in center)
        logs = {sid: (sharding.chain_wal_dir(wal_root, sid, 1)
                      if sid == heavy else
                      sharding.shard_wal_dir(wal_root, sid))
                for sid in range(PS_SHARDS)}
        replays = _replays_equal(splan, init, live, logs)
        rc, verify, tail = _wal_verify(wal_root)
        phases = _phase_summary(s["exchange_phases"])
        rec = dict(
            phase="ps_config5_sharded_chain", wall_s=wall,
            num_shards=PS_SHARDS, chain_length=PS_CHAIN,
            ring=group.plan.digest, shard_paths=group.plan.shard_paths,
            shard_nbytes=group.plan.shard_nbytes, killed_shard=heavy,
            kill_after_commits=kill_after, failovers=fo["failovers"],
            failover_log={sid: p["failover_log"]
                          for sid, p in enumerate(per)},
            failover_s=(None if None in (victim.t_crash,
                                         promoted.t_first_fold)
                        else promoted.t_first_fold - victim.t_crash),
            failover_timeout_s=PS5_FAILOVER_TIMEOUT,
            failover_phase_failover_s=failover["failover_s"],
            promoted_fence_epoch=promoted.fence_epoch,
            map_epoch=s["map_epoch"], num_updates=s["num_updates"],
            num_updates_max=s["num_updates_max"],
            per_shard_num_updates=[p["num_updates"]
                                   for p in s["per_shard"]],
            logical_commits=r["logical_commits"], retries=r["retries"],
            reconnects=r["reconnects"], center_is_join=center_equal,
            logs_replay_equal=replays, log_dirs={
                sid: os.path.relpath(d, wal_root) for sid, d in logs.items()},
            wal_verify_rc=rc, wal_verify_ok=verify.get("ok"),
            wal_dirs=verify.get("num_wal_dirs"),
            spans=_span_totals(events, "ps.chain_apply", "ps.chain_forward",
                               "ps.promote", "ps.failover"),
            window_ms=sum(v["mean_ms"] for v in phases.values()),
            failover_phase_window_ms=failover["window_ms"],
            worker_loss_fell=_each_worker_loss_fell(
                t.history.records, PS5_W, PS5_EPOCHS),
            launches=launches, exchange_phases=phases,
            failover_phase_exchange_phases=failover["exchange_phases"])
        log(json.dumps(rec))
        fails = _phase_gates("sharded_chain", t, launches, extra=False)
        log0 = per[heavy]["failover_log"]
        if not (plan.stats()["ps_kills"] == 1 and fo["failovers"] == 1
                and per[heavy]["failovers"] == 1
                and all(p["failovers"] == 0 for sid, p in enumerate(per)
                        if sid != heavy)
                and log0[0]["via"] == "standby" and log0[0]["epoch"] == 1
                and promoted is group.chains[heavy][0]
                and promoted.promoted_ and promoted.fence_epoch == 1):
            fails.append(f"sharded_chain: {plan.stats()['ps_kills']} kills, "
                         f"failovers by shard {rec['failover_log']}, the "
                         f"chain's link promoted {promoted.promoted_} at "
                         f"epoch {promoted.fence_epoch}")
        if not s["num_updates"] == s["num_updates_max"] \
                == r["logical_commits"]:
            fails.append(f"sharded_chain: shard folds "
                         f"{rec['per_shard_num_updates']} against "
                         f"{r['logical_commits']} logical commits")
        if not center_equal:
            fails.append("sharded_chain: the final center is not the join "
                         "of the live shards")
        if not all(replays.values()):
            fails.append(f"sharded_chain: logs replay to their parts "
                         f"{replays}")
        if not (rc == 0 and verify.get("ok") and verify.get("sharded")):
            fails.append(f"sharded_chain: wal verify rc {rc}: {tail}")
        if not all(rec["worker_loss_fell"]):
            fails.append(f"sharded_chain: a worker's loss did not fall: "
                         f"{rec['worker_loss_fell']}")
        if fails:
            raise AssertionError("; ".join(fails))
        return rec
    finally:
        shutil.rmtree(wal_root, ignore_errors=True)


def compare_ps_sharded(torch, train):
    """One DynSGD worker on config 5 (fused Adam, PS_PARITY_WINDOWS
    windows, unshuffled, the center's EMA at EMA_DECAY) through the
    in-process PS at ``ps_num_shards=PS_PARITY_SHARDS`` and at one shard,
    from the same init on the same rows. Folds are leafwise and each shard
    sees the global fold order, so the centers, and the joined EMA against
    the single server's, must be equal bit for bit. When the centers are
    not, a second unsharded run shows whether the card's compute is
    deterministic run to run (printed; the gate stands). K5/K6/K7 are
    counted on the sharded run."""
    from distkeras_tpu_torch.models import lstm_classifier
    from distkeras_tpu_torch.trainers import DynSGD

    rows = IMDB_BATCH * IMDB_WINDOW * PS_PARITY_WINDOWS
    ds = train.gather(np.arange(rows))

    def run(shards):
        spec = lstm_classifier(vocab=IMDB_VOCAB, maxlen=IMDB_T,
                               embed_dim=IMDB_E, hidden_dim=IMDB_H)
        t = DynSGD(spec, loss=LOSS, worker_optimizer="fused_adam",
                   learning_rate=IMDB_LR, features_col=["features", "mask"],
                   num_workers=1, batch_size=IMDB_BATCH,
                   communication_window=IMDB_WINDOW, num_epoch=1,
                   backend="ps", ps_num_shards=shards, ema_decay=EMA_DECAY,
                   device=DEVICE)
        return t.train(ds), t

    def diff(a, b):
        return max(_err(a[k], b[k]) for k in b)

    t0 = time.perf_counter()
    (c_n, t_n), launches = counted(lambda: run(PS_PARITY_SHARDS))
    c_1, t_1 = run(1)
    equal = all(torch.equal(c_n[k], c_1[k]) for k in c_1)
    ema_n, ema_1 = t_n.ema_params_, t_1.ema_params_
    ema_equal = all(torch.equal(ema_n[k], ema_1[k]) for k in ema_1)
    s = t_n.ps_stats_
    rec = dict(phase="ps_sharded_parity", num_shards=PS_PARITY_SHARDS,
               windows=PS_PARITY_WINDOWS, bits_equal=equal,
               ema_decay=EMA_DECAY, ema_bits_equal=ema_equal,
               ema_max_diff=diff(ema_n, ema_1),
               max_center_diff=diff(c_n, c_1),
               shard_nbytes=[p["shard_nbytes"] for p in s["per_shard"]],
               per_shard_num_updates=[p["num_updates"]
                                      for p in s["per_shard"]],
               losses_sharded=t_n.history.losses(),
               losses_unsharded=t_1.history.losses(), launches=launches,
               wall_s=time.perf_counter() - t0)
    if not equal:
        c_1b, _ = run(1)
        rec["unsharded_runs_bits_equal"] = all(
            torch.equal(c_1b[k], c_1[k]) for k in c_1)
        rec["unsharded_runs_max_diff"] = diff(c_1b, c_1)
    log(json.dumps(rec))
    steps = PS_PARITY_WINDOWS * IMDB_WINDOW
    fails = []
    if not equal:
        fails.append(f"sharded_parity: the {PS_PARITY_SHARDS}-shard center "
                     f"parts from the unsharded one by "
                     f"{rec['max_center_diff']}")
    if not ema_equal:
        fails.append(f"sharded_parity: the joined EMA parts from the single "
                     f"server's by {rec['ema_max_diff']}")
    if not (s["num_updates"] == s["num_updates_max"] == PS_PARITY_WINDOWS
            == t_1.ps_stats_["num_updates"]):
        fails.append(f"sharded_parity: folds {rec['per_shard_num_updates']}"
                     f", expected {PS_PARITY_WINDOWS} on every shard")
    for k in ("fused_adam", "lstm_forward", "lstm_backward"):
        if launches[k] != steps:
            fails.append(f"sharded_parity: {k} launched {launches[k]} "
                         f"times, expected {steps}")
    if fails:
        raise AssertionError("; ".join(fails))
    return rec


def train_ps_vgg_sharded_native(torch, serial):
    """Config 3 as ``train_ps_vgg_transports`` runs it through the native
    PS serially (PS3_LR, PS3_EPOCHS), over ``ps_num_shards=PS3_SHARDS``
    native shard servers, counted alone. Every client's SHARD_INFO
    handshake is recorded (``NativePSClient.shard_info``). Prints the
    shards' bytes and the window's phases beside ``serial``'s (the
    unsharded native run). Returns ``(record, launches)``; its gates
    (``ps3_sharded_failures`` and ``ps3_failures``) are read after the
    ``kernels`` line."""
    from distkeras_tpu_torch import native_ps

    infos: list = []
    shard_info = native_ps.NativePSClient.shard_info

    def recording(self):
        info = shard_info(self)
        infos.append((self.worker_id, info))
        return info

    native_ps.NativePSClient.shard_info = recording
    try:
        rec, launches = counted(lambda: run_ps_vgg(
            torch, PS3_WINDOW, PS3_LR, PS3_BATCH, PS3_WINDOWS, DEVICE,
            transport="native", num_shards=PS3_SHARDS))
    finally:
        native_ps.NativePSClient.shard_info = shard_info
    rec.update(phase="ps_config3_sharded_native",
               handshakes=[(w, i) for w, i in infos],
               unsharded_window_wall_ms=serial["window_wall_ms"],
               unsharded_exchange_phases=serial["exchange_phases"],
               unsharded_test_accuracy=serial["test_accuracy"],
               launches=launches)
    log(json.dumps(rec))
    return rec, launches


def ps3_sharded_failures(rec: dict) -> list:
    """The sharded config 3 run's own gates, as messages: every client's
    handshake named each shard once under the plan's shard count, and
    every shard folded every commit."""
    out = []
    want = {(w, sid) for w in range(PS3_W) for sid in range(PS3_SHARDS)}
    got = [(w, i["shard_id"]) for w, i in rec["handshakes"]
           if i is not None and i["num_shards"] == PS3_SHARDS]
    if len(got) != len(rec["handshakes"]) or set(got) != want \
            or len(got) != len(want):
        out.append(f"config3_sharded_native: handshakes {rec['handshakes']}")
    commits = rec["expected_commits"]
    if not (len(rec["per_shard"]) == PS3_SHARDS and all(
            p["commits"] == p["num_updates"] == commits
            for p in rec["per_shard"])):
        out.append(f"config3_sharded_native: shards folded "
                   f"{rec['per_shard']}, expected {commits} each")
    return out


def _config5_collective(**kw):
    """Config 5 as ``train_dynsgd`` runs it (DynSGD, IMDB_W stacked
    workers of batch IMDB_BATCH, window IMDB_WINDOW, fused Adam,
    unshuffled), streaming its input, with ``kw``."""
    from distkeras_tpu_torch.models import lstm_classifier
    from distkeras_tpu_torch.trainers import DynSGD

    spec = lstm_classifier(vocab=IMDB_VOCAB, maxlen=IMDB_T, embed_dim=IMDB_E,
                           hidden_dim=IMDB_H)
    return DynSGD(spec, loss=LOSS, worker_optimizer="fused_adam",
                  learning_rate=IMDB_LR, features_col=["features", "mask"],
                  num_workers=IMDB_W, batch_size=IMDB_BATCH,
                  communication_window=IMDB_WINDOW, device_data=False,
                  log_metrics=True, device=DEVICE, **kw)


def _epoch_ms(t) -> list:
    """Each epoch's wall time (ms, ``log_metrics``' epoch record: the
    windows and a synchronise, not the checkpoint after them)."""
    return [1e3 * m["wall_time"] for m in t.metrics_
            if "samples_per_sec" in m]


def _kernel_steps(name, launches, steps) -> list:
    """K5, K6 and K7 launched once a step (``steps``) on a collective
    phase: one launch serves every stacked worker."""
    return [f"{name}: {k} launched {launches[k]} times, expected {steps}"
            for k in ("fused_adam", "lstm_forward", "lstm_backward")
            if launches[k] != steps]


def train_resume_collective(torch, train):
    """Config 5 collective (``_config5_collective``), checkpointed and
    resumed. Run A trains CK_EPOCHS epochs without stopping; run B trains
    CK_EPOCHS - 1 with ``checkpoint_dir``, then a fresh trainer with
    ``resume=True, num_epoch=CK_EPOCHS`` trains the last one only; run C is
    B's first trainer with ``checkpoint_async=True``. Gates: B's center
    within ``compare_window``'s bf16 bound of A's (bit-equality printed);
    the resume trained the last epoch only; C's checkpoint files' leaves
    equal B's bit for bit; K5/K6/K7 once a step. Prints the checkpoint's
    bytes, the synchronous save's ms, the async save's ms on the caller's
    thread, the restore's ms, the epoch's wall time with and without a
    checkpoint and the directory's file-system type."""
    from distkeras_tpu_torch import checkpoint as ckpt
    from distkeras_tpu_torch import utils

    sync_dir = tempfile.mkdtemp(prefix="dk-ckpt-")
    async_dir = tempfile.mkdtemp(prefix="dk-ckpt-async-")
    try:
        def run():
            a = _config5_collective(num_epoch=CK_EPOCHS)
            center_a = a.train(train)
            b = _config5_collective(num_epoch=CK_EPOCHS - 1,
                                    checkpoint_dir=sync_dir)
            b.train(train)
            t0 = time.perf_counter()
            ckpt.load_checkpoint(sync_dir)
            restore_ms = 1e3 * (time.perf_counter() - t0)
            r = _config5_collective(num_epoch=CK_EPOCHS,
                                    checkpoint_dir=sync_dir, resume=True)
            center_b = r.train(train)
            c = _config5_collective(num_epoch=CK_EPOCHS - 1,
                                    checkpoint_dir=async_dir,
                                    checkpoint_async=True)
            c.train(train)
            return a, b, r, c, center_a, center_b, restore_ms

        (a, b, r, c, center_a, center_b, restore_ms), launches = \
            counted(run)
        diff = max(_err(center_a[k], center_b[k]) for k in center_a)
        bits = all(torch.equal(center_a[k], center_b[k]) for k in center_a)
        limit = 2.02 * IMDB_LR * IMDB_WINDOW * sum(
            1.0 / (i + 1) for i in range(IMDB_W))
        async_equal = []
        for step in range(CK_EPOCHS - 1):
            x = utils.flatten(ckpt.restore_checkpoint(sync_dir, step)[0])[0]
            y = utils.flatten(ckpt.restore_checkpoint(async_dir, step)[0])[0]
            async_equal.append(len(x) == len(y) and all(
                np.array_equal(np.asarray(u), np.asarray(v))
                for u, v in zip(x, y)))
        ckpt_file = os.path.join(sync_dir, f"ckpt_{0:012d}.dkc")
        resumed_epochs = sorted({h.get("epoch") for h in r.history
                                 if "loss" in h})
        epoch_a, epoch_b = _epoch_ms(a), _epoch_ms(b)
        rec = dict(
            phase="config5_resume_collective", epochs=CK_EPOCHS,
            windows_an_epoch=IMDB_WINDOWS, max_center_diff=diff,
            limit=limit, bits_equal=bits, resumed_epochs=resumed_epochs,
            async_files_bits_equal=async_equal,
            checkpoint_bytes=os.path.getsize(ckpt_file),
            sync_save_ms=b.checkpoint_ms_,
            async_save_caller_ms=c.checkpoint_ms_,
            restore_ms=restore_ms,
            epoch_ms_without_checkpoint=epoch_a,
            epoch_ms_with_checkpoint=[
                e + s for e, s in zip(epoch_b, b.checkpoint_ms_)],
            checkpoint_fs=_fs_type(sync_dir), launches=launches)
        log(json.dumps(rec))
        # A's epochs, B's and its resume's, C's
        steps = IMDB_WINDOWS * IMDB_WINDOW * (3 * CK_EPOCHS - 1)
        fails = _kernel_steps("resume_collective", launches, steps)
        if not diff <= limit:
            fails.append(f"resume_collective: the resumed center parts from "
                         f"the uninterrupted one by {diff} (limit {limit})")
        if resumed_epochs != [CK_EPOCHS - 1]:
            fails.append(f"resume_collective: the resume trained epochs "
                         f"{resumed_epochs}")
        if not all(async_equal):
            fails.append(f"resume_collective: async checkpoint files equal "
                         f"the synchronous run's: {async_equal}")
        if fails:
            raise AssertionError("; ".join(fails))
        return rec
    finally:
        shutil.rmtree(sync_dir, ignore_errors=True)
        shutil.rmtree(async_dir, ignore_errors=True)


def _heldout_accuracy(torch, spec, params, heldout) -> float:
    """``params``' accuracy on the held-out rows (the eval path, in chunks
    of 256)."""
    params = {k: v.to(DEVICE) for k, v in params.items()}
    right = 0
    with torch.no_grad():
        for i in range(0, len(heldout["label"]), 256):
            toks = torch.from_numpy(heldout["features"][i:i + 256]).to(DEVICE)
            mask = torch.from_numpy(heldout["mask"][i:i + 256]).to(DEVICE)
            out, _ = spec.apply(params, {}, (toks, mask), False)
            right += int((out.argmax(-1).cpu().numpy()
                          == heldout["label"][i:i + 256]).sum())
    return right / len(heldout["label"])


def train_ema_collective(torch, train, resume_rec):
    """Config 5 collective for EMA_EPOCHS epochs with ``ema_decay=0`` and
    with ``ema_decay=EMA_DECAY``. Gates: at 0, ``ema_params_`` equals the
    center bit for bit; at EMA_DECAY it differs from the center and the EMA
    model's accuracy on IMDB_HELDOUT fresh rows is above IMDB_ACC_BAR;
    K5/K6/K7 once a step. Prints the window's ms with the EMA beside
    ``resume_rec``'s run without it."""
    from distkeras_tpu_torch.datasets import imdb

    _, heldout = imdb(n_train=1, n_test=IMDB_HELDOUT, vocab=IMDB_VOCAB,
                      maxlen=IMDB_T)

    def run():
        out = {}
        for decay in (0.0, EMA_DECAY):
            t = _config5_collective(num_epoch=EMA_EPOCHS, ema_decay=decay)
            out[decay] = (t, t.train(train))
        return out

    out, launches = counted(run)
    (t0, c0), (t1, c1) = out[0.0], out[EMA_DECAY]
    zero_equal = all(torch.equal(t0.ema_params_[k], c0[k]) for k in c0)
    ema_diff = max(_err(t1.ema_params_[k], c1[k]) for k in c1)
    spec = t1.spec
    acc_ema = _heldout_accuracy(torch, spec, t1.ema_params_, heldout)
    acc_center = _heldout_accuracy(torch, spec, c1, heldout)
    window = lambda ms: [m / IMDB_WINDOWS for m in ms]
    rec = dict(phase="config5_ema_collective", epochs=EMA_EPOCHS,
               ema_decay=EMA_DECAY, zero_decay_bits_equal=zero_equal,
               ema_max_diff_from_center=ema_diff,
               heldout_rows=IMDB_HELDOUT, heldout_accuracy_ema=acc_ema,
               heldout_accuracy_center=acc_center,
               accuracy_bar=IMDB_ACC_BAR,
               window_ms_with_ema=window(_epoch_ms(t1)),
               window_ms_without_ema=window(
                   resume_rec["epoch_ms_without_checkpoint"]),
               launches=launches)
    log(json.dumps(rec))
    fails = _kernel_steps("ema_collective", launches,
                          2 * EMA_EPOCHS * IMDB_WINDOWS * IMDB_WINDOW)
    if not zero_equal:
        fails.append("ema_collective: at decay 0 the EMA is not the center")
    if not (ema_diff > 0 and acc_ema > IMDB_ACC_BAR):
        fails.append(f"ema_collective: the EMA parts from the center by "
                     f"{ema_diff}, its held-out accuracy {acc_ema} (bar "
                     f"{IMDB_ACC_BAR})")
    if fails:
        raise AssertionError("; ".join(fails))
    return rec


def train_ps_checkpoint_ema(torch, train):
    """Config 5 through the in-process PS (``_config5``) with
    ``checkpoint_dir``, ``ema_decay=EMA_DECAY``, ``worker_restart_budget=1``
    (tolerated, so the survivors of a broken barrier train on),
    ``RetryPolicy(seed=0)`` (its seqnos count the acknowledged commits) and
    ``FaultPlan(kill_at={PS_CK_KILL: PS5_WINDOWS})``: the worker dies at
    its first window after the first epoch barrier. Then a ``resume=True``
    run of PS5_EPOCHS + 1 epochs continues from the last barrier. Gates:
    the restart restored from a ``snapshot`` or a ``checkpoint``, not a
    center pull; lifetime folds equal the acknowledged commits; the loss
    falls; K5/K6/K7 once a step; ``ema_params_`` finite; the resume's fold
    count starts at the saved one and trains the epochs after the saved
    epoch only. Prints the barrier's ms an epoch."""
    from distkeras_tpu_torch import checkpoint as ckpt
    from distkeras_tpu_torch.resilience import FaultPlan, RetryPolicy

    ckpt_dir = tempfile.mkdtemp(prefix="dk-ckpt-ps-")
    try:
        plan = FaultPlan(seed=0, kill_at={PS_CK_KILL: PS5_WINDOWS})
        t, rows = _config5(
            "inprocess", checkpoint_dir=ckpt_dir, ema_decay=EMA_DECAY,
            worker_restart_budget=1, tolerate_worker_failures=True,
            retry_policy=RetryPolicy(seed=0), fault_plan=plan)
        ds = train.gather(np.arange(rows))

        def run():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")   # the restart warning
                t0 = time.perf_counter()
                t.train(ds)
                return time.perf_counter() - t0

        wall, launches = counted(run)
        saved, step = ckpt.restore_checkpoint(ckpt_dir)
        saved_updates = int(saved["num_updates"])
        ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir,
                                                  f"ckpt_{step:012d}.dkc"))
        r, _ = _config5("inprocess", epochs=PS5_EPOCHS + 1,
                        checkpoint_dir=ckpt_dir, resume=True)

        def resume():
            t0 = time.perf_counter()
            r.train(ds)
            return time.perf_counter() - t0

        resume_wall, resume_launches = counted(resume)
        s, res = t.ps_stats_, t.resilience_stats_
        sources = [x["from"] for x in res["restart_log"]]
        resumed = [h for h in r.history.records if "loss" in h]
        ema_finite = all(np.isfinite(v.numpy()).all()
                         for v in t.ema_params_.values())
        rec = dict(
            phase="ps_config5_checkpoint_ema", wall_s=wall,
            restarts=res["restarts"], restored_from=sources,
            num_updates=s["num_updates"],
            logical_commits=res["logical_commits"],
            checkpoint_step=step, saved_num_updates=saved_updates,
            barrier_ms=t.checkpoint_ms_, resume_barrier_ms=r.checkpoint_ms_,
            checkpoint_bytes=ckpt_bytes,
            checkpoint_fs=_fs_type(ckpt_dir), ema_decay=EMA_DECAY,
            ema_finite=ema_finite, resume_wall_s=resume_wall,
            resume_num_updates=r.ps_stats_["num_updates"],
            resume_windows=len(resumed),
            resume_epochs=sorted({h["epoch"] for h in resumed}),
            launches=launches, resume_launches=resume_launches)
        log(json.dumps(rec))
        fails = _phase_gates("ps_checkpoint", t, launches, extra=True)
        if not (sources and set(sources) <= {"snapshot", "checkpoint"}):
            fails.append(f"ps_checkpoint: the restart restored from "
                         f"{sources}")
        if not ema_finite:
            fails.append("ps_checkpoint: the EMA is not finite")
        if not (rec["resume_num_updates"] == saved_updates + len(resumed)
                and rec["resume_epochs"] == list(
                    range(int(saved["epoch"]) + 1, PS5_EPOCHS + 1))):
            fails.append(f"ps_checkpoint: the resume folded to "
                         f"{rec['resume_num_updates']} from the saved "
                         f"{saved_updates} over {len(resumed)} windows, "
                         f"epochs {rec['resume_epochs']}")
        steps = len(resumed) * IMDB_WINDOW
        fails += [f"ps_checkpoint resume: {k} launched "
                  f"{resume_launches[k]} times, expected {steps}"
                  for k in ("fused_adam", "lstm_forward", "lstm_backward")
                  if resume_launches[k] != steps]
        if fails:
            raise AssertionError("; ".join(fails))
        return rec
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


# -- elastic membership -------------------------------------------------------


@contextlib.contextmanager
def _elastic_probe(module, names):
    """Measurement hooks over an elastic run. Every worker's window is
    timed as it completes (``AsyncWorker._window_done``: its end and its
    length since the worker's previous mark, its start or its last
    window); every server of the classes ``module.<names>`` builds records
    each worker's first applied fold (its τ, the pull version it was
    priced from, the version it produced), each join's version and the
    largest pool gauge; the coordinator's live pool is read after each
    admission. Yields ``{"windows", "servers", "pool"}``."""
    from distkeras_tpu_torch import workers
    from distkeras_tpu_torch.resilience import elastic

    out = {"windows": [], "servers": [], "pool": []}
    saved = {n: getattr(module, n) for n in names}
    window_done = workers.AsyncWorker._window_done
    admit = elastic.ElasticCoordinator._admit

    def timed_window(self, loss, epoch):
        now = time.monotonic()
        out["windows"].append((self.worker_id, now, now - self.progress_t))
        window_done(self, loss, epoch)

    def counted_admit(self, worker_id, joiner):
        admit(self, worker_id, joiner)
        with self._lock:
            out["pool"].append(sum(
                1 for w, t in self._threads.items()
                if t.is_alive() and w not in self._draining
                and w not in self.timeout_drained))

    def probed(cls):
        class Probed(cls):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                self.first_fold, self.join_version = {}, {}
                self.pool_max = self._pool_size
                out["servers"].append(self)

            def _fold_one_locked(self, work):
                wid = work.worker_id
                if work.lag and wid in self._prev_pull_versions:
                    pv = self._prev_pull_versions[wid]
                else:
                    pv = self._pull_versions.get(wid, 0)
                super()._fold_one_locked(work)
                if work.version and wid not in self.first_fold:
                    self.first_fold[wid] = dict(
                        tau=self._tau_recent[-1], pull_version=pv,
                        version=work.version)

            def join_worker(self, worker_id):
                rec = super().join_worker(worker_id)
                self.join_version[worker_id] = rec["num_updates"]
                self.pool_max = max(self.pool_max, rec["pool_size"])
                return rec

        return Probed

    for n, cls in saved.items():
        setattr(module, n, probed(cls))
    workers.AsyncWorker._window_done = timed_window
    elastic.ElasticCoordinator._admit = counted_admit
    try:
        yield out
    finally:
        for n, cls in saved.items():
            setattr(module, n, cls)
        workers.AsyncWorker._window_done = window_done
        elastic.ElasticCoordinator._admit = admit


class _NativeFirstFolds(_NativeTaus):
    """``_NativeTaus`` that also knows each connection's worker id: every
    worker's first exchange's τ, the pull version it was priced from and
    the version it produced (``first_fold``), as the Python servers'
    probe records them."""

    def __init__(self, native_ps):
        super().__init__(native_ps)
        self._wid: dict = {}
        self.first_fold: dict = {}

    def dkps_client_from_fd(self, fd, wid, n):
        handle = self._lib.dkps_client_from_fd(fd, wid, n)
        self._wid[handle] = int(wid)
        return handle

    def dkps_client_exchange(self, handle, flags, *args):
        before = list(self._records.get(handle, []))
        v = super().dkps_client_exchange(handle, flags, *args)
        wid = self._wid.get(handle)
        if v >= 0 and before and wid not in self.first_fold:
            lag = flags & self._mod._XCHG_LAG and len(before) >= 2
            self.first_fold[wid] = dict(tau=self.taus[-1],
                                        pull_version=before[-2 if lag
                                                            else -1],
                                        version=int(v))
        return v


def _window_split(windows, t_join, t_first):
    """Mean window ms and count: the windows that ended before the join's
    request, and those that started after the joiner's first commit (the
    plan's drain falls near the join, so the pool after it is back to
    PS5_W workers, one of them the joiner)."""
    def mean(sel):
        ms = [1e3 * d for _, end, d in windows if sel(end - d, end)]
        return dict(mean_ms=float(np.mean(ms)) if ms else None,
                    count=len(ms))

    return dict(before_join=mean(lambda s, e: e <= t_join),
                after_join=mean(lambda s, e: s >= t_first))


def _elastic_gates(name, t, launches, first_fold, joiner, extra) -> list:
    """The gates of every elastic phase, as messages: ``_phase_gates``
    (exactly once, the loss falling by epoch means, K5/K6/K7 once a step)
    plus the assigner's ledger exactly once and the joiner's first DynSGD
    commit priced from its join pull: ``τ = version − 1 − pull version``
    with a pull version above 0, so below the fold count a worker that
    never pulled would pay."""
    out = _phase_gates(name, t, launches, extra)
    el = t.resilience_stats_["elastic"]
    o = el["assigner"]
    if not o["exactly_once"]:
        out.append(f"{name}: the assigner's ledger is not exactly once: {o}")
    first = first_fold.get(joiner)
    if first is None:
        out.append(f"{name}: the joiner {joiner} folded nothing")
    elif not (first["tau"] == first["version"] - 1 - first["pull_version"]
              and first["pull_version"] > 0
              and first["tau"] < first["version"] - 1):
        out.append(f"{name}: the joiner's first commit was priced "
                   f"{first}, not from its join pull")
    return out


def run_ps_lstm_elastic(torch, train, name, transport, probe_module,
                        probe_names, **kw):
    """Config 5 (``_config5``) with ``elastic=True``,
    ``RetryPolicy(seed=0)`` (its seqnos count the acknowledged commits) and
    ``FaultPlan(seed=0, **PS5_ELASTIC_PLAN)`` on ``transport``, ``kw`` on
    top. Returns ``(trainer, record, launches, probe)``; the record holds
    the membership counters, the join's ms (its request to the joiner's
    first commit), the drain's ms (the notice to the drain's report), the
    window's ms before and after the join, the
    joiner's first τ beside the run's, and the card."""
    from distkeras_tpu_torch import native_ps
    from distkeras_tpu_torch.resilience import FaultPlan, RetryPolicy

    plan = FaultPlan(seed=0, **PS5_ELASTIC_PLAN)
    t, rows = _config5(transport, elastic=True,
                       retry_policy=RetryPolicy(seed=0), fault_plan=plan,
                       **kw)
    ds = train.gather(np.arange(rows))
    native_taus = _NativeFirstFolds(native_ps)

    def run():
        with _elastic_probe(probe_module, probe_names) as probe, \
                native_taus, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t0 = time.perf_counter()
            t.train(ds)
            return time.perf_counter() - t0, probe

    (wall, probe), launches = counted(run)
    s, r = t.ps_stats_, t.resilience_stats_
    el = r["elastic"]
    first_fold = (probe["servers"][0].first_fold if probe["servers"]
                  else native_taus.first_fold)
    joiner = el["join_log"][0]["worker"] if el["join_log"] else None
    t_join = el["join_log"][0]["t"] if el["join_log"] else None
    t_first = min((end for w, end, _ in probe["windows"] if w == joiner),
                  default=None)
    drain = el["drain_log"][0] if el["drain_log"] else None
    taus = (list(probe["servers"][0].recent_staleness())
            if probe["servers"] else native_taus.taus)
    rec = dict(
        phase=name, device=SMI, wall_s=wall,
        joined=el["joined"], preempted=el["preempted"],
        drain_timeouts=el["drain_timeouts"],
        membership={k: s[k] for k in ELASTIC_COUNTERS},
        num_updates=s["num_updates"], commits=s["commits"],
        logical_commits=r["logical_commits"],
        windows=_windows_run(t.history.records),
        assigner=el["assigner"],
        join_ms=(None if t_first is None or t_join is None
                 else 1e3 * (t_first - t_join)),
        drain_ms=(None if drain is None
                  else 1e3 * (drain["t_done"] - drain["t"])),
        window_ms=(_window_split(probe["windows"], t_join, t_first)
                   if None not in (t_join, t_first) else None),
        joiner=joiner, joiner_first_fold=first_fold.get(joiner),
        pool_at_join=PS5_W + 1, staleness=_staleness(taus),
        launches=launches,
        exchange_phases=_phase_summary(s["exchange_phases"]))
    log(json.dumps(rec))
    return t, rec, launches, probe


#: the membership counters every server's stats() carries
ELASTIC_COUNTERS = ("pool_size", "joined_workers", "preempted_workers",
                    "drain_timeouts")


def _membership_gates(name, rec) -> list:
    m, out = rec["membership"], []
    if (rec["joined"], rec["preempted"], rec["drain_timeouts"]) != (1, 1, 0):
        out.append(f"{name}: {rec['joined']} joins, {rec['preempted']} "
                   f"preemptions, {rec['drain_timeouts']} drain timeouts, "
                   f"expected 1, 1, 0")
    if (m["joined_workers"], m["preempted_workers"], m["drain_timeouts"],
            m["pool_size"]) != (1, 1, 0, PS5_W):
        out.append(f"{name}: the server counted {m}")
    if rec["join_ms"] is None or rec["drain_ms"] is None:
        out.append(f"{name}: the join ({rec['join_ms']}) or the drain "
                   f"({rec['drain_ms']}) was not timed")
    return out


def train_ps_lstm_elastic(torch, train):
    """``ps_config5_elastic``: config 5 elastic (``run_ps_lstm_elastic``)
    on the in-process PS, then on the socket PS with a write-ahead log.
    Gates, each run: the assigner's ledger exactly once (every block of
    each epoch completed once, none in flight, no stale completion); one
    join, one preemption, no drain timeout, in the coordinator and in the
    server's counters (the pool back at PS5_W); lifetime folds equal the
    acknowledged commits and the windows run; the joiner's first τ priced
    from its join pull; the loss falling; K5/K6/K7 once a step."""
    from distkeras_tpu_torch import workers

    recs, fails = {}, []
    wal_dir = tempfile.mkdtemp(prefix="dk-wal-elastic-")
    try:
        for name, transport, names, kw in (
                ("inprocess", "inprocess", ("ParameterServer",), {}),
                ("socket_wal", "socket", ("SocketParameterServer",),
                 dict(ps_wal_dir=wal_dir))):
            t, rec, launches, probe = run_ps_lstm_elastic(
                torch, train, f"ps_config5_elastic_{name}", transport,
                workers, names, **kw)
            recs[name] = rec
            fails += _elastic_gates(f"elastic {name}", t, launches,
                                    probe["servers"][0].first_fold,
                                    rec["joiner"], extra=True)
            fails += _membership_gates(f"elastic {name}", rec)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(wal_dir, ignore_errors=True)
    if fails:
        raise AssertionError("; ".join(fails))
    return recs


def train_ps_lstm_elastic_native_pipelined(torch, train, inprocess):
    """``ps_config5_elastic_native_pipelined``: the same plan through the
    native PS at ``ps_pipeline_depth=1``: ``_train_elastic_pipelined`` and
    the C++ JOIN/DRAIN. The same gates (the joiner's τ from the versions
    the core returns), and the core's membership counters equal to the
    in-process run's (``inprocess``, its record)."""
    from distkeras_tpu_torch import workers

    t, rec, launches, probe = run_ps_lstm_elastic(
        torch, train, "ps_config5_elastic_native_pipelined", "native",
        workers, (), ps_pipeline_depth=1)
    fails = _elastic_gates("elastic native pipelined", t, launches,
                           {rec["joiner"]: rec["joiner_first_fold"]},
                           rec["joiner"], extra=True)
    fails += _membership_gates("elastic native pipelined", rec)
    if rec["membership"] != inprocess["membership"]:
        fails.append(f"elastic native pipelined: the core counted "
                     f"{rec['membership']}, the in-process PS "
                     f"{inprocess['membership']}")
    if fails:
        raise AssertionError("; ".join(fails))
    return rec


def train_ps_lstm_elastic_sharded(torch, train):
    """``ps_config5_elastic_sharded``: the same plan over PS_SHARDS socket
    shards. Gates: the elastic gates (the joiner's τ on every shard);
    every shard's lifetime folds equal the logical commits (``num_updates``
    min == max); every shard counted the join and the drain."""
    from distkeras_tpu_torch import parameter_servers

    t, rec, launches, probe = run_ps_lstm_elastic(
        torch, train, "ps_config5_elastic_sharded", "socket",
        parameter_servers, ("SocketParameterServer",),
        ps_num_shards=PS_SHARDS)
    s = t.ps_stats_
    fails = _membership_gates("elastic sharded", rec)
    for i, srv in enumerate(probe["servers"]):
        fails += _elastic_gates(f"elastic sharded shard {i}", t, launches,
                                srv.first_fold, rec["joiner"], extra=False)
    if not s["num_updates"] == s["num_updates_max"] == \
            t.resilience_stats_["logical_commits"]:
        fails.append(f"elastic sharded: shards folded {s['num_updates']}"
                     f"..{s['num_updates_max']} against "
                     f"{t.resilience_stats_['logical_commits']} logical")
    counted_each = [(x["joined_workers"], x["preempted_workers"])
                    for x in s["per_shard"]]
    if len(counted_each) != PS_SHARDS or set(counted_each) != {(1, 1)}:
        fails.append(f"elastic sharded: the shards counted (joins, "
                     f"drains) {counted_each}")
    rec["per_shard_membership"] = counted_each
    rec["per_shard_num_updates"] = [x["num_updates"] for x in s["per_shard"]]
    if fails:
        raise AssertionError("; ".join(fails))
    return rec


def train_ps_lstm_autoscale(torch, train):
    """``ps_config5_autoscale``: config 5 elastic on the in-process PS with
    ``autoscale_target=ElasticPolicy(target_rounds_per_sec=1e6,
    cooldown_s=0.5, max_workers=PS5_POOL_MAX)`` and ``max_pool_size=
    PS5_POOL_MAX``, no fault plan. Gates: some join the autoscaler asked
    for; the coordinator's live pool never above PS5_POOL_MAX; the
    assigner's ledger exactly once; folds equal the acknowledged commits;
    the loss falling; K5/K6/K7 once a step. Prints the policy's decisions
    and the joins with their times from the run's start."""
    from distkeras_tpu_torch import workers
    from distkeras_tpu_torch.resilience import ElasticPolicy, RetryPolicy

    policy = ElasticPolicy(target_rounds_per_sec=1e6, cooldown_s=0.5,
                           max_workers=PS5_POOL_MAX)
    t, rows = _config5("inprocess", elastic=True,
                       retry_policy=RetryPolicy(seed=0),
                       autoscale_target=policy, max_pool_size=PS5_POOL_MAX)
    ds = train.gather(np.arange(rows))

    def run():
        with _elastic_probe(workers, ("ParameterServer",)) as probe:
            t0 = time.perf_counter()
            m0 = time.monotonic()
            t.train(ds)
            return time.perf_counter() - t0, m0, probe

    (wall, m0, probe), launches = counted(run)
    s, r = t.ps_stats_, t.resilience_stats_
    el = r["elastic"]
    rec = dict(
        phase="ps_config5_autoscale", device=SMI, wall_s=wall,
        joined=el["joined"], preempted=el["preempted"],
        drain_timeouts=el["drain_timeouts"],
        membership={k: s[k] for k in ELASTIC_COUNTERS},
        live_pool_max=max(probe["pool"], default=0),
        server_pool_max=probe["servers"][0].pool_max,
        decisions=[dict(d, t=d["t"] - m0) for d in el["policy_decisions"]],
        joins=[dict(j, t=j["t"] - m0) for j in el["join_log"]],
        drains=[dict(d, t=d["t"] - m0, t_done=d["t_done"] - m0)
                for d in el["drain_log"]],
        num_updates=s["num_updates"], logical_commits=r["logical_commits"],
        windows=_windows_run(t.history.records), assigner=el["assigner"],
        launches=launches,
        exchange_phases=_phase_summary(s["exchange_phases"]))
    log(json.dumps(rec))
    fails = _phase_gates("autoscale", t, launches, extra=True)
    if not el["assigner"]["exactly_once"]:
        fails.append(f"autoscale: the ledger is not exactly once: "
                     f"{el['assigner']}")
    if not any(j["reason"] == "autoscaler" for j in el["join_log"]):
        fails.append(f"autoscale: no join from the autoscaler: "
                     f"{el['join_log']}, {el['policy_decisions']}")
    if not 0 < rec["live_pool_max"] <= PS5_POOL_MAX:
        fails.append(f"autoscale: the live pool reached "
                     f"{rec['live_pool_max']} (max {PS5_POOL_MAX})")
    if fails:
        raise AssertionError("; ".join(fails))
    return rec


@contextlib.contextmanager
def _timed_directories():
    """The directory replicas ``directory/host.py`` builds inside the
    block, each stamping when it crashed (``t_crash``) and when its
    promotion finished (``t_promoted``): yields the list they land in."""
    from distkeras_tpu_torch.directory import host

    made: list = []
    saved = {n: getattr(host, n)
             for n in ("DirectoryServer", "StandbyDirectoryServer")}

    def timed(cls):
        class Timed(cls):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                self.t_crash = self.t_promoted = None
                made.append(self)

            def _crash(self):
                self.t_crash = time.perf_counter()
                super()._crash()

            def promote(self, *args, **kw):
                super().promote(*args, **kw)
                self.t_promoted = time.perf_counter()

        return Timed

    for n, cls in saved.items():
        setattr(host, n, timed(cls))
    try:
        yield made
    finally:
        for n, cls in saved.items():
            setattr(host, n, cls)


def _directory_chaos_run(train, wal_root, with_directory):
    """One run of ``ps_config5_directory_chaos``'s trainer, its WAL under
    ``wal_root``: config 5 elastic over PS_SHARDS socket shards chained
    PS_CHAIN deep, heartbeats, the retry policy, shard 1's primary killed
    at half the commits and a worker joined at worker 0's first window;
    ``with_directory`` adds ``directory=True`` and the plan's directory
    kill and partition. Without them it is the phase's control. Returns
    ``dict(t, plan, center, wall, probe, dirs, group, hosted, launches)``
    (``hosted`` None without the directory)."""
    from distkeras_tpu_torch import directory, parameter_servers, sharding
    from distkeras_tpu_torch import workers
    from distkeras_tpu_torch.resilience import FaultPlan, RetryPolicy

    events = (dict(kill_directory_after_ops=PS5_DIR_KILL_OPS,
                   directory_partition_after=PS5_DIR_PART_AFTER,
                   directory_partition_ops=PS5_DIR_PART_OPS)
              if with_directory else {})
    plan = FaultPlan(seed=0, kill_ps_after_commits=PS5_DIR_KILL_AFTER,
                     kill_shard_id=PS5_DIR_VICTIM,
                     join_worker_at_window={0: 1}, **events)
    t, rows = _config5(
        "socket", directory=with_directory, ps_num_shards=PS_SHARDS,
        ps_chain_length=PS_CHAIN, ps_wal_dir=wal_root,
        ps_failover_timeout=PS5_FAILOVER_TIMEOUT, elastic=True,
        heartbeat_interval=PS5_DIR_HEARTBEAT, lease_timeout=PS5_DIR_LEASE,
        retry_policy=RetryPolicy(**PS5_DIR_RETRY), fault_plan=plan)

    def run():
        with _elastic_probe(workers, ()) as probe, \
                _timed_servers(parameter_servers), \
                _timed_directories() as dirs, \
                _servers_built(sharding, "ShardedPSGroup") as groups, \
                _servers_built(directory, "HostedDirectory") as hosts, \
                warnings.catch_warnings(), plan:
            warnings.simplefilter("ignore")   # the failover warnings
            t0 = time.perf_counter()
            center = t.train(train.gather(np.arange(rows)))
            wall = time.perf_counter() - t0
        return center, wall, probe, dirs, groups[0], hosts

    (center, wall, probe, dirs, group, hosts), launches = counted(run)
    return dict(t=t, plan=plan, center=center, wall=wall, probe=probe,
                dirs=dirs, group=group, hosted=hosts[0] if hosts else None,
                launches=launches)


def _windows_by_failover(windows, spans):
    """The probe's windows split into those that overlap a failover span
    (held up by it) and the rest: count, mean, min and max ms of each.
    ``spans`` are ``(start, end)`` on ``time.perf_counter``'s clock, the
    windows on ``time.monotonic``'s; a span with an unknown end is
    skipped."""
    shift = time.monotonic() - time.perf_counter()
    spans = [(a + shift, b + shift) for a, b in spans if None not in (a, b)]
    held, outside = [], []
    for _, end, d in windows:
        hit = any(end - d < b and end > a for a, b in spans)
        (held if hit else outside).append(1e3 * d)

    def summary(ms):
        return dict(count=len(ms),
                    mean_ms=float(np.mean(ms)) if ms else None,
                    min_ms=min(ms, default=None),
                    max_ms=max(ms, default=None))

    return dict(outside=summary(outside), held=summary(held))


def train_ps_lstm_directory_chaos(torch, train):
    """``ps_config5_directory_chaos``: config 5 (``_config5``) elastic over
    PS_SHARDS chained socket shards (``ps_chain_length=PS_CHAIN``, a WAL
    under one root) with ``directory=True`` (the hosted directory, its
    standby and their WAL under ``<root>/directory``): every worker's
    client, the joiner's too, minted from a directory lookup. The fault
    plan joins a worker at worker 0's first window, crash-stops shard 1's
    primary at half the commits and the directory primary at its
    PS5_DIR_KILL_OPS-th op, and drops ops PS5_DIR_PART_AFTER + 1 ..
    + PS5_DIR_PART_OPS. Gates: one PS kill, one directory kill, one join;
    some partition drops; a shard failover and a directory failover; every
    shard's folds equal the logical commits; each shard's log replays bit
    for bit to its part of the final center; the WAL root verifies and
    names the directory log; the assigner's ledger exactly once; the final
    membership holds both shards, shard 1 at the promoted link at fence
    epoch >= 1; the directory's lookups at least the 9 clients minted; the
    loss falling by epoch means; K5/K6/K7 once a step. Prints the shard's
    and the directory's failover ms beside their timeouts, the publishes,
    renewals and lookups, and the windows outside the failovers beside
    those of a control run first: the same trainer and plan without the
    directory and its events (one kill, one join, a failover, exactly once
    and K5/K6/K7 once a step gated), so the difference is the
    directory's."""
    from distkeras_tpu_torch import sharding

    t_phase = time.perf_counter()
    ctl_root = tempfile.mkdtemp(prefix="dk-wal-nodirectory-")
    try:
        c = _directory_chaos_run(train, ctl_root, with_directory=False)
    finally:
        shutil.rmtree(ctl_root, ignore_errors=True)
    ct, cfs = c["t"], c["plan"].stats()
    c_victim = c["group"].servers[PS5_DIR_VICTIM]
    c_promoted = c["group"].supervisors[PS5_DIR_VICTIM].active
    c_failover = (c_victim.t_crash, c_promoted.t_first_fold)
    control = dict(
        wall_s=c["wall"], faults={k: cfs[k] for k in ("ps_kills", "joins")},
        shard_failovers=ct.resilience_stats_["ps_failover"]["failovers"],
        shard_failover_ms=(None if None in c_failover
                           else 1e3 * (c_failover[1] - c_failover[0])),
        num_updates=ct.ps_stats_["num_updates"],
        num_updates_max=ct.ps_stats_["num_updates_max"],
        logical_commits=ct.resilience_stats_["logical_commits"],
        windows=_windows_by_failover(c["probe"]["windows"], [c_failover]),
        exchange_phases=_phase_summary(ct.ps_stats_["exchange_phases"]),
        launches=c["launches"])
    fails = _phase_gates("directory_chaos control", ct, c["launches"],
                         extra=False)
    if (cfs["ps_kills"], cfs["joins"]) != (1, 1) \
            or control["shard_failovers"] < 1 \
            or ct.ps_stats_["num_updates"] != ct.ps_stats_["num_updates_max"]:
        fails.append(f"directory_chaos control: {control}")
    del c
    torch.cuda.empty_cache()

    wal_root = tempfile.mkdtemp(prefix="dk-wal-directory-")
    try:
        init = _config5_init()
        splan = sharding.ShardPlan(init, PS_SHARDS)
        victim_sid = PS5_DIR_VICTIM
        kill_after = PS5_DIR_KILL_AFTER
        run = _directory_chaos_run(train, wal_root, with_directory=True)
        t, plan, launches = run["t"], run["plan"], run["launches"]
        center, wall, probe = run["center"], run["wall"], run["probe"]
        dirs, group, hosted = run["dirs"], run["group"], run["hosted"]
        s, r = t.ps_stats_, t.resilience_stats_
        fs, el, dstats = plan.stats(), r["elastic"], r["directory"]
        per = r["ps_failover"]["per_shard"]
        victim = group.servers[victim_sid]
        promoted = group.supervisors[victim_sid].active
        live = group.active_servers
        joined = group.plan.join([srv.get_model() for srv in live])
        center_equal = sorted(joined) == sorted(center) and all(
            np.array_equal(center[k].numpy(), joined[k]) for k in center)
        logs = {sid: (sharding.chain_wal_dir(wal_root, sid, 1)
                      if per[sid]["failovers"] else
                      sharding.shard_wal_dir(wal_root, sid))
                for sid in range(PS_SHARDS)}
        replays = _replays_equal(splan, init, live, logs)
        rc, verify, tail = _wal_verify(wal_root)
        dead = next((d for d in dirs if d.t_crash is not None), None)
        took = next((d for d in dirs if d.t_promoted is not None), None)
        entries = {e["key"]: e for e in dstats["membership"]["entries"]}
        shard1 = entries.get(f"shard-{victim_sid:02d}", {})
        counts = {k: sum(getattr(d, k) for d in dirs)
                  for k in ("publishes", "renews", "lookups",
                            "stale_rejects", "expired_entries")}
        t_join = el["join_log"][0]["t"] if el["join_log"] else None
        joiner = el["join_log"][0]["worker"] if el["join_log"] else None
        t_first = min((end for w, end, _ in probe["windows"]
                       if w == joiner), default=None)
        phases = _phase_summary(s["exchange_phases"])
        by_failover = _windows_by_failover(probe["windows"], [
            (victim.t_crash, promoted.t_first_fold),
            (None, None) if None in (dead, took)
            else (dead.t_crash, took.t_promoted)])
        rec = dict(
            phase="ps_config5_directory_chaos", device=SMI, wall_s=wall,
            num_shards=PS_SHARDS, chain_length=PS_CHAIN,
            killed_shard=victim_sid, kill_after_commits=kill_after,
            directory_kill_after_ops=PS5_DIR_KILL_OPS,
            directory_partition=[PS5_DIR_PART_AFTER, PS5_DIR_PART_OPS],
            faults={k: fs[k] for k in ("ps_kills", "directory_kills",
                                       "directory_ops", "directory_drops",
                                       "joins")},
            shard_failovers={sid: p["failover_log"]
                             for sid, p in enumerate(per)},
            shard_failover_ms=(None if None in (victim.t_crash,
                                                promoted.t_first_fold)
                               else 1e3 * (promoted.t_first_fold
                                           - victim.t_crash)),
            directory_failover=dstats.get("failover"),
            directory_failover_ms=(None if dead is None or took is None
                                   else 1e3 * (took.t_promoted
                                               - dead.t_crash)),
            failover_timeout_s=PS5_FAILOVER_TIMEOUT,
            directory_ttl_s=hosted.default_ttl,
            entry_ttl_s=hosted.entry_ttl(True),
            directory_counts=counts,
            directory_supervisor_publishes=[
                sup.publishes for sup in group.supervisors],
            membership={k: dict(port=e["port"], epoch=e["epoch"],
                                ttl=e["ttl"]) for k, e in entries.items()},
            promoted_port=promoted.port,
            promoted_fence_epoch=promoted.fence_epoch,
            num_updates=s["num_updates"],
            num_updates_max=s["num_updates_max"],
            per_shard_num_updates=[p["num_updates"]
                                   for p in s["per_shard"]],
            logical_commits=r["logical_commits"], retries=r["retries"],
            reconnects=r["reconnects"],
            windows=_windows_run(t.history.records),
            assigner=el["assigner"], joined=el["joined"],
            center_is_join=center_equal, logs_replay_equal=replays,
            wal_verify_rc=rc, wal_verify_ok=verify.get("ok"),
            wal_dirs=verify.get("num_wal_dirs"),
            directory_dirs=verify.get("num_directory_dirs"),
            window_ms=(_window_split(probe["windows"], t_join, t_first)
                       if None not in (t_join, t_first) else None),
            window_ms_all=float(np.mean([1e3 * d for _, _, d in
                                         probe["windows"]])),
            window_ms_median=float(np.median([1e3 * d for _, _, d in
                                              probe["windows"]])),
            window_ms_each=sorted(1e3 * d for _, _, d in probe["windows"]),
            windows_by_failover=by_failover,
            directory_window_cost_ms=(
                None if None in (by_failover["outside"]["mean_ms"],
                                 control["windows"]["outside"]["mean_ms"])
                else by_failover["outside"]["mean_ms"]
                - control["windows"]["outside"]["mean_ms"]),
            control=control, launches=launches, exchange_phases=phases,
            phase_wall_s=time.perf_counter() - t_phase)
        log(json.dumps(rec))
        fails += _phase_gates("directory_chaos", t, launches, extra=False)
        if (fs["ps_kills"], fs["directory_kills"], fs["joins"]) != (1, 1, 1):
            fails.append(f"directory_chaos: faults {rec['faults']}, "
                         f"expected one PS kill, one directory kill, one "
                         f"join")
        if fs["directory_drops"] < 1:
            fails.append("directory_chaos: the partition dropped nothing")
        if per[victim_sid]["failovers"] < 1 or not (
                dstats.get("failover") or {}).get("failovers"):
            fails.append(f"directory_chaos: shard failovers "
                         f"{[p['failovers'] for p in per]}, directory "
                         f"{rec['directory_failover']}")
        if not s["num_updates"] == s["num_updates_max"] \
                == r["logical_commits"]:
            fails.append(f"directory_chaos: shard folds "
                         f"{rec['per_shard_num_updates']} against "
                         f"{r['logical_commits']} logical commits")
        if not center_equal:
            fails.append("directory_chaos: the final center is not the "
                         "join of the live shards")
        if not all(replays.values()):
            fails.append(f"directory_chaos: logs replay to their parts "
                         f"{replays}")
        if not (rc == 0 and verify.get("ok")
                and verify.get("num_directory_dirs", 0) >= 1):
            fails.append(f"directory_chaos: wal verify rc {rc}: {tail}")
        if not el["assigner"]["exactly_once"] or el["joined"] != 1:
            fails.append(f"directory_chaos: the ledger {el['assigner']}, "
                         f"{el['joined']} joins")
        if set(entries) != {"shard-00", "shard-01"} or not (
                shard1.get("port") == promoted.port
                and promoted is not victim
                and shard1.get("epoch", 0) >= 1):
            fails.append(f"directory_chaos: final membership "
                         f"{rec['membership']}, the promoted link at port "
                         f"{promoted.port}")
        if counts["lookups"] < PS5_W + 1:
            fails.append(f"directory_chaos: {counts['lookups']} lookups for "
                         f"{PS5_W + 1} clients minted")
        if fails:
            raise AssertionError("; ".join(fails))
        return rec
    finally:
        shutil.rmtree(wal_root, ignore_errors=True)


def train_ps_lstm_ps_directory(torch, train):
    """``ps_config5_ps_directory``: this phase hosts config 5's center over
    PS_SHARDS socket shards (a ``ShardedPSGroup``) and registers them with
    its own ``DirectoryServer``, non-expiring as an unsupervised fleet is;
    a DynSGD trainer that knows only ``ps_directory="host:port"`` trains
    PS5_W workers for one epoch. Gates: every shard's folds equal the
    logical commits; the trainer's returned center equals the join of the
    shards' centers bit for bit; K5/K6/K7 once a step."""
    from distkeras_tpu_torch.directory import DirectoryServer
    from distkeras_tpu_torch.parallel.merge_rules import DynSGDMerge
    from distkeras_tpu_torch.sharding import ShardedPSGroup

    t_phase = time.perf_counter()
    init = _config5_init()
    group = ShardedPSGroup(init, DynSGDMerge(), PS5_W, num_shards=PS_SHARDS,
                           transport="socket")
    dsrv = DirectoryServer(default_ttl=None)
    try:
        group.initialize()
        group.start()
        dsrv.initialize()
        dsrv.start()
        plan = group.plan
        meta = {"num_shards": plan.num_shards, "ring": plan.digest,
                "vnodes": plan.ring.vnodes, "bound": plan.bound}
        for sid, srv in enumerate(group.servers):
            dsrv.publish("ps", f"shard-{sid:02d}", srv.host, srv.port,
                         epoch=srv.fence_epoch, meta=meta, ttl=None)
        t, rows = _config5("socket", epochs=1,
                           ps_directory=f"{dsrv.host}:{dsrv.port}")

        def run():
            t0 = time.perf_counter()
            center = t.train(train.gather(np.arange(rows)))
            return center, time.perf_counter() - t0

        (center, wall), launches = counted(run)
        gs, r = group.stats(), t.resilience_stats_
        joined = plan.join([srv.get_model() for srv in group.servers])
        center_equal = sorted(joined) == sorted(center) and all(
            np.array_equal(center[k].numpy(), joined[k]) for k in center)
        windows = _windows_run(t.history.records)
        rec = dict(
            phase="ps_config5_ps_directory", device=SMI, wall_s=wall,
            num_shards=PS_SHARDS, directory=dsrv.stats(),
            num_updates=gs["num_updates"],
            num_updates_max=gs["num_updates_max"],
            logical_commits=r["logical_commits"], windows=windows,
            center_is_join=center_equal, launches=launches,
            exchange_phases=_phase_summary(t.exchange_phases_),
            phase_wall_s=time.perf_counter() - t_phase)
        log(json.dumps(rec))
        fails = []
        if not gs["num_updates"] == gs["num_updates_max"] \
                == r["logical_commits"] == windows:
            fails.append(f"ps_directory: shard folds {gs['num_updates']}.."
                         f"{gs['num_updates_max']}, {r['logical_commits']} "
                         f"logical commits, {windows} windows")
        if not center_equal:
            fails.append("ps_directory: the trainer's center is not the "
                         "join of the shards'")
        steps = windows * IMDB_WINDOW
        for k in ("fused_adam", "lstm_forward", "lstm_backward"):
            if launches[k] != steps:
                fails.append(f"ps_directory: {k} launched {launches[k]} "
                             f"times, expected {steps}")
        if rec["directory"]["lookups"] < PS5_W:
            fails.append(f"ps_directory: {rec['directory']['lookups']} "
                         f"lookups for {PS5_W} workers")
        if fails:
            raise AssertionError("; ".join(fails))
        return rec
    finally:
        dsrv.stop()
        group.stop()


def serve_router(torch, qmodel):
    """``serve_router_int8``: two ``GenerationServer`` replicas of the int8
    400M config (their own engines and KV caches, the weights shared),
    each registered with ``register_with(ttl=ROUTER_TTL)`` into a
    ``DirectoryServer``, behind ``RoutedGenerationClient(directory=seeds,
    prefix_tokens=ROUTER_PREFIX)``: a warm pass of one prefix's repeats
    (must land on one replica), 6 distinct prefixes (must reach both),
    then ROUTER_REQUESTS concurrent requests with PROMPTS-length tails and
    NEW_TOKENS new tokens each, replica "a" hard-killed ~50 ms after they
    start. Gates: every stream completes; some failover; the streams and
    the same prompts served unrouted by "b" pass ``tie_aware_check``;
    within 3 TTLs "a" leaves the directory and a forced refresh routes
    only to "b"; K1 (decode and prefill) and K2 launch. The launches are
    counted from 0 just before the warm pass and read as the streams
    join, before the unrouted replay and the tie-aware checks."""
    from distkeras_tpu_torch.directory import (
        DirectoryClient,
        DirectoryServer,
        RoutedGenerationClient,
    )
    from distkeras_tpu_torch.serving import (
        GenerationClient,
        GenerationEngine,
        GenerationServer,
    )

    t_phase = time.perf_counter()
    dsrv = DirectoryServer(default_ttl=None)
    dsrv.initialize()
    dsrv.start()
    seeds = [(dsrv.host, dsrv.port)]
    replicas, router, dc = {}, None, None
    try:
        for key in ("a", "b"):
            srv = GenerationServer(GenerationEngine(
                qmodel, max_batch=8, block_size=BLOCK, device=DEVICE),
                poll_interval=0.01)
            srv.start()
            srv.register_with(seeds, key=key, ttl=ROUTER_TTL)
            replicas[key] = srv
        router = RoutedGenerationClient(directory=seeds,
                                        prefix_tokens=ROUTER_PREFIX)
        rng = np.random.default_rng(7)
        prefixes = [rng.integers(0, VOCAB, (ROUTER_PREFIX,)).astype(
            np.int32) for _ in range(6)]

        def tail(n):
            return rng.integers(0, VOCAB, (n,)).astype(np.int32)

        zero_launches()
        for _ in range(2):
            router.generate(np.concatenate([prefixes[0], tail(8)]),
                            max_new_tokens=4)
        before = dict(router.stats()["routed"])
        for _ in range(3):
            router.generate(np.concatenate([prefixes[0], tail(8)]),
                            max_new_tokens=4)
        after = router.stats()["routed"]
        moved = {k: after.get(k, 0) - before.get(k, 0) for k in after}
        for p in prefixes:
            router.generate(np.concatenate([p, tail(8)]), max_new_tokens=4)
        spread = dict(router.stats()["routed"])
        prompts = [np.concatenate([prefixes[i % len(prefixes)],
                                   tail(PROMPTS[i % len(PROMPTS)])])
                   for i in range(ROUTER_REQUESTS)]
        first = [router._route_order(p)[0] for p in prompts]
        results, errors, lat = {}, {}, {}

        def go(i):
            t0 = time.perf_counter()
            try:
                results[i] = router.generate(prompts[i],
                                             max_new_tokens=NEW_TOKENS)
            except Exception as e:  # gated below, after the teardown
                errors[i] = repr(e)
            lat[i] = time.perf_counter() - t0

        dc = DirectoryClient(seeds)
        gone = {}

        def watch(t_kill):
            # from the kill on: when "a"'s entry leaves the directory
            while time.perf_counter() - t_kill < 3 * ROUTER_TTL + 5:
                if all(e["key"] != "a" for e in dc.lookup("serve")):
                    gone["s"] = time.perf_counter() - t_kill
                    return
                time.sleep(0.02)

        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(ROUTER_REQUESTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        time.sleep(0.05)
        t_kill = time.perf_counter()
        replicas["a"]._crash()
        watcher = threading.Thread(target=watch, args=(t_kill,))
        watcher.start()
        for th in threads:
            th.join(600)
        wall = time.perf_counter() - t0
        launches = read_launches()
        watcher.join(3 * ROUTER_TTL + 10)
        gone_s = gone.get("s")
        router.refresh(force=True)
        after_refresh = sorted(router.replicas)
        stats = router.stats()
        unrouted = {}
        c = GenerationClient(replicas["b"].host, replicas["b"].port)
        try:
            for i, p in enumerate(prompts):
                unrouted[i] = c.generate(p, max_new_tokens=NEW_TOKENS)
        finally:
            c.close()
    finally:
        if router is not None:
            router.close()
        if dc is not None:
            dc.close()
        for srv in replicas.values():
            srv.stop(drain=False, timeout=5)
        dsrv.stop()
    n_tok = NEW_TOKENS * len(results)
    replayed = [lat[i] for i in results if first[i] == "a"]
    stayed = [lat[i] for i in results if first[i] != "a"]
    rec = dict(
        phase="serve_router_int8", device=SMI, wall_s=wall,
        tokens=n_tok, tokens_per_s=n_tok / wall, routed=stats["routed"],
        warm_moved=moved, spread=spread, failovers=stats["failovers"],
        first_choice=first, replayed_latency_s=replayed,
        stayed_latency_s=stayed,
        replayed_mean_s=float(np.mean(replayed)) if replayed else None,
        stayed_mean_s=float(np.mean(stayed)) if stayed else None,
        directory_gone_s=gone_s, ttl_s=ROUTER_TTL,
        after_refresh=after_refresh, errors=errors,
        streams_equal_unrouted=sum(
            bool(np.array_equal(results[i], unrouted[i])) for i in results),
        launches=launches, phase_wall_s=time.perf_counter() - t_phase)
    log(json.dumps(rec))
    fails = [f"router: {k} never launched on the routed path: {launches}"
             for k in ("q_matmul", "q_matmul_prefill", "flash_attention")
             if launches[k] < 1]
    if errors or len(results) != ROUTER_REQUESTS:
        fails.append(f"router: streams failed: {errors}")
    if sum(1 for v in moved.values() if v) != 1:
        fails.append(f"router: one prefix's repeats went to {moved}")
    if not all(spread.get(k, 0) > 0 for k in ("a", "b")):
        fails.append(f"router: distinct prefixes reached {spread}")
    if stats["failovers"] < 1:
        fails.append("router: no failover")
    if gone_s is None or gone_s > 3 * ROUTER_TTL:
        fails.append(f"router: 'a' left the directory after {gone_s} s")
    if after_refresh != ["b"]:
        fails.append(f"router: a forced refresh routes to {after_refresh}")
    if fails:
        raise AssertionError("; ".join(fails))
    for i, toks in results.items():
        if toks.shape != (NEW_TOKENS,) or toks.min() < 0 \
                or toks.max() >= VOCAB:
            raise AssertionError(f"router: bad stream {i}: {toks}")
    tie_aware_check(torch, qmodel, prompts, results, "router int8")
    tie_aware_check(torch, qmodel, prompts, unrouted, "router unrouted")
    return rec


def _frontdoor_jobs():
    """serve_frontdoor's requests in submission order, ``(name, prompt,
    submit kwargs)``: the first chat, five chats, the document, two
    realtime requests (FD_* above)."""
    rng = np.random.default_rng(17)

    def toks(n):
        return rng.integers(0, VOCAB, (n,)).astype(np.int32)

    system = toks(FD_SYSTEM)
    first = toks(FD_FIRST)
    jobs = [("chat0", np.concatenate([system, first]),
             dict(slo_class="best_effort", tenant="a"))]
    for i, n in enumerate(FD_CHATS):
        tail = toks(n)
        if i in FD_COW:
            tail[:FD_COW_LEN] = first[:FD_COW_LEN]
            tail[FD_COW_LEN] = (first[FD_COW_LEN] + 1) % VOCAB
        jobs.append((f"chat{i + 1}", np.concatenate([system, tail]),
                     dict(slo_class="best_effort", tenant="ab"[i % 2])))
    jobs.append(("doc", toks(FD_DOC),
                 dict(slo_class="best_effort", tenant="doc")))
    for i, n in enumerate(FD_RT):
        jobs.append((f"rt{i}", toks(n),
                     dict(slo_class="realtime", tenant="rt",
                          **(FD_RT_SAMPLING if i else {}))))
    return jobs


def _frontdoor_blocks(jobs) -> int:
    """The pool for serve_frontdoor: every best-effort request's budget,
    the five later chats' 24 shared system blocks counted once, plus the
    scratch block and one block fewer than the first realtime request
    needs."""
    def need(p):
        return math.ceil((len(p) + NEW_TOKENS) / BLOCK)

    shared = FD_SYSTEM // BLOCK
    best = sum(need(p) - (shared if name.startswith("chat")
                          and name != "chat0" else 0)
               for name, p, kw in jobs if kw["slo_class"] == "best_effort")
    rt0 = next(need(p) for name, p, _ in jobs if name == "rt0")
    return 1 + best + rt0 - 1


def _drive_frontdoor(engine, jobs, swap=None):
    """Submit ``jobs`` to ``engine`` on serve_frontdoor's schedule,
    stepping it on this thread: the first chat alone to its first token;
    the five chats, stepped until each decodes; the document, one step;
    the realtime requests, stepped until each has FD_SWAP_AFTER tokens;
    then (``swap``: a callable given the engine) the swap, and the engine
    to idle. Returns ``({name: request}, wall seconds, swap's record)``."""
    reqs, swapped = {}, None

    def submit(name):
        p, kw = next((p, kw) for n, p, kw in jobs if n == name)
        reqs[name] = engine.submit(p, max_new_tokens=NEW_TOKENS, **kw)

    def step_until(names, n):
        while any(len(reqs[x].new_tokens) < n
                  and reqs[x].state in ("queued", "running") for x in names):
            engine.step()

    t0 = time.perf_counter()
    submit("chat0")
    step_until(["chat0"], 1)
    chats = [f"chat{i + 1}" for i in range(len(FD_CHATS))]
    for name in chats:
        submit(name)
    step_until(chats, 1)
    submit("doc")
    engine.step()
    rts = [f"rt{i}" for i in range(len(FD_RT))]
    for name in rts:
        submit(name)
    step_until(rts, FD_SWAP_AFTER)
    if swap is not None:
        swapped = swap(engine)
    engine.run_until_idle()   # every step ends in its host sync
    return reqs, time.perf_counter() - t0, swapped


def _timed_methods(engine, names):
    """Wrap ``engine``'s device programs (each ends in its host sync) in a
    host clock: ``{name: [ms, ...]}``."""
    out = {}
    for name in names:
        fn = getattr(engine, name)
        out[name] = []

        def run(*a, _fn=fn, _sink=out[name], **kw):
            t0 = time.perf_counter()
            r = _fn(*a, **kw)
            _sink.append((time.perf_counter() - t0) * 1e3)
            return r

        setattr(engine, name, run)
    return out


def _ms(vals):
    return dict(steps=len(vals), mean_ms=float(np.mean(vals)) if vals
                else None, p50_ms=float(np.median(vals)) if vals else None)


def serve_frontdoor_run(torch, model, label, swap_weights=None):
    """One front-door run of serve_frontdoor's traffic on ``model``:
    ``GenerationEngine(prefix_cache=True, prefill_chunk=FD_CHUNK,
    admission="slo", max_batch=FD_BATCH, block_size=BLOCK)`` over
    ``_frontdoor_blocks`` blocks, driven by ``_drive_frontdoor``; with
    ``swap_weights`` a refill swap to them (version 2) once the realtime
    requests decode. Gates: every request completes, every stream passes
    ``tie_aware_check`` under the weights of the version it was served
    at, the five later chats' shared system prompt hit the cache
    (``prefix_hit_tokens`` >= 5·FD_SYSTEM), a COW copy, a preemption,
    ``blocks_in_use == prefix_cached_blocks`` before the flush and 0
    after, the swap: the tree and the pool empty when it landed (its
    ``stats()["last_swap"]`` record) and the new ``model_version``; the
    swapped-in streams are judged through ``engine.model``, the module
    the swap built (``model`` keeps its weights). Launches are counted
    over the traffic alone; ``probe_gaps`` follows every tie-aware
    check."""
    from distkeras_tpu_torch.serving import GenerationEngine

    jobs = _frontdoor_jobs()
    engine = GenerationEngine(
        model, max_batch=FD_BATCH, block_size=BLOCK,
        num_blocks=_frontdoor_blocks(jobs), device=DEVICE,
        prefix_cache=True, prefill_chunk=FD_CHUNK, admission="slo",
        model_version=1)
    times = _timed_methods(engine, ("_run_chunks", "_decode_step"))

    def swap(eng):
        eng.swap_params(swap_weights, 2, policy="refill")
        eng.step()            # the swap lands at the top of the step
        return eng.stats()["last_swap"]

    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_launches()
    reqs, wall, swapped = _drive_frontdoor(
        engine, jobs, swap if swap_weights is not None else None)
    launches = read_launches()
    peak = (torch.cuda.max_memory_allocated() / 2**30 if DEVICE == "cuda"
            else None)
    stats = engine.stats()
    cached_before = (stats["blocks_in_use"], stats["prefix_cached_blocks"])
    flushed = engine.flush_prefix_cache()
    blocks_after = engine.stats()["blocks_in_use"]
    n_tok = sum(len(r.new_tokens) for r in reqs.values())
    rec = dict(
        phase=f"serve_frontdoor_{label}", device=SMI, wall_s=wall,
        tokens=n_tok, tokens_per_s=n_tok / wall,
        latency=engine.latency_stats(),
        prefix_hit_rate=stats["prefix_hit_rate"],
        prefix_hit_tokens=stats["prefix_hit_tokens"],
        prefix_prompt_tokens=stats["prefix_prompt_tokens"],
        cow_copies=stats["cow_copies"], preemptions=stats["preemptions"],
        prefills=stats["prefills"], steps=stats["steps"],
        num_blocks=engine.allocator.num_blocks,
        blocks_high_water=stats["blocks_high_water"],
        pool_mib=engine.cache.nbytes / 2**20, peak_allocated_gib=peak,
        chunk=_ms(times["_run_chunks"]), decode=_ms(times["_decode_step"]),
        blocks_before_flush=cached_before, flushed=flushed,
        blocks_after_flush=blocks_after, swap=swapped,
        refilled=stats["refilled"], model_version=stats["model_version"],
        completed=stats["completed"], submitted=stats["submitted"],
        launches=dict(launches, q_matmul_decode=launches["q_matmul"]
                      - launches["q_matmul_prefill"]),
        versions={n: r.model_version for n, r in reqs.items()})
    fails = []
    if not stats["completed"] == stats["submitted"] == len(jobs):
        fails.append(f"completed {stats['completed']} of "
                     f"{stats['submitted']} submitted ({len(jobs)} jobs)")
    if stats["prefix_hit_tokens"] < len(FD_CHATS) * FD_SYSTEM:
        fails.append(f"prefix_hit_tokens {stats['prefix_hit_tokens']} < "
                     f"{len(FD_CHATS) * FD_SYSTEM}")
    if stats["cow_copies"] < 1 or stats["preemptions"] < 1:
        fails.append(f"cow_copies {stats['cow_copies']}, preemptions "
                     f"{stats['preemptions']}")
    if cached_before[0] != cached_before[1] or blocks_after != 0:
        fails.append(f"blocks_in_use / prefix_cached_blocks before the "
                     f"flush {cached_before}, after {blocks_after}")
    if swap_weights is not None and not (
            swapped["version"] == 2 and stats["model_version"] == 2
            and swapped["prefix_cached_blocks"] == 0
            and swapped["blocks_in_use"] == 0 and swapped["refilled"] >= 1):
        fails.append(f"the swap: {swapped}, after the run version "
                     f"{stats['model_version']}")
    if model.quant and (rec["launches"]["q_matmul_prefill"] < 1
                        or rec["launches"]["q_matmul_decode"] < 1):
        fails.append(f"K1 did not launch at prefill and decode: "
                     f"{rec['launches']}")
    log(json.dumps(rec))
    if fails:
        raise AssertionError(f"serve_frontdoor {label}: " + "; ".join(fails))
    # each stream under the weights of the version that served it: the
    # swap's through the module the engine built for them
    probes = []
    for version in sorted({r.model_version for r in reqs.values()}):
        served = model if version == 1 else engine.model
        sel = [(p, kw.get("top_k"), reqs[n].result(0))
               for n, p, kw in jobs if reqs[n].model_version == version]
        args = ([p for p, _, _ in sel], [t for _, _, t in sel])
        top_ks = [k for _, k, _ in sel]
        off = tie_aware_check(torch, served, *args,
                              f"frontdoor {label} v{version}", top_ks=top_ks)
        probes.append(probe_gaps(torch, served, *args, off,
                                 f"frontdoor {label} v{version}", top_ks))
    rec["gap_probe"] = probes
    return rec


def serve_fifo_control(torch, model):
    """serve_frontdoor's control: the same jobs on the same schedule
    through a FIFO engine with the cache off (the default pool), for its
    tokens/s and per-class latency beside the front door's. Information
    only: gated on completion and the tie-aware check."""
    from distkeras_tpu_torch.serving import GenerationEngine

    jobs = _frontdoor_jobs()
    engine = GenerationEngine(model, max_batch=FD_BATCH, block_size=BLOCK,
                              device=DEVICE)
    times = _timed_methods(engine, ("_run_prefills", "_decode_step"))
    reqs, wall, _ = _drive_frontdoor(engine, jobs)
    stats = engine.stats()
    n_tok = sum(len(r.new_tokens) for r in reqs.values())
    rec = dict(phase="serve_fifo_control_int8", device=SMI, wall_s=wall,
               tokens=n_tok, tokens_per_s=n_tok / wall,
               latency=engine.latency_stats(), steps=stats["steps"],
               prefill=_ms(times["_run_prefills"]),
               decode=_ms(times["_decode_step"]))
    log(json.dumps(rec))
    if stats["completed"] != len(jobs) or stats["blocks_in_use"]:
        raise AssertionError(f"FIFO control: {stats}")
    tie_aware_check(torch, model, [p for _, p, _ in jobs],
                    [reqs[n].result(0) for n, _, _ in jobs],
                    "FIFO control int8",
                    top_ks=[kw.get("top_k") for _, _, kw in jobs])
    return rec


def serve_frontdoor(torch, model, qmodel):
    """``serve_frontdoor``: the front door on the served config — the FIFO
    control (int8), the int8 run with a refill swap to the seed-1 int8
    weights, the bf16 run — one JSON line with the three records."""
    from distkeras_tpu_torch.models import quantize_lm, transformer_lm

    t_phase = time.perf_counter()
    control = serve_fifo_control(torch, qmodel)
    other = transformer_lm(
        vocab=VOCAB, maxlen=MAXLEN, dim=DIM, heads=HEADS, depth=DEPTH,
        kv_heads=KV_HEADS, pos_embedding="rope", attn_impl="flash",
        dtype=torch.bfloat16, device=DEVICE, seed=1)
    w1 = quantize_lm(other).state_dict()
    del other
    int8 = serve_frontdoor_run(torch, qmodel, "int8", swap_weights=w1)
    del w1
    bf16 = serve_frontdoor_run(torch, model, "bf16")
    rec = dict(phase="serve_frontdoor", device=SMI,
               phase_wall_s=time.perf_counter() - t_phase,
               int8=int8, bf16=bf16, fifo_control_int8=control)
    log(json.dumps(rec))
    return rec


def _decode_prompts(n, lp, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, (n, lp)) \
        .astype(np.int32)


def _zero_rows():
    from distkeras_tpu_torch.ops import quant

    zero_launches()
    quant.q_matmul.launches_by_rows = {}


def _read_rows():
    """Every launch counter, K1's also by M (``q_matmul_rows``)."""
    from distkeras_tpu_torch.ops import quant

    return dict(read_launches(), q_matmul_rows=dict(sorted(
        quant.q_matmul.launches_by_rows.items())))


def _split_is_tie(torch, model, prompt, a, b, label):
    """Streams ``a`` and ``b`` of one prompt are equal, or first differ at
    a token where each is within two bf16 ulps of the full forward's top
    (``tie_aware_check``'s bound): returns that index, or None when
    equal."""
    diff = np.flatnonzero(np.asarray(a) != np.asarray(b))
    if not diff.size:
        return None
    j = int(diff[0])
    lg = _stream_logits(torch, model, prompt, a[:j + 1])[-1:]
    gaps = [_ulp_gaps(torch, lg, t[j:j + 1], 1)[0].item() for t in (a, b)]
    if max(gaps) > 2.0:
        raise AssertionError(
            f"{label}: the streams split at token {j} ({a[j]} / {b[j]}), "
            f"{gaps} ulp below the full forward's top, beyond 2")
    return j


def _splits(torch, model, prompts, got, want, label):
    return [_split_is_tie(torch, model, p, g, w, label)
            for p, g, w in zip(prompts, got, want)]


def _engine_streams(model, prompts, max_new, **kw):
    """Greedy streams of ``prompts`` through a FIFO engine of 8 rows,
    stepped on this thread."""
    from distkeras_tpu_torch.serving import GenerationEngine

    engine = GenerationEngine(model, max_batch=8, block_size=BLOCK,
                              device=DEVICE, **kw)
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    engine.run_until_idle()
    return [r.result(0) for r in reqs], engine.stats()


def _timed(torch, fn):
    """``fn()`` under the launch counters, its host wall time ending in a
    device sync: ``(result, seconds, launches)``."""
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    _zero_rows()
    t0 = time.perf_counter()
    out = fn()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _read_rows()


def _log_probs(torch, model, prompt, toks):
    """Each token's f32 log-probability under one full forward over
    prompt + toks, and each row's bf16 ulp at its max logit."""
    lg = _stream_logits(torch, model, prompt, toks)
    lp = torch.log_softmax(lg, dim=-1)
    idx = torch.from_numpy(np.asarray(toks, np.int64)).to(lg.device)
    _, ulp = _ulp_gaps(torch, lg, np.asarray(toks), 1)
    return lp.gather(1, idx[:, None])[:, 0], ulp


def decode_dense_runs(torch, model, qmodel):
    """serve_decode's dense-cache runs on DECODE_B prompts of DECODE_LP
    tokens, NEW_TOKENS new: greedy ``generate`` int8 and bf16 (each held
    to the engine's streams of the same prompts, split only at a tie, and
    tie-aware); sampled bf16 at top_k=DECODE_TOP_K twice (equal per seed,
    every token in the top k); ``beam_search`` beams=BEAMS on int8 (beams
    1 equal to greedy up to a tie; scores best first, the best beam's
    score its full-forward log-prob within BEAM_TOL_ULP ulps a token,
    greedy's log-prob beside it); greedy
    ``speculative_generate`` at K=SPEC_K, the bf16 target with the int8
    twin as its draft and the int8 model as its own draft, tie-aware.
    Returns one record a run."""
    from distkeras_tpu_torch.models import (
        beam_search,
        generate,
        speculative_generate,
    )

    prompts = _decode_prompts(DECODE_B, DECODE_LP, 23)
    plist = list(prompts)
    n_tok = DECODE_B * NEW_TOKENS
    recs, greedy = {}, {}

    def rec(name, wall, launches, **extra):
        recs[name] = dict(wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall,
                          launches=launches, **extra)
        log(f"serve_decode {name}: " + json.dumps(recs[name]))

    for label, m in (("int8", qmodel), ("bf16", model)):
        out, wall, launches = _timed(torch, lambda m=m: generate(
            m, prompts, NEW_TOKENS))
        new = out[:, DECODE_LP:]
        greedy[label] = new
        eng, _ = _engine_streams(m, plist, NEW_TOKENS)
        splits = _splits(torch, m, plist, new, eng, f"generate {label} vs "
                         f"the engine")
        off = tie_aware_check(torch, m, plist, list(new),
                              f"generate {label}")
        rec(f"generate_{label}", wall, launches, engine_splits=splits,
            off_top=len(off))
    kw = dict(temperature=0.8, top_k=DECODE_TOP_K, seed=5)
    out, wall, launches = _timed(torch, lambda: generate(
        model, prompts, NEW_TOKENS, **kw))
    again = generate(model, prompts, NEW_TOKENS, **kw)
    if not np.array_equal(out, again):
        raise AssertionError("sampled generate: one seed, two streams")
    off = tie_aware_check(torch, model, plist, list(out[:, DECODE_LP:]),
                          "generate bf16 sampled",
                          top_ks=[DECODE_TOP_K] * DECODE_B)
    rec("generate_bf16_sampled", wall, launches, same_seed_equal=True,
        off_top=len(off))

    (toks, scores), wall, launches = _timed(torch, lambda: beam_search(
        qmodel, prompts, NEW_TOKENS, beams=BEAMS))
    one, _ = beam_search(qmodel, prompts, NEW_TOKENS, beams=1)
    splits = _splits(torch, qmodel, plist, one[:, 0, DECODE_LP:],
                     greedy["int8"], "beams=1 vs greedy")
    if not np.all(np.diff(scores, axis=1) <= 0):
        raise AssertionError(f"beam_search: scores not best first {scores}")
    margins = []
    for i, p in enumerate(plist):
        lb, ulp = _log_probs(torch, qmodel, p, toks[i, 0, DECODE_LP:])
        lg_, _ = _log_probs(torch, qmodel, p, greedy["int8"][i])
        tol = BEAM_TOL_ULP * ulp.sum().item()
        margins.append(dict(beam_full=lb.sum().item(),
                            beam_score=float(scores[i, 0]),
                            greedy_full=lg_.sum().item(), tol=tol))
        if abs(lb.sum().item() - scores[i, 0]) > tol:
            raise AssertionError(
                f"beam_search row {i}: the best beam's score "
                f"{scores[i, 0]} is not its full-forward log-prob "
                f"{lb.sum().item()} within {tol}")
    rec("beam_search_int8", wall, launches, beams=BEAMS,
        beams1_splits=splits, log_probs=margins,
        scores=scores[:, 0].tolist())

    for label, target, draft in (("bf16_int8_draft", model, qmodel),
                                 ("int8_self_draft", qmodel, qmodel)):
        (out, stats), wall, launches = _timed(
            torch, lambda t=target, d=draft: speculative_generate(
                t, d, prompts, NEW_TOKENS, spec_tokens=SPEC_K))
        new = out[:, DECODE_LP:]
        off = tie_aware_check(torch, target, plist, list(new),
                              f"speculative_generate {label}")
        base = greedy["bf16" if target is model else "int8"]
        splits = _splits(torch, target, plist, new, base,
                         f"speculative {label} vs generate")
        rec(f"speculative_{label}", wall, launches, stats=stats,
            generate_splits=splits, off_top=len(off))
    return recs


def decode_engine_runs(torch, model, qmodel, plain):
    """serve_decode's speculative serving: ``serve``'s traffic (PROMPTS,
    NEW_TOKENS, 4 clients, 8 rows) through an engine with ``draft=`` at
    K=SPEC_K, the int8 model drafting itself (acceptance gated at
    SPEC_SELF_FLOOR) and the bf16 model with the int8 twin as draft;
    streams tie-aware, the pool empty after, tokens/s beside the plain
    ``serve`` runs' (``plain``: label → its record)."""
    recs = {}
    for label, target, draft in (("int8_self_draft", qmodel, qmodel),
                                 ("bf16_int8_draft", model, qmodel)):
        (prompts, res, wall, stats), _, launches = _timed(
            torch, lambda t=target, d=draft: serve(
                torch, t, f"speculative {label}", draft=d))
        off = tie_aware_check(torch, target, prompts, res,
                              f"speculative serving {label}")
        base = plain["int8" if target is qmodel else "bf16"]
        recs[label] = dict(
            wall_s=wall, tokens_per_s=NEW_TOKENS * len(prompts) / wall,
            plain_tokens_per_s=base["tokens_per_s"],
            spec_rounds=stats["spec_rounds"],
            spec_proposed=stats["spec_proposed"],
            spec_accepted=stats["spec_accepted"],
            spec_acceptance=stats["spec_acceptance"],
            steps=stats["steps"], plain_steps=base["steps"],
            blocks_in_use=stats["blocks_in_use"], off_top=len(off),
            launches=launches)
        log(f"serve_decode engine {label}: " + json.dumps(recs[label]))
    if recs["int8_self_draft"]["spec_acceptance"] < SPEC_SELF_FLOOR:
        raise AssertionError(
            f"int8 self-draft acceptance "
            f"{recs['int8_self_draft']['spec_acceptance']} < "
            f"{SPEC_SELF_FLOOR}")
    return recs


def decode_resilient_run(torch, qmodel):
    """One int8 request of RESILIENT_NEW tokens through a
    ``ResilientGenerationClient`` while its server is crashed
    (``GenerationServer._crash``) mid-stream and a new server is started
    on the same port: the stream completes, equal to the uncrashed one,
    after at least one reconnect."""
    from distkeras_tpu_torch.resilience.retry import RetryPolicy
    from distkeras_tpu_torch.serving import (
        GenerationClient,
        GenerationEngine,
        GenerationServer,
        ResilientGenerationClient,
    )

    prompt = _decode_prompts(1, DECODE_LP, 29)[0]
    (want,), _ = _engine_streams(qmodel, [prompt], RESILIENT_NEW)

    def server(port=0):
        srv = GenerationServer(GenerationEngine(
            qmodel, max_batch=8, block_size=BLOCK, device=DEVICE),
            port=port, poll_interval=0.01)
        srv.start()
        return srv

    first = server()
    port, second = first.port, None
    client = ResilientGenerationClient(
        lambda: GenerationClient("127.0.0.1", port, connect_timeout=2.0),
        RetryPolicy(max_attempts=100, base_delay=0.02, max_delay=0.2,
                    deadline=60.0, seed=0))
    out, errors = {}, []

    def call():
        try:
            out["tokens"] = client.generate(prompt,
                                            max_new_tokens=RESILIENT_NEW)
        except Exception as e:  # re-raised below
            errors.append(repr(e))

    th = threading.Thread(target=call)
    try:
        t0 = time.perf_counter()
        th.start()
        deadline = time.monotonic() + 60
        while first.engine.stats()["steps"] < RESILIENT_CRASH_AT:
            if time.monotonic() > deadline:
                raise AssertionError("resilient run: the request never "
                                     "reached its crash step")
            time.sleep(0.001)
        first._crash()
        t_crash = time.perf_counter()
        second = server(port)
        th.join(120)
        t_done = time.perf_counter()
        if th.is_alive() or errors:
            raise AssertionError(f"resilient run: {errors or 'hung'}")
        rec = dict(wall_s=t_done - t0, crash_to_done_s=t_done - t_crash,
                   retries=client.retries, reconnects=client.reconnects,
                   equal=bool(np.array_equal(out["tokens"], want)),
                   completed_on_restart=second.stats()["completed"])
    finally:
        client.close()
        first.stop(drain=False, timeout=5)
        if second is not None:
            second.stop(drain=False, timeout=10)
        th.join(10)
    log("serve_decode resilient int8: " + json.dumps(rec))
    if not rec["equal"] or rec["reconnects"] < 1:
        raise AssertionError(f"resilient run: {rec}")
    return rec


def decode_predictor_runs(torch, qmodel):
    """``GeneratorPredictor`` over PRED_N prompts of PRED_LP tokens in one
    chunk, greedy and beams=2, equal to ``generate`` and ``beam_search``
    on the same prompts row for row."""
    from distkeras_tpu_torch.data import Dataset
    from distkeras_tpu_torch.models import beam_search, generate
    from distkeras_tpu_torch.predictors import GeneratorPredictor

    prompts = _decode_prompts(PRED_N, PRED_LP, 31)
    ds = Dataset({"features": prompts})
    recs = {}
    for beams in (1, 2):
        pred = GeneratorPredictor(qmodel, max_new_tokens=PRED_NEW,
                                  batch_size=PRED_N, beams=beams)
        got, wall, launches = _timed(
            torch, lambda p=pred: p.predict(ds)["generated"])
        if beams == 1:
            want = generate(qmodel, prompts, PRED_NEW)[:, PRED_LP:]
        else:
            want = beam_search(qmodel, prompts, PRED_NEW,
                               beams=beams)[0][:, 0, PRED_LP:]
        recs[f"beams{beams}"] = dict(
            wall_s=wall, rows=PRED_N,
            equal=bool(np.array_equal(got, want)), launches=launches)
        log(f"serve_decode GeneratorPredictor beams={beams}: "
            + json.dumps(recs[f"beams{beams}"]))
        if not recs[f"beams{beams}"]["equal"]:
            raise AssertionError(f"GeneratorPredictor beams={beams} "
                                 f"differs from its decoding function")
    return recs


def serve_decode(torch, model, qmodel, plain):
    """``serve_decode``: decoding beyond the paged engine on the served
    config — dense-cache ``generate``, ``beam_search`` and
    ``speculative_generate``, the engine with ``draft=`` behind the
    server, ``ResilientGenerationClient`` across a crash and restart, and
    ``GeneratorPredictor``; K1 launched at M = 4, 8, 16, 20 and 40 and
    K2 on the dense prefills. One JSON line with every record."""
    t_phase = time.perf_counter()
    dense = decode_dense_runs(torch, model, qmodel)
    engine = decode_engine_runs(torch, model, qmodel, plain)
    resilient = decode_resilient_run(torch, qmodel)
    predictor = decode_predictor_runs(torch, qmodel)
    runs = {**{f"dense_{k}": v for k, v in dense.items()},
            **{f"engine_{k}": v for k, v in engine.items()},
            **{f"predictor_{k}": v for k, v in predictor.items()}}
    rows: dict = {}
    for r in runs.values():
        for m, n in r["launches"]["q_matmul_rows"].items():
            rows[m] = rows.get(m, 0) + n
    fails = [f"K1 never launched at M={m}" for m in DECODE_ROWS + (8,)
             if DEVICE == "cuda" and not rows.get(m)]
    fails += [f"K2 never launched on {k}" for k, r in dense.items()
              if DEVICE == "cuda" and r["launches"]["flash_attention"] < 1]
    rec = dict(phase="serve_decode", device=SMI,
               phase_wall_s=time.perf_counter() - t_phase,
               dense=dense, engine=engine, resilient=resilient,
               predictor=predictor, q_matmul_rows=dict(sorted(rows.items())))
    log(json.dumps(rec))
    if fails:
        raise AssertionError("serve_decode: " + "; ".join(fails))
    return rec


def serve_quantized_classifier(torch, trainer):
    """``ModelPredictor(quantize=True)`` on the config 6 classifier that
    ``train_classifier`` trained, on CLS_PRED_ROWS fresh rows: against
    its bf16 predictor, argmax agreement gated at CLS_AGREE and the
    largest logit difference; against the float predictor over the int8
    model's own dequantized weights (``q · scale``), the largest logit
    difference gated at CLS_DEQ_TOL of that predictor's logit scale; K1's
    launches (its Dense rows at M = batch · L, the head at the batch)."""
    from distkeras_tpu_torch.predictors import ModelPredictor

    ds = classifier_data(CLS_PRED_ROWS, seed=7)
    kw = dict(features_col=["features", "mask"], batch_size=CLS_PRED_BATCH,
              device=DEVICE)
    params = trainer.trained_params_
    ref = ModelPredictor(trainer.spec, params, trainer.trained_nt_,
                         **kw).predict(ds)["prediction"]
    pred = ModelPredictor(trainer.spec, params, trainer.trained_nt_,
                          quantize=True, **kw)
    got, wall, launches = _timed(torch, lambda: pred.predict(ds)["prediction"])
    int8 = sorted(k[:-len(".kernel_q")] for k in pred.params
                  if k.endswith(".kernel_q"))
    deq_params = dict(params)
    for name in int8:
        w = params[f"{name}.weight"]
        deq_params[f"{name}.weight"] = (
            pred.params[f"{name}.kernel_q"].float()
            * pred.params[f"{name}.scale"][:, None]).to(w.device, w.dtype)
    deq = ModelPredictor(trainer.spec, deq_params, trainer.trained_nt_,
                         **kw).predict(ds)["prediction"]
    agree = float(np.mean(got.argmax(-1) == ref.argmax(-1)))
    deq_err, deq_scale = float(np.abs(got - deq).max()), \
        float(np.abs(deq).max())
    rec = dict(phase="serve_decode_quantized_classifier", device=SMI,
               rows=CLS_PRED_ROWS, wall_s=wall, argmax_agreement=agree,
               max_logit_err=float(np.abs(got - ref).max()),
               logit_scale=float(np.abs(ref).max()),
               max_logit_err_vs_dequantized=deq_err,
               dequantized_logit_scale=deq_scale,
               int8_layers=int8, launches=launches)
    log(json.dumps(rec))
    if (agree < CLS_AGREE or not np.all(np.isfinite(got))
            or not deq_err <= CLS_DEQ_TOL * deq_scale
            or (DEVICE == "cuda" and launches["q_matmul"] < 1)):
        raise AssertionError(f"quantized classifier: {rec}")
    return rec


def run_mnist_twin():
    """The MNIST example's twin (``distkeras_tpu_torch.examples.mnist``)
    in this process, once a MNIST_RUNS entry, held to the JAX example's
    gate (test accuracy > 0.8)."""
    from distkeras_tpu_torch.examples import mnist as twin

    recs = []
    for args in MNIST_RUNS:
        t0 = time.perf_counter()
        acc = twin.main(args + ["--device", DEVICE])
        recs.append(dict(args=args, test_accuracy=acc,
                         wall_s=time.perf_counter() - t0))
        log("mnist twin: " + json.dumps(recs[-1]))
        if not acc > 0.8:
            raise AssertionError(f"mnist twin {args}: test accuracy {acc} "
                                 f"<= 0.8")
    return recs


def _adam_window_parity(torch, spec_fn, rule, batch, n_feat, workers,
                        window, batch_size, lr):
    """One window of ``spec_fn()``'s model through K5 and, from the same
    init on the same superbatch, through its plain version on the card.
    The forward and backward are the same code in both, but a gradient
    may differ by float noise (atomics in a library backward), and Adam
    moves an element by at most ~1.01 lr a step whatever its gradient's
    size, in either direction for a noise-level gradient: ADAG's center
    (the mean of the workers) agrees to 2.02 lr · window; the mean loss
    to 1e-2. Bit-equality is printed."""
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.pallas_kernels import fused_adam
    from distkeras_tpu_torch.parallel import LocalSGDEngine
    from distkeras_tpu_torch.trainers import _make_loss_step

    out = {}
    for impl in ("kernel", "plain"):
        spec = spec_fn()
        engine = LocalSGDEngine(
            spec, _make_loss_step(spec, get_loss(LOSS), n_feat, LOSS),
            fused_adam(lr, impl=impl), rule, device=DEVICE,
            num_workers=workers, window=window, batch_size=batch_size)
        params, nt = spec.init(0)
        state, loss = engine.run_window(engine.init_state(params, nt), batch)
        out[impl] = (engine.center_params(state), loss.item())
        del engine, state
    (ck, lk), (cp, lp) = out["kernel"], out["plain"]
    diff = max(_err(ck[k], cp[k]) for k in ck)
    limit = 2.02 * lr * window
    rec = dict(max_center_diff=diff, limit=limit,
               bit_equal=all(torch.equal(ck[k], cp[k]) for k in ck),
               loss_kernel=lk, loss_plain=lp)
    if not (diff <= limit and abs(lk - lp) <= 1e-2
            and all(torch.isfinite(v).all() for v in ck.values())):
        raise AssertionError(f"window through K5 vs its plain version: "
                             f"{json.dumps(rec)}")
    return rec


def _on_device(tree):
    return {k: v.to(DEVICE) for k, v in tree.items()}


def train_resnet_syncbn(torch):
    """``a10_resnet_adag_syncbn``: ``resnet_small(sync_bn=True)`` (widths
    16/32/64, one block a stage, bf16 convs, f32 BN) under ADAG with fused
    Adam, A10_RESNET_W stacked workers of batch A10_RESNET_BATCH, window
    A10_RESNET_WINDOW, on the synthetic CIFAR-10 stand-in at 32×32×3.
    Gates: one window through K5 equal to its plain version
    (``_adam_window_parity``); every worker's ``bn_stem`` statistics equal
    across W and off their (0, 1) init; the W-worker training forward on
    the trained center equal to the flat model's on the concatenated
    W·batch rows (A10_FWD_TOL); K5 once a step; the eval-mode prediction
    on the center with ``trained_nt_`` finite (its accuracy printed)."""
    from distkeras_tpu_torch.datasets import cifar10
    from distkeras_tpu_torch.models import resnet_small
    from distkeras_tpu_torch.parallel import ADAGMerge
    from distkeras_tpu_torch.trainers import ADAG

    t_phase = time.perf_counter()
    W, B, win = A10_RESNET_W, A10_RESNET_BATCH, A10_RESNET_WINDOW
    train, test = cifar10(n_train=W * win * B * A10_RESNET_WINDOWS,
                          n_test=A10_RESNET_TEST)
    batch = next(train.superbatches(W, B, win, ["features", "label"]))
    parity = _adam_window_parity(
        torch, lambda: resnet_small(sync_bn=True), ADAGMerge(), batch, 1, W,
        win, B, A10_RESNET_LR)
    spec = resnet_small(sync_bn=True)
    t = ADAG(spec, loss=LOSS, worker_optimizer="fused_adam",
             learning_rate=A10_RESNET_LR, num_workers=W, batch_size=B,
             communication_window=win, num_epoch=A10_RESNET_EPOCHS,
             log_metrics=True, device=DEVICE)

    def run():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        center = t.train(train)
        torch.cuda.synchronize()
        return center, time.perf_counter() - t0

    (center, wall), launches = counted(run)
    peak = torch.cuda.max_memory_allocated()
    fails = []
    steps = A10_RESNET_EPOCHS * A10_RESNET_WINDOWS * win
    if launches["fused_adam"] != steps:
        fails.append(f"fused_adam launched {launches['fused_adam']} times, "
                     f"expected {steps} (once a step)")
    losses = t.history.losses()
    if len(losses) != A10_RESNET_EPOCHS * A10_RESNET_WINDOWS \
            or not np.all(np.isfinite(losses)):
        fails.append(f"bad loss history {losses}")
    stats = {k: t.state_.nt[f"bn_stem.{k}"] for k in ("mean", "var")}
    spread = max(_err(v, v[:1].expand_as(v)) for v in stats.values())
    moved = dict(mean=stats["mean"].abs().max().item(),
                 var=(stats["var"] - 1).abs().max().item())
    if spread != 0.0:
        fails.append(f"bn_stem statistics differ across workers by {spread}")
    if min(moved.values()) <= 1e-3:
        fails.append(f"bn_stem statistics did not move off (0, 1): {moved}")
    # the W-worker forward (sync BN over the stacked workers) against the
    # flat model (per-batch BN) on the W·B rows, at the trained center
    params, nt = _on_device(center), _on_device(t.trained_nt_)
    flat = resnet_small()
    x = torch.from_numpy(batch[0][:, 0]).to(DEVICE)
    with torch.no_grad():
        out_w, nt_w = torch.func.vmap(
            lambda xs: spec.apply(params, nt, xs, True))(x)
        out_f, nt_f = flat.apply(params, nt, x.reshape(W * B, *x.shape[2:]),
                                 True)
    fwd_err = _err(out_w.reshape(W * B, -1), out_f)
    fwd_scale = max(1.0, out_f.abs().max().item())
    stat_err = max(_err(nt_w[f"bn_stem.{k}"][0], nt_f[f"bn_stem.{k}"])
                   for k in ("mean", "var"))
    if not fwd_err <= A10_FWD_TOL * fwd_scale or stat_err > 1e-4:
        fails.append(f"W-worker forward off the flat batch's by {fwd_err} "
                     f"(limit {A10_FWD_TOL} x {fwd_scale}), statistics by "
                     f"{stat_err}")
    with torch.no_grad():
        logits, _ = spec.apply(params, nt, torch.from_numpy(
            test["features"]).to(DEVICE), False)
    finite = bool(torch.isfinite(logits).all())
    if not finite or logits.shape != (A10_RESNET_TEST, 10):
        fails.append(f"eval logits {tuple(logits.shape)} finite={finite}")
    acc = float((logits.argmax(-1).cpu().numpy() == test["label"]).mean())
    epochs = [m for m in t.metrics_ if "samples_per_sec" in m]
    rec = dict(
        phase="a10_resnet_adag_syncbn", device=SMI, wall_s=wall,
        workers=W, batch=B, window=win, steps=steps, launches=launches,
        window_parity=parity, bn_stem_worker_spread=spread,
        bn_stem_moved=moved, forward_vs_flat=dict(
            max_abs_err=fwd_err, logit_scale=fwd_scale, limit=A10_FWD_TOL,
            stats_err=stat_err),
        loss_first=losses[0], loss_last=losses[-1], eval_finite=finite,
        eval_accuracy=acc, peak_memory_gb=peak / 1e9,
        epochs=[dict(epoch=m["epoch"], samples_per_sec=m["samples_per_sec"],
                     window_ms=1e3 * m["wall_time"] / A10_RESNET_WINDOWS)
                for m in epochs],
        phase_wall_s=time.perf_counter() - t_phase)
    log(json.dumps(rec))
    if fails:
        raise AssertionError("a10_resnet_adag_syncbn: " + "; ".join(fails))
    return rec


def train_resnet_ps(torch):
    """``a10_resnet_ps``: ``resnet_small()`` with per-worker BN under
    DOWNPOUR through the in-process PS, A10_PS_W threads of batch
    A10_RESNET_BATCH, window A10_RESNET_WINDOW. Gates: ``trained_nt_``
    moved off (0, 1), K5 once a step a worker, and the sync-BN spec
    refused by the same trainer with the "stacked-worker axis" error."""
    from distkeras_tpu_torch.datasets import cifar10
    from distkeras_tpu_torch.models import resnet_small
    from distkeras_tpu_torch.trainers import DOWNPOUR

    t_phase = time.perf_counter()
    B, win = A10_RESNET_BATCH, A10_RESNET_WINDOW
    train, _ = cifar10(n_train=A10_PS_W * A10_PS_WINDOWS * win * B,
                       n_test=16)
    kw = dict(loss=LOSS, worker_optimizer="fused_adam",
              learning_rate=A10_RESNET_LR, num_workers=A10_PS_W,
              batch_size=B, communication_window=win, num_epoch=1,
              backend="ps", ps_transport="inprocess", device=DEVICE)
    t = DOWNPOUR(resnet_small(), **kw)

    def run():
        t0 = time.perf_counter()
        t.train(train)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall, launches = counted(run)
    fails = []
    windows = _windows_run(t.history.records)
    steps = windows * win
    if windows != A10_PS_W * A10_PS_WINDOWS or launches["fused_adam"] != steps:
        fails.append(f"{windows} windows, fused_adam launched "
                     f"{launches['fused_adam']} times, expected {steps} "
                     f"(once a step a worker)")
    nt = t.trained_nt_
    moved = dict(mean=nt["bn_stem.mean"].abs().max().item(),
                 var=(nt["bn_stem.var"] - 1).abs().max().item())
    if min(moved.values()) <= 1e-3:
        fails.append(f"trained_nt_ did not move off (0, 1): {moved}")
    try:
        DOWNPOUR(resnet_small(sync_bn=True), **kw).train(train)
        refused = None
    except ValueError as e:
        refused = str(e)
    if refused is None or "stacked-worker axis" not in refused:
        fails.append(f"sync_bn on backend='ps' was not refused: {refused}")
    rec = dict(phase="a10_resnet_ps", device=SMI, wall_s=wall,
               workers=A10_PS_W, windows=windows, steps=steps,
               launches=launches, bn_stem_moved=moved,
               sync_bn_refused=refused,
               exchange_phases=_phase_summary(t.exchange_phases_),
               phase_wall_s=time.perf_counter() - t_phase)
    log(json.dumps(rec))
    if fails:
        raise AssertionError("a10_resnet_ps: " + "; ".join(fails))
    return rec


def train_sru_dynsgd(torch, train, dynsgd_rec):
    """``a10_sru_dynsgd``: ``sru_classifier()`` at config 5's width (vocab
    20000, maxlen 200, E=H=128, bf16) on config 5's data and trainer
    (DynSGD, IMDB_W workers of batch IMDB_BATCH, window IMDB_WINDOW, fused
    Adam, two epochs of IMDB_WINDOWS windows). Gates: ``assoc`` and
    ``scan`` agree on one f32 batch on the card (the recurrence and the
    logits, A10_SRU_TOL), the loss falls, K5 once a step. Its window ms
    is printed beside config 5's LSTM window from this call
    (``dynsgd_rec``, ``train_dynsgd``'s), not gated."""
    from distkeras_tpu_torch.models import sru_classifier
    from distkeras_tpu_torch.models.sru import sru_recurrence
    from distkeras_tpu_torch.trainers import DynSGD

    t_phase = time.perf_counter()
    cfg = dict(vocab=IMDB_VOCAB, maxlen=IMDB_T, embed_dim=IMDB_E,
               hidden_dim=IMDB_H)
    toks = torch.from_numpy(train["features"][:IMDB_BATCH]).to(DEVICE)
    mask = torch.from_numpy(train["mask"][:IMDB_BATCH]).to(DEVICE)
    f32 = {impl: sru_classifier(dtype=torch.float32, impl=impl, **cfg)
           for impl in ("assoc", "scan")}
    params = _on_device(f32["assoc"].init(0)[0])
    with torch.no_grad():
        # layer 0's gates, as the f32 model computes them
        emb = torch.nn.functional.embedding(toks.long(),
                                            params["Embed_0.weight"])
        gates = torch.nn.functional.linear(emb, params["w_0.weight"],
                                           params["w_0.bias"])
        c_a, _ = sru_recurrence(gates, "assoc")
        c_s, _ = sru_recurrence(gates, "scan")
        logits = {impl: spec.apply(params, {}, (toks, mask), False)[0]
                  for impl, spec in f32.items()}
    c_err = _err(c_a, c_s) / max(1.0, c_s.abs().max().item())
    l_err = _err(logits["assoc"], logits["scan"]) / max(
        1.0, logits["scan"].abs().max().item())
    spec = sru_classifier(**cfg)
    t = DynSGD(spec, loss=LOSS, worker_optimizer="fused_adam",
               learning_rate=IMDB_LR, features_col=["features", "mask"],
               num_workers=IMDB_W, batch_size=IMDB_BATCH,
               communication_window=IMDB_WINDOW, num_epoch=2,
               log_metrics=True, device=DEVICE)

    def run():
        t0 = time.perf_counter()
        t.train(train)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall, launches = counted(run)
    fails = []
    if not (c_err <= A10_SRU_TOL and l_err <= A10_SRU_TOL):
        fails.append(f"assoc vs scan on the card: recurrence {c_err}, "
                     f"logits {l_err} (limit {A10_SRU_TOL})")
    losses = t.history.losses()
    steps = 2 * IMDB_WINDOWS * IMDB_WINDOW
    if len(losses) != 2 * IMDB_WINDOWS or not np.all(np.isfinite(losses)) \
            or not np.mean(losses[-2:]) < np.mean(losses[:2]):
        fails.append(f"the loss did not fall: {losses}")
    if launches["fused_adam"] != steps:
        fails.append(f"fused_adam launched {launches['fused_adam']} times, "
                     f"expected {steps} (once a step)")
    epochs = [m for m in t.metrics_ if "samples_per_sec" in m]
    rec = dict(
        phase="a10_sru_dynsgd", device=SMI, wall_s=wall, steps=steps,
        launches=launches, assoc_vs_scan=dict(
            recurrence_rel_err=c_err, logits_rel_err=l_err,
            limit=A10_SRU_TOL),
        loss_first=losses[0], loss_last=losses[-1],
        epochs=[dict(epoch=m["epoch"], samples_per_sec=m["samples_per_sec"],
                     window_ms=1e3 * m["wall_time"] / IMDB_WINDOWS)
                for m in epochs],
        lstm_config5_epochs=dynsgd_rec["epochs"],
        phase_wall_s=time.perf_counter() - t_phase)
    log(json.dumps(rec))
    if fails:
        raise AssertionError("a10_sru_dynsgd: " + "; ".join(fails))
    return rec


@contextlib.contextmanager
def _dispatch_probe():
    """Record each MoE layer's kept share of its ``T·k`` token-expert
    assignments (``parallel.expert._dispatch_combine``'s dispatch sum)."""
    from distkeras_tpu_torch.parallel import expert

    real, kept = expert._dispatch_combine, []

    def probe(logits, num_experts, capacity, top_k):
        out = real(logits, num_experts, capacity, top_k)
        kept.append(out[0].sum().item() / (logits.shape[0] * top_k))
        return out

    expert._dispatch_combine = probe
    try:
        yield kept
    finally:
        expert._dispatch_combine = real


def train_moe_adag(torch, train):
    """``a10_moe_adag``: ``moe_transformer_classifier()`` at its defaults
    (vocab 20000, maxlen 200, dim 128, 4 heads, depth 2, 8 experts, top-2,
    capacity factor 2.0, bf16 attention, f32 experts) under ADAG with
    fused Adam, A10_MOE_W workers of batch A10_MOE_BATCH, window
    A10_MOE_WINDOW, on config 5's data. Gates: one window through K5
    equal to its plain version, ``moe_aux_loss`` finite, K5 once a step.
    The dropped share of the token-expert slots is printed, at the init
    and at the trained center (the trainer's loss has no aux term, as in
    the JAX package, so nothing keeps the router balanced)."""
    from distkeras_tpu_torch.models import (
        moe_aux_loss,
        moe_transformer_classifier,
    )
    from distkeras_tpu_torch.parallel import ADAGMerge
    from distkeras_tpu_torch.trainers import ADAG

    t_phase = time.perf_counter()
    W, B, win = A10_MOE_W, A10_MOE_BATCH, A10_MOE_WINDOW
    cols = ["features", "mask", "label"]
    ds = train.gather(np.arange(W * win * B * A10_MOE_WINDOWS))
    batch = next(ds.superbatches(W, B, win, cols))
    parity = _adam_window_parity(torch, moe_transformer_classifier,
                                 ADAGMerge(), batch, 2, W, win, B,
                                 A10_MOE_LR)
    spec = moe_transformer_classifier()
    t = ADAG(spec, loss=LOSS, worker_optimizer="fused_adam",
             learning_rate=A10_MOE_LR, features_col=["features", "mask"],
             num_workers=W, batch_size=B, communication_window=win,
             num_epoch=1, log_metrics=True, device=DEVICE)

    def run():
        t0 = time.perf_counter()
        center = t.train(ds)
        torch.cuda.synchronize()
        return center, time.perf_counter() - t0

    (center, wall), launches = counted(run)
    fails = []
    steps = A10_MOE_WINDOWS * win
    losses = t.history.losses()
    if launches["fused_adam"] != steps:
        fails.append(f"fused_adam launched {launches['fused_adam']} times, "
                     f"expected {steps} (once a step)")
    if len(losses) != A10_MOE_WINDOWS or not np.all(np.isfinite(losses)):
        fails.append(f"bad loss history {losses}")
    toks = torch.from_numpy(ds["features"][:B]).to(DEVICE)
    mask = torch.from_numpy(ds["mask"][:B]).to(DEVICE)
    module = spec.module.to(DEVICE)
    try:
        with torch.no_grad(), _dispatch_probe() as kept_init:
            moe_aux_loss(module, _on_device(spec.init(0)[0]), (toks, mask))
        with torch.no_grad(), _dispatch_probe() as kept:
            logits, aux = moe_aux_loss(module, _on_device(center),
                                       (toks, mask))
    finally:
        spec.module.to("cpu")
    aux = aux.item()
    if not (np.isfinite(aux) and torch.isfinite(logits).all()):
        fails.append(f"moe_aux_loss {aux} or its logits not finite")
    epochs = [m for m in t.metrics_ if "samples_per_sec" in m]
    rec = dict(
        phase="a10_moe_adag", device=SMI, wall_s=wall, workers=W, batch=B,
        window=win, steps=steps, launches=launches, window_parity=parity,
        aux_loss=aux, dropped_slot_share=[1.0 - k for k in kept],
        dropped_slot_share_init=[1.0 - k for k in kept_init],
        tokens_per_layer=B * IMDB_T, loss_first=losses[0],
        loss_last=losses[-1],
        epochs=[dict(epoch=m["epoch"], samples_per_sec=m["samples_per_sec"],
                     window_ms=1e3 * m["wall_time"] / A10_MOE_WINDOWS)
                for m in epochs],
        phase_wall_s=time.perf_counter() - t_phase)
    log(json.dumps(rec))
    if fails:
        raise AssertionError("a10_moe_adag: " + "; ".join(fails))
    return rec


def compare_lm_remat(torch):
    """``a10_config9_remat``: config 9's spec (``lm_spec`` as ``train_lm``
    builds it) for two ADAG windows with fused Adam, without and then with
    ``remat=True``, from the same init on the same superbatch; the second
    window of each is timed and counted. Gates: the centers within
    ``compare_lm_window``'s bound over two windows (bit-equality
    printed), the peak of ``torch.cuda.max_memory_allocated`` (reset
    before the second window) lower with remat, K2 launched exactly twice
    as often with remat (the recompute), K3, K4 and K5 as often. Returns
    the record; its ``launches`` are the remat window's."""
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.pallas_kernels import fused_adam
    from distkeras_tpu_torch.parallel import ADAGMerge, LocalSGDEngine
    from distkeras_tpu_torch.trainers import _make_loss_step

    t_phase = time.perf_counter()
    toks = lm_tokens(LM_W * LM_WINDOW * LM_BATCH, seed=2).reshape(
        LM_W, LM_WINDOW, LM_BATCH, LM_L + 1)
    batch = (toks[..., :-1], toks[..., 1:])
    runs = {}
    for remat in (False, True):
        spec = lm_spec(torch, LM_DEPTH, "flash", remat=remat)
        engine = LocalSGDEngine(
            spec, _make_loss_step(spec, get_loss(LOSS), 1, LOSS),
            fused_adam(LM_LR), ADAGMerge(), device=DEVICE,
            num_workers=LM_W, window=LM_WINDOW, batch_size=LM_BATCH)
        params, nt = spec.init(0)
        state = engine.init_state(params, nt)
        placed = engine.place_batch(batch)
        # a first window warms the libraries and the allocator up: the
        # second, on the same superbatch, is the one timed and counted
        state, _ = engine.run_window(state, placed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        state, loss = engine.run_window(state, placed)
        loss = loss.item()
        wall = time.perf_counter() - t0
        launches = read_launches()
        runs[remat] = dict(center=engine.center_params(state), loss=loss,
                           launches=launches, wall_s=wall,
                           peak_bytes=torch.cuda.max_memory_allocated())
        del engine, state, placed
        torch.cuda.empty_cache()
    a, b = runs[False], runs[True]
    diff = max(_err(a["center"][k], b["center"][k]) for k in a["center"])
    limit = 2.02 * LM_LR * LM_WINDOW * 2       # two windows
    bit_equal = all(torch.equal(a["center"][k], b["center"][k])
                    for k in a["center"])
    la, lb = a["launches"], b["launches"]
    fails = []
    if not (diff <= limit and abs(a["loss"] - b["loss"]) <= 1e-2):
        fails.append(f"centers {diff} apart (limit {limit}), loss "
                     f"{a['loss']} vs {b['loss']}")
    if not b["peak_bytes"] < a["peak_bytes"]:
        fails.append(f"peak memory {b['peak_bytes']} with remat, "
                     f"{a['peak_bytes']} without")
    if not (la["flash_attention"] > 0
            and lb["flash_attention"] == 2 * la["flash_attention"]):
        fails.append(f"flash_attention launched {lb['flash_attention']} "
                     f"times with remat, {la['flash_attention']} without")
    for k in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv",
              "fused_adam"):
        if not (la[k] > 0 and lb[k] == la[k]):
            fails.append(f"{k} launched {lb[k]} times with remat, {la[k]} "
                         f"without")
    rec = dict(
        phase="a10_config9_remat", device=SMI, depth=LM_DEPTH,
        workers=LM_W, batch=LM_BATCH, window=LM_WINDOW,
        launches=lb, launches_no_remat=la, max_center_diff=diff,
        limit=limit, bit_equal=bit_equal, loss=a["loss"],
        loss_remat=b["loss"], peak_memory_gb=a["peak_bytes"] / 1e9,
        peak_memory_gb_remat=b["peak_bytes"] / 1e9,
        window_ms=1e3 * a["wall_s"], window_ms_remat=1e3 * b["wall_s"],
        phase_wall_s=time.perf_counter() - t_phase)
    log(json.dumps(rec))
    if fails:
        raise AssertionError("a10_config9_remat: " + "; ".join(fails))
    return rec


def run_a10(torch, train, dynsgd_rec) -> dict:
    """The model families' phases in order, each counting its own
    launches: ``{phase: record}``."""
    out = {}
    for name, fn in (
            ("a10_resnet_adag_syncbn", lambda: train_resnet_syncbn(torch)),
            ("a10_resnet_ps", lambda: train_resnet_ps(torch)),
            ("a10_sru_dynsgd",
             lambda: train_sru_dynsgd(torch, train, dynsgd_rec)),
            ("a10_moe_adag", lambda: train_moe_adag(torch, train)),
            ("a10_config9_remat", lambda: compare_lm_remat(torch))):
        out[name] = fn()
        torch.cuda.empty_cache()
    return out


def _world_of_one(torch):
    """The NCCL world of one a phase runs its meshes in (on the card; gloo
    on the CPU), made with an explicit device and destroyed by the
    caller's ``close()`` at the phase's end."""
    from distkeras_tpu_torch.parallel.mesh import Mesh

    return Mesh({"dp": 1}, device=DEVICE)


def _mesh_trainer(torch, spec, mesh_shape, optimizer, lr, batch, epochs,
                  **kw):
    from distkeras_tpu_torch.trainers import MeshTrainer

    return MeshTrainer(spec, loss=LOSS, worker_optimizer=optimizer,
                       learning_rate=lr, mesh_shape=mesh_shape,
                       batch_size=batch, num_epoch=epochs, device=DEVICE,
                       **kw)


def _hand_steps(torch, spec, batches, lr, n_feat, optimizer="fused_adam"):
    """The hand-written single-device step: ``spec``'s loss step (the
    fused loss where the spec has one) by plain autograd from
    ``spec.init(0)``, then ``optimizer`` (fused Adam: K5), over
    ``batches`` in order. Returns the params on the card."""
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.trainers import _make_loss_step, resolve_optimizer

    step = _make_loss_step(spec, get_loss(LOSS), n_feat, LOSS)
    opt = resolve_optimizer(optimizer, lr)
    p0, nt = spec.init(0)
    params = {k: v.to(DEVICE).requires_grad_(True) for k, v in p0.items()}
    nt = {k: v.to(DEVICE) for k, v in nt.items()}
    state = opt.init({k: v.detach() for k, v in params.items()})
    for b in batches:
        b = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
                  for a in b)
        loss, _ = step(params, nt, b)
        loss.backward()
        grads = {k: v.grad for k, v in params.items()}
        with torch.no_grad():
            upd, state = opt.update(grads, state, params)
            for k, v in params.items():
                v.add_(upd[k].to(v.dtype))
                v.grad = None
    return {k: v.detach() for k, v in params.items()}


def _max_diff(torch, a: dict, b: dict) -> tuple[float, bool]:
    diff = max(_err(a[k].to(DEVICE), b[k].to(DEVICE)) for k in a)
    return diff, all(torch.equal(a[k].to(DEVICE), b[k].to(DEVICE))
                     for k in a)


def _update_gap(torch, p0: dict, ref: dict, got: dict) -> dict:
    """How far ``got``'s update from ``p0`` lies from ``ref``'s, relative
    to ``ref``'s: ``|got - ref| / |ref - p0|`` (2-norms), the largest over
    the leaves (``leaf_max``, with its ``leaf``) and over all of them at
    once (``all``). Under SGD the gap is the gradient's relative error:
    a gradient scaled by 2 gives 1, a sign flipped gives 2."""
    worst, name, num, den = 0.0, None, 0.0, 0.0
    for k in ref:
        r, g, z = (t[k].to(DEVICE, torch.float64) for t in (ref, got, p0))
        n, d = float(torch.sum((g - r) ** 2)), float(torch.sum((r - z) ** 2))
        gap = (n / d) ** 0.5 if d > 0 else (0.0 if n == 0 else float("inf"))
        if gap >= worst:
            worst, name = gap, k
        num, den = num + n, den + d
    return dict(leaf_max=worst, leaf=name, all=(num / den) ** 0.5)


def _two_step_parity(torch, spec, ds, mesh_shape, n_feat, lr, optimizer,
                     **kw):
    """Two steps of ``MeshTrainer`` (``optimizer``, unshuffled, resident)
    against :func:`_hand_steps` over the same two batches. Under fused
    Adam (config 9's trainer and kernels on both sides) the params must
    be equal bit for bit: Adam moves an element ~lr a step whatever its
    gradient's error, so no looser bound catches a wrong gradient. Under
    SGD the update's relative gap (:func:`_update_gap`) must stay within
    A12_SGD_GAP."""
    feats = ["features", "mask"][:n_feat]
    B = A12_BATCH
    rows = ds.gather(np.arange(2 * B))
    t = _mesh_trainer(torch, spec, mesh_shape, optimizer, lr, B, 1,
                      input_mode="resident", features_col=feats, **kw)
    got = t.train(rows)
    names = feats + ["label"]
    hand = _hand_steps(torch, spec, [tuple(rows[c][i * B:(i + 1) * B]
                                           for c in names)
                                     for i in range(2)], lr, n_feat,
                       optimizer)
    diff, bit_equal = _max_diff(torch, got, hand)
    rec = dict(optimizer=optimizer, max_param_diff=diff,
               bit_equal=bit_equal, ok=bit_equal)
    if optimizer == "sgd":
        gap = _update_gap(torch, spec.init(0)[0], hand, got)
        rec.update(update_gap=gap, limit=A12_SGD_GAP,
                   ok=bool(gap["leaf_max"] <= A12_SGD_GAP))
    return rec


def _epoch_losses(t, steps):
    losses = t.history.losses()
    return [float(np.mean(losses[i * steps:(i + 1) * steps]))
            for i in range(len(losses) // steps)], losses


def train_a12_config9(torch):
    """``a12_config9_mesh``: config 9 (``lm_spec`` at full width and depth:
    flash, RoPE, fused CE in chunks of 512, bf16 compute, f32 params)
    through ``MeshTrainer(mesh_shape={"dp": 1}, input_mode="resident",
    worker_optimizer="fused_adam")``, 2 epochs of A12_LM_STEPS steps of
    batch A12_BATCH, in an NCCL world of one. Gates: the loss finite and
    its second epoch below the first (the epochs walk the same rows); K2,
    K3, K4 launched depth × steps times and K5 steps times; two steps
    equal ``_hand_steps`` bit for bit. Prints tokens/s (epoch 1)
    and the step's peak memory beside the ADAG W=2 window's peak
    (ADAG_W2_WINDOW_PEAK_GB)."""
    from distkeras_tpu_torch.data import next_token_dataset

    t_phase = time.perf_counter()
    world = _world_of_one(torch)
    try:
        spec = lm_spec(torch, LM_DEPTH, "flash")
        ds = next_token_dataset(lm_tokens(A12_LM_STEPS * A12_BATCH,
                                          seed=3))
        parity = _two_step_parity(torch, spec, ds, {"dp": 1}, 1, LM_LR,
                                  "fused_adam")
        torch.cuda.empty_cache()
        t = _mesh_trainer(torch, spec, {"dp": 1}, "fused_adam", LM_LR,
                          A12_BATCH, 2, input_mode="resident",
                          log_metrics=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def run():
            t0 = time.perf_counter()
            t.train(ds)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        wall, launches = counted(run)
        peak = torch.cuda.max_memory_allocated()
        steps = 2 * A12_LM_STEPS
        by_epoch, losses = _epoch_losses(t, A12_LM_STEPS)
        epochs = [m for m in t.metrics_ if "samples_per_sec" in m]
        rec = dict(
            phase="a12_config9_mesh", device=SMI, wall_s=wall,
            mesh={"dp": 1}, batch=A12_BATCH, steps=steps, launches=launches,
            losses=losses, epoch_losses=by_epoch,
            tokens_per_s_epoch1=epochs[1]["samples_per_sec"] * LM_L,
            step_ms_epoch1=1e3 * epochs[1]["wall_time"] / A12_LM_STEPS,
            peak_memory_gb=peak / 1e9,
            adag_w2_window_peak_gb=ADAG_W2_WINDOW_PEAK_GB,
            parity=parity, phase_wall_s=time.perf_counter() - t_phase)
        log(json.dumps(rec))
        fails = _a12_gates(launches, steps, LM_DEPTH, by_epoch, losses,
                           parity, flash=True)
        if fails:
            raise AssertionError("a12_config9_mesh: " + "; ".join(fails))
        return rec
    finally:
        world.close()
        torch.cuda.empty_cache()


def _a12_gates(launches, steps, depth, by_epoch, losses, parity,
               flash=True, adam=True):
    fails = []
    if not (np.all(np.isfinite(losses)) and len(by_epoch) == 2
            and by_epoch[1] < by_epoch[0]):
        fails.append(f"the loss is not finite or did not fall: epochs "
                     f"{by_epoch}")
    if flash:
        for k in ("flash_attention", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv"):
            if launches[k] != depth * steps:
                fails.append(f"{k} launched {launches[k]} times, expected "
                             f"{depth * steps} (depth × steps)")
    if adam and launches["fused_adam"] != steps:
        fails.append(f"fused_adam launched {launches['fused_adam']} times, "
                     f"expected {steps}")
    if not parity["ok"]:
        fails.append(f"two steps differ from the hand-written step: "
                     f"{parity}")
    return fails


def train_a12_config6(torch):
    """``a12_config6_mesh``: config 6's classifier at full width (flash,
    key mask, D=64) through ``MeshTrainer(parameter_sharding=
    "fsdp+megatron", mesh_shape={"dp": 1, "tp": 1},
    input_mode="resident")`` with SGD at bench.py's rate (CLS_LR), 2
    epochs of A12_CLS_STEPS steps, checkpointing each epoch to a ``.dkc``.
    Gates: the loss finite and falling (epoch means), K2/K3/K4 depth ×
    steps; two SGD steps' update within A12_SGD_GAP of the hand-written
    step's; a run of epoch 0 alone, then a resume for epoch 1 from its
    ``.dkc``, ends bit-equal to the uninterrupted run."""
    from distkeras_tpu_torch.models import transformer_classifier

    t_phase = time.perf_counter()
    world = _world_of_one(torch)
    ck = tempfile.mkdtemp(prefix="dk-a12-ck-")
    try:
        spec = transformer_classifier(
            vocab=CLS_VOCAB, maxlen=CLS_L, dim=CLS_DIM, heads=CLS_HEADS,
            depth=CLS_DEPTH, dtype=torch.bfloat16, attn_impl="flash")
        ds = classifier_data(A12_CLS_STEPS * A12_BATCH, seed=4)
        kw = dict(parameter_sharding="fsdp+megatron",
                  features_col=["features", "mask"])
        shape = {"dp": 1, "tp": 1}
        parity = _two_step_parity(torch, spec, ds, shape, 2, CLS_LR, "sgd",
                                  parameter_sharding="fsdp+megatron")
        t = _mesh_trainer(torch, spec, shape, "sgd", CLS_LR, A12_BATCH,
                          2, input_mode="resident", log_metrics=True,
                          **kw)

        def run():
            t0 = time.perf_counter()
            out = t.train(ds)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        (full, wall), launches = counted(run)
        first = _mesh_trainer(torch, spec, shape, "sgd", CLS_LR,
                              A12_BATCH, 1, input_mode="resident",
                              checkpoint_dir=ck, **kw)
        first.train(ds)
        files = sorted(os.listdir(ck))
        resumed = _mesh_trainer(torch, spec, shape, "sgd", CLS_LR,
                                A12_BATCH, 2, input_mode="resident",
                                checkpoint_dir=ck, resume=True, **kw)
        back = resumed.train(ds)
        resume_diff, resume_equal = _max_diff(torch, back, full)
        steps = 2 * A12_CLS_STEPS
        by_epoch, losses = _epoch_losses(t, A12_CLS_STEPS)
        epochs = [m for m in t.metrics_ if "samples_per_sec" in m]
        rec = dict(
            phase="a12_config6_mesh", device=SMI, wall_s=wall, mesh=shape,
            parameter_sharding="fsdp+megatron", batch=A12_BATCH,
            steps=steps, lr=CLS_LR, launches=launches, losses=losses,
            epoch_losses=by_epoch,
            samples_per_s_epoch1=epochs[1]["samples_per_sec"],
            step_ms_epoch1=1e3 * epochs[1]["wall_time"] / A12_CLS_STEPS,
            parity=parity, checkpoint_files=files,
            checkpoint_ms=first.checkpoint_ms_,
            resume_bit_equal=resume_equal, resume_max_diff=resume_diff,
            resumed_losses=resumed.history.losses(),
            phase_wall_s=time.perf_counter() - t_phase)
        log(json.dumps(rec))
        fails = _a12_gates(launches, steps, CLS_DEPTH, by_epoch, losses,
                           parity, adam=False)
        if not (resume_equal and any(f.endswith(".dkc") for f in files)):
            fails.append(f"the resume from {files} ends {resume_diff} from "
                         f"the uninterrupted run (bit-equal: "
                         f"{resume_equal})")
        if fails:
            raise AssertionError("a12_config6_mesh: " + "; ".join(fails))
        return rec
    finally:
        shutil.rmtree(ck, ignore_errors=True)
        world.close()
        torch.cuda.empty_cache()


def train_a12_strategies(torch, train):
    """``a12_strategies``: each strategy on a mesh of one rank, A12_STRAT
    _STEPS steps from one init, against ``strategy="spmd"`` on the same
    model and rows: ``"sequence"`` (sp=1, the ring's f32 fold against the
    flash kernels, so SGD) on config 6; ``"expert"`` (ep=1) on the MoE
    classifier at its default width over config 5's rows and
    ``"pipeline"`` (pp=1) on config 6 at depth 1, both with fused Adam
    (the expert run with ``aux_weight=0``: the spmd objective has no
    load-balancing term). Gates: the losses within 1e-2; the expert and
    pipeline parameters equal spmd's bit for bit (the same kernels on the
    same values), the sequence update within A12_SGD_GAP of spmd's
    (``_update_gap``); K5 once a step of each Adam run; K2–K4 once a
    layer a step on the flash runs (spmd, pipeline)."""
    from distkeras_tpu_torch.models import (
        moe_transformer_classifier,
        transformer_classifier,
    )

    t_phase = time.perf_counter()
    world = _world_of_one(torch)
    try:
        def cls(depth):
            return transformer_classifier(
                vocab=CLS_VOCAB, maxlen=CLS_L, dim=CLS_DIM, heads=CLS_HEADS,
                depth=depth, dtype=torch.bfloat16, attn_impl="flash")

        S, B = A12_STRAT_STEPS, A12_BATCH
        cls_rows = classifier_data(S * B, seed=5)
        moe_rows = train.gather(np.arange(S * B))
        runs, fails = {}, []
        for name, spec, rows, shape, depth, opt in (
                ("sequence", cls(CLS_DEPTH), cls_rows, {"sp": 1}, None,
                 "sgd"),
                ("expert", moe_transformer_classifier(), moe_rows,
                 {"ep": 1}, None, "fused_adam"),
                ("pipeline", cls(1), cls_rows, {"pp": 1}, 1, "fused_adam")):
            out = {}
            for strategy in ("spmd", name):
                # the spmd objective has no load-balancing term
                extra = {"aux_weight": 0.0} if strategy == "expert" else {}
                t = _mesh_trainer(torch, spec, shape, opt,
                                  A12_STRAT_LR, B, 1, strategy=strategy,
                                  input_mode="resident",
                                  features_col=["features", "mask"], **extra)

                def run():
                    t0 = time.perf_counter()
                    p = t.train(rows)
                    torch.cuda.synchronize()
                    return p, time.perf_counter() - t0

                (params, wall), launches = counted(run)
                out[strategy] = dict(params=params, wall_s=wall,
                                     launches=launches,
                                     losses=t.history.losses())
                torch.cuda.empty_cache()
            a, b = out["spmd"], out[name]
            diff, bit_equal = _max_diff(torch, a["params"], b["params"])
            loss_gap = float(np.max(np.abs(np.asarray(a["losses"])
                                           - np.asarray(b["losses"]))))
            runs[name] = dict(
                mesh=shape, steps=S, optimizer=opt, losses_spmd=a["losses"],
                losses=b["losses"], max_param_diff=diff,
                bit_equal=bit_equal, loss_gap=loss_gap,
                launches=b["launches"], launches_spmd=a["launches"],
                wall_s=b["wall_s"], wall_s_spmd=a["wall_s"])
            if opt == "sgd":
                gap = _update_gap(torch, spec.init(0)[0], a["params"],
                                  b["params"])
                runs[name].update(update_gap=gap, limit=A12_SGD_GAP)
                params_ok = gap["leaf_max"] <= A12_SGD_GAP
            else:
                params_ok = bit_equal
            if not (params_ok and loss_gap <= 1e-2
                    and np.all(np.isfinite(b["losses"]))):
                fails.append(f"{name}: params {diff} from spmd (bit-equal "
                             f"{bit_equal}, update gap "
                             f"{runs[name].get('update_gap')}), losses "
                             f"{loss_gap} apart")
            for strategy, r in out.items() if opt == "fused_adam" else ():
                if r["launches"]["fused_adam"] != S:
                    fails.append(f"{name}/{strategy}: fused_adam launched "
                                 f"{r['launches']['fused_adam']} times")
            flash_runs = [("spmd", a)] + ([(name, b)] if name == "pipeline"
                                          else [])
            n_layers = depth or (CLS_DEPTH if name == "sequence" else 0)
            for strategy, r in flash_runs if n_layers else []:
                for k in ("flash_attention", "flash_attention_bwd_dq",
                          "flash_attention_bwd_dkv"):
                    if r["launches"][k] != n_layers * S:
                        fails.append(f"{name}/{strategy}: {k} launched "
                                     f"{r['launches'][k]} times, expected "
                                     f"{n_layers * S}")
        rec = dict(phase="a12_strategies", device=SMI, batch=B, runs=runs,
                   launches={k: sum(r["launches"][k] + r["launches_spmd"][k]
                                    for r in runs.values())
                             for k in runs["sequence"]["launches"]},
                   phase_wall_s=time.perf_counter() - t_phase)
        log(json.dumps(rec))
        if fails:
            raise AssertionError("a12_strategies: " + "; ".join(fails))
        return rec
    finally:
        world.close()
        torch.cuda.empty_cache()


def run_a12(torch, train) -> dict:
    """One model over a mesh: the three phases in order, each counting
    its own launches: ``{phase: record}``."""
    return {"a12_config9_mesh": train_a12_config9(torch),
            "a12_config6_mesh": train_a12_config6(torch),
            "a12_strategies": train_a12_strategies(torch, train)}


# -- W workers over processes (A12.2) and deploy streaming (A13) ------------

def _bit_equal(torch, a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def _checksum(tree: dict) -> float:
    """A position-weighted sum of every leaf in f64: equal centers give
    equal sums on every rank."""
    return float(sum(np.dot(np.asarray(v.float(), np.float64).ravel(),
                            np.arange(1, v.numel() + 1, dtype=np.float64))
                     for _, v in sorted(tree.items())))


def train_a122_config5(torch, train):
    """``a12_dp_mesh_config5``: config 5 (the IMDB LSTM at full width,
    DynSGD, W=IMDB_W, B=IMDB_BATCH, window IMDB_WINDOW, fused Adam) for
    A122_IMDB_WINDOWS windows with ``mesh=None``, then the same windows
    through ``DynSGD(..., mesh=Mesh({"dp": 1}))`` in an NCCL world of one
    the phase makes and destroys (the merge and the loss all-reduced over
    ``dp``), each run's launches counted alone. Gates: the centers and the
    loss records bit-equal; K5, K6 and K7 launched once a step in both."""
    from distkeras_tpu_torch.models import lstm_classifier
    from distkeras_tpu_torch.trainers import DynSGD

    t_phase = time.perf_counter()
    rows = IMDB_W * IMDB_BATCH * IMDB_WINDOW * A122_IMDB_WINDOWS
    ds = train.gather(np.arange(rows))
    spec = lstm_classifier(vocab=IMDB_VOCAB, maxlen=IMDB_T, embed_dim=IMDB_E,
                           hidden_dim=IMDB_H)

    def run(mesh):
        t = DynSGD(spec, loss=LOSS, worker_optimizer="fused_adam",
                   learning_rate=IMDB_LR, features_col=["features", "mask"],
                   num_workers=IMDB_W, batch_size=IMDB_BATCH,
                   communication_window=IMDB_WINDOW, num_epoch=1,
                   device=DEVICE, mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        center = t.train(ds)
        torch.cuda.synchronize()
        return center, t.history.losses(), time.perf_counter() - t0

    (c0, l0, w0), plain = counted(lambda: run(None))
    world = _world_of_one(torch)
    try:
        (c1, l1, w1), launches = counted(lambda: run(world))
    finally:
        world.close()
        torch.cuda.empty_cache()
    steps = A122_IMDB_WINDOWS * IMDB_WINDOW
    equal = _bit_equal(torch, c0, c1) and list(l0) == list(l1)
    rec = dict(phase="a12_dp_mesh_config5", device=SMI, mesh={"dp": 1},
               workers=IMDB_W, windows=A122_IMDB_WINDOWS, steps=steps,
               launches=launches, launches_mesh_none=plain,
               bit_equal=equal, losses=l1, wall_s=w1, wall_s_mesh_none=w0,
               phase_wall_s=time.perf_counter() - t_phase)
    log(json.dumps(rec))
    fails = []
    if not equal:
        diff = max(_err(c0[k], c1[k]) for k in c0)
        fails.append(f"mesh= differs from mesh=None: max |center diff| "
                     f"{diff}, losses {l0} vs {l1}")
    for k in ("fused_adam", "lstm_forward", "lstm_backward"):
        if not launches[k] == plain[k] == steps:
            fails.append(f"{k} launched {launches[k]} times over the mesh "
                         f"and {plain[k]} without, expected {steps}")
    if not np.all(np.isfinite(l1)):
        fails.append(f"the loss is not finite: {l1}")
    if fails:
        raise AssertionError("a12_dp_mesh_config5: " + "; ".join(fails))
    return rec


def train_a122_config9(torch, lm_rec):
    """``a12_dp_mesh_config9``: config 9 (the 134 M LM at full width and
    depth, L=2048, fused CE, fused Adam) under ADAG W=LM_W, one window an
    epoch for two epochs (the first warms the transforms up), with
    ``mesh=None``, then through ``ADAG(..., mesh=Mesh({"dp": 1}))`` in an
    NCCL world of one. Gates: the centers and losses bit-equal; K2, K3,
    K4 launched depth × window × 2 times and K5 window × 2 times in both.
    Prints each run's second window's ms and peak memory beside
    ``train_lm``'s window (epoch 1) and peak."""
    from distkeras_tpu_torch.data import next_token_dataset
    from distkeras_tpu_torch.trainers import ADAG

    t_phase = time.perf_counter()
    spec = lm_spec(torch, LM_DEPTH, "flash")
    ds = next_token_dataset(lm_tokens(LM_W * LM_WINDOW * LM_BATCH, seed=2))

    def run(mesh):
        t = ADAG(spec, loss=LOSS, worker_optimizer="fused_adam",
                 learning_rate=LM_LR, num_workers=LM_W, batch_size=LM_BATCH,
                 communication_window=LM_WINDOW, num_epoch=2, device=DEVICE,
                 log_metrics=True, mesh=mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        center = t.train(ds)
        torch.cuda.synchronize()
        epoch1 = [m for m in t.metrics_ if m.get("epoch") == 1]
        return (center, t.history.losses(), epoch1[0]["wall_time"],
                torch.cuda.max_memory_allocated())

    (c0, l0, w0, peak0), plain = counted(lambda: run(None))
    torch.cuda.empty_cache()
    world = _world_of_one(torch)
    try:
        (c1, l1, w1, peak1), launches = counted(lambda: run(world))
    finally:
        world.close()
        torch.cuda.empty_cache()
    equal = _bit_equal(torch, c0, c1) and list(l0) == list(l1)
    adag = [e for e in lm_rec["epochs"] if e["epoch"] == 1]
    rec = dict(phase="a12_dp_mesh_config9", device=SMI, mesh={"dp": 1},
               workers=LM_W, window=LM_WINDOW, batch=LM_BATCH,
               launches=launches, launches_mesh_none=plain, bit_equal=equal,
               losses=l1, window_ms=1e3 * w1, window_ms_mesh_none=1e3 * w0,
               peak_memory_gb=peak1 / 1e9,
               peak_memory_gb_mesh_none=peak0 / 1e9,
               adag_window_ms_epoch1=adag[0]["window_ms"] if adag else None,
               adag_peak_memory_gb=lm_rec["peak_memory_gb"],
               phase_wall_s=time.perf_counter() - t_phase)
    log(json.dumps(rec))
    fails = []
    if not equal:
        diff = max(_err(c0[k], c1[k]) for k in c0)
        fails.append(f"mesh= differs from mesh=None: max |center diff| "
                     f"{diff}, losses {l0} vs {l1}")
    steps = 2 * LM_WINDOW
    want = {"flash_attention": LM_DEPTH * steps,
            "flash_attention_bwd_dq": LM_DEPTH * steps,
            "flash_attention_bwd_dkv": LM_DEPTH * steps,
            "fused_adam": steps}
    for k, n in want.items():
        if not launches[k] == plain[k] == n:
            fails.append(f"{k} launched {launches[k]} times over the mesh "
                         f"and {plain[k]} without, expected {n}")
    if not np.all(np.isfinite(l1)):
        fails.append(f"the loss is not finite: {l1}")
    if fails:
        raise AssertionError("a12_dp_mesh_config9: " + "; ".join(fails))
    return rec


def ps_rank_main(workdir: str) -> int:
    """One rank of ``a12_ps_two_process`` (``python3 chip_smoke.py
    --ps-rank WORKDIR``, started by ``job_deployment.LocalRunner`` with
    the ``DISTKERAS_*`` environment): joins a gloo world of two, runs
    config 5 under DynSGD with ``backend="ps"`` over the socket and then
    the native transport (the multi-process path: rank 0 hosts the PS,
    each rank runs PS5_W / 2 worker threads on the card), counting its
    own launches, and writes every rank's record to
    ``WORKDIR/result.json`` from rank 0."""
    import datetime

    import torch
    import torch.distributed as dist

    from distkeras_tpu_torch.job_deployment import cluster_args_from_env
    from distkeras_tpu_torch.models import lstm_classifier
    from distkeras_tpu_torch.trainers import DynSGD

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = cluster_args_from_env()
    dist.init_process_group(
        "gloo", init_method=f"tcp://{env['coordinator_address']}",
        world_size=env["num_processes"], rank=env["process_id"],
        timeout=datetime.timedelta(seconds=A122_RANK_TIMEOUT))
    rank = dist.get_rank()
    train, _ = imdb_data()
    rows = PS5_W * IMDB_BATCH * IMDB_WINDOW * A122_PS_WINDOWS
    ds = train.gather(np.arange(rows))
    out = {}
    for transport in ("socket", "native"):
        spec = lstm_classifier(vocab=IMDB_VOCAB, maxlen=IMDB_T,
                               embed_dim=IMDB_E, hidden_dim=IMDB_H)
        t = DynSGD(spec, loss=LOSS, worker_optimizer="fused_adam",
                   learning_rate=IMDB_LR, features_col=["features", "mask"],
                   num_workers=PS5_W, batch_size=IMDB_BATCH,
                   communication_window=IMDB_WINDOW, num_epoch=PS5_EPOCHS,
                   backend="ps", ps_transport=transport, device=DEVICE)
        dist.barrier()
        t0 = time.perf_counter()
        center, launches = counted(lambda: t.train(ds))
        wall = time.perf_counter() - t0
        windows = sum(1 for r in t.history.records if "loss" in r)
        fell, means = _worker_loss_fell(t.history, PS5_W // 2, PS5_EPOCHS)
        stats = t.ps_stats_ or {}
        mine = dict(rank=rank, launches=launches, windows=windows,
                    steps=windows * IMDB_WINDOW, checksum=_checksum(center),
                    loss_fell=fell, epoch_mean_loss=means, wall_s=wall,
                    commits=stats.get("commits"),
                    num_updates=stats.get("num_updates"))
        everyone = [None] * dist.get_world_size()
        dist.all_gather_object(everyone, mine)
        out[transport] = everyone
        torch.cuda.empty_cache()
    if rank == 0:
        with open(os.path.join(workdir, "result.json"), "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def train_a122_ps_two_process(torch):
    """``a12_ps_two_process``: two processes (``job_deployment.
    LocalRunner``, a gloo world) on the one card run config 5 under
    DynSGD through the multi-process ``backend="ps"``, over the socket
    and the native transports (``ps_rank_main``). Gates, each transport:
    rank 0's server folded every commit (commits = updates = the windows
    both ranks' workers report, each acknowledged); both ranks returned
    the same center (checksums compared); each rank's loss fell; K5, K6
    and K7, each rank counting its own, sum to the local steps the eight
    workers report."""
    from distkeras_tpu_torch.job_deployment import Job, LocalRunner, Punchcard

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="dk_ps2_")
    root = os.path.dirname(os.path.abspath(__file__))
    with contextlib.closing(__import__("socket").socket()) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    runner = LocalRunner()
    job = Job(Punchcard(script=os.path.abspath(__file__),
                        hosts=["localhost"] * 2, coordinator_port=port,
                        env={"PYTHONPATH": root},
                        args=["--ps-rank", workdir]), runner=runner)
    try:
        job.run()
        rcs = runner.wait(timeout=A122_RANK_TIMEOUT)
    finally:
        for p in runner.procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    if any(rcs):
        errs = "\n".join(getattr(p, "captured_stderr", "")[-4000:]
                         for p in runner.procs)
        raise AssertionError(f"a12_ps_two_process: ranks exited {rcs}:\n"
                             f"{errs}")
    with open(os.path.join(workdir, "result.json")) as f:
        res = json.load(f)
    shutil.rmtree(workdir, ignore_errors=True)
    fails, runs = [], {}
    for transport, ranks in res.items():
        launches = {k: sum(r["launches"][k] for r in ranks)
                    for k in ranks[0]["launches"]}
        steps = sum(r["steps"] for r in ranks)
        windows = sum(r["windows"] for r in ranks)
        host = ranks[0]
        runs[transport] = dict(
            launches=launches, steps=steps, windows=windows,
            commits=host["commits"], num_updates=host["num_updates"],
            checksums=[r["checksum"] for r in ranks],
            epoch_mean_loss=[r["epoch_mean_loss"] for r in ranks],
            wall_s=[r["wall_s"] for r in ranks],
            launches_by_rank=[r["launches"] for r in ranks])
        if not host["commits"] == host["num_updates"] == windows:
            fails.append(f"{transport}: {host['commits']} commits and "
                         f"{host['num_updates']} updates, {windows} "
                         f"acknowledged windows")
        if len({r["checksum"] for r in ranks}) != 1:
            fails.append(f"{transport}: the ranks returned different "
                         f"centers {runs[transport]['checksums']}")
        if not all(r["loss_fell"] for r in ranks):
            fails.append(f"{transport}: the loss did not fall: "
                         f"{runs[transport]['epoch_mean_loss']}")
        for k in ("fused_adam", "lstm_forward", "lstm_backward"):
            if launches[k] != steps:
                fails.append(f"{transport}: {k} launched {launches[k]} "
                             f"times over both ranks, the workers took "
                             f"{steps} steps")
    launches = {k: sum(r["launches"][k] for r in res["socket"]) +
                sum(r["launches"][k] for r in res["native"])
                for k in res["socket"][0]["launches"]}
    rec = dict(phase="a12_ps_two_process", device=SMI, ranks=2,
               workers=PS5_W, launches=launches, runs=runs,
               phase_wall_s=time.perf_counter() - t_phase)
    log(json.dumps(rec))
    if fails:
        raise AssertionError("a12_ps_two_process: " + "; ".join(fails))
    return rec


def run_a122(torch, train, lm_rec) -> dict:
    """W workers over processes: the three phases in order, each counting
    its own launches: ``{phase: record}``."""
    return {"a12_dp_mesh_config5": train_a122_config5(torch, train),
            "a12_dp_mesh_config9": train_a122_config9(torch, lm_rec),
            "a12_ps_two_process": train_a122_ps_two_process(torch)}


def _served_lm(torch, kind, tree):
    """The served config-9 LM at depth A13_DEPTH (bf16, flash prefill,
    RoPE) carrying the training center ``tree``; ``kind="int8"`` is that
    float model through ``quantize_lm``, made apart from the server's
    ``quantize_state_dict`` of a swap."""
    from distkeras_tpu_torch.models import quantize_lm, transformer_lm

    m = transformer_lm(vocab=LM_VOCAB, maxlen=LM_L, dim=LM_DIM,
                       heads=LM_HEADS, depth=A13_DEPTH, pos_embedding="rope",
                       attn_impl="flash", dtype=torch.bfloat16, device=DEVICE)
    with torch.no_grad():
        m.load_state_dict({k: torch.as_tensor(v) for k, v in tree.items()})
    m = m.eval()
    return quantize_lm(m) if kind == "int8" else m


def _a13_engine(model, version):
    from distkeras_tpu_torch.serving import GenerationEngine

    return GenerationEngine(model, max_batch=2, block_size=BLOCK,
                            model_version=version, device=DEVICE)


def train_a13_deploy_stream(torch, watched: bool = False):
    """``a13_deploy_stream``: config 9's LM at full width (depth cut to
    A13_DEPTH) trains under ADAG with ``backend="ps"`` (in-process), 2
    worker threads of batch LM_BATCH and window LM_WINDOW, A13_WINDOWS
    windows each, fused Adam, with ``deploy_streamer=WeightStreamer(
    ADAGMerge(), 2, snapshot_every=A13_SNAPSHOT_EVERY)``: read replicas of
    the center cut a version every A13_SNAPSHOT_EVERY folds. Two
    ``GenerationServer`` replicas, one bf16 and one int8, serve the
    first version from the streamer's store, registered in a
    ``DirectoryServer`` and reached through ``RoutedGenerationClient``; a
    ``RolloutController`` with a ``health`` closure canaries the second
    version on one replica and promotes it, then canaries the third and,
    with ``health`` reporting the serving SLO firing, rolls it back.
    Gates: every greedy stream (sent alone, to each replica after each
    transition and through the router at the end) is token-for-token the
    stream of a fresh engine of the same kind at the replica's version;
    the streamer publishes the last fold's version; the PS's deploy
    lag, read when training ends, within the fold count; the journal
    holds canary, promote, canary, rollback, every activation
    acknowledged; K1 (the int8 replica), K2 (training and prefill), K3,
    K4 and K5 (training) launched.

    ``watched=True`` is ``a13_watch_rollout``: the same setup with the
    trainer's watchtower (``watch_rules=[DeployLagRule(A13_LAG_BOUND)]``,
    scraping every A13_SCRAPE s) and the rollout's ``health`` read off a
    serving ``Watchtower`` (``watchtower_health``) that samples the bf16
    replica's engine on an injected clock, with a ``ServingSLORule`` at
    A13_SLO_P99_MS. The tower is green at the promotion; a latency fault
    injected into ``serve.lat.default.p99_ms`` (ten times the bound, as
    ``examples/train_while_serving.py`` injects it) fires the rule, and
    the next canary is rolled back. Further gates: the tower green before
    the promotion and firing only the SLO before the rollback; the
    trainer's DeployLagRule never fired."""
    from distkeras_tpu_torch.data import next_token_dataset
    from distkeras_tpu_torch.deploy import (
        RolloutController,
        RolloutPolicy,
        WeightStreamer,
        watchtower_health,
    )
    from distkeras_tpu_torch.directory import DirectoryServer
    from distkeras_tpu_torch.directory.router import RoutedGenerationClient
    from distkeras_tpu_torch.observability.watch import (
        DeployLagRule,
        ServingSLORule,
        SLOClass,
        Watchtower,
    )
    from distkeras_tpu_torch.parallel import ADAGMerge
    from distkeras_tpu_torch.serving import GenerationClient, GenerationServer
    from distkeras_tpu_torch.trainers import ADAG

    name = "a13_watch_rollout" if watched else "a13_deploy_stream"
    t_phase = time.perf_counter()
    zero_launches()
    folds = 2 * A13_WINDOWS
    st = WeightStreamer(ADAGMerge(), 2, snapshot_every=A13_SNAPSHOT_EVERY)
    dsrv = router = None
    servers: dict = {}
    try:
        spec = lm_spec(torch, A13_DEPTH, "flash")
        t = ADAG(spec, loss=LOSS, worker_optimizer="fused_adam",
                 learning_rate=LM_LR, num_workers=2, batch_size=LM_BATCH,
                 communication_window=LM_WINDOW, num_epoch=1, backend="ps",
                 deploy_streamer=st, device=DEVICE,
                 **(dict(watch_rules=[DeployLagRule(bound=A13_LAG_BOUND)],
                         scrape_interval=A13_SCRAPE) if watched else {}))
        ds = next_token_dataset(lm_tokens(
            2 * LM_WINDOW * LM_BATCH * A13_WINDOWS, seed=4))
        t0 = time.perf_counter()
        t.train(ds)
        train_s = time.perf_counter() - t0
        stats = t.ps_stats_
        deadline = time.monotonic() + 120
        while st.stats()["latest_version"] < folds \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        versions = st.store.versions()
        streamed = st.stats()["latest_version"]
        if len(versions) < 3 or streamed != folds:
            raise AssertionError(f"{name}: the streamer "
                                 f"published {versions} of {folds} folds")
        va, vb, vc = versions[:3]
        torch.cuda.empty_cache()

        oracles: dict = {}

        def oracle(kind, version, prompt):
            """The fresh engine's stream; its launches are not the
            phase's (the counters are put back)."""
            key = (kind, version, tuple(prompt.tolist()))
            if key not in oracles:
                saved = read_launches()
                eng = _a13_engine(_served_lm(torch, kind,
                                             st.store.get(version).tree),
                                  version)
                with torch.inference_mode():
                    req = eng.submit(prompt, max_new_tokens=A13_NEW)
                    eng.run_until_idle()
                oracles[key] = req.result(0).tolist()
                del eng
                for k, (fn, attr) in _ps_launch_counters().items():
                    setattr(fn, attr, saved[k])
            return oracles[key]

        dsrv = DirectoryServer(default_ttl=5.0)
        dsrv.initialize()
        dsrv.start()
        seeds = [(dsrv.host, dsrv.port)]
        base = st.store.get(va).tree
        for kind in ("bf16", "int8"):
            srv = GenerationServer(
                _a13_engine(_served_lm(torch, kind, base), va),
                poll_interval=0.02)
            srv.snapshots = st.store
            srv.start()
            srv.register_with(seeds, key=kind, ttl=5.0)
            servers[kind] = srv
        router = RoutedGenerationClient(directory=seeds,
                                        refresh_interval=0.2)
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, LM_VOCAB, (n,)).astype(np.int32)
                   for n in A13_PROMPTS]
        mismatches: list = []
        streams = 0

        def wait_fleet(want):
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                router.refresh(force=True)
                if router.replica_versions() == want:
                    return
                time.sleep(0.1)
            raise AssertionError(f"{name}: the fleet never "
                                 f"advertised {want}: "
                                 f"{router.replica_versions()}")

        def check_replicas(label):
            nonlocal streams
            for kind, srv in servers.items():
                c = GenerationClient(srv.host, srv.port)
                try:
                    v = c.deploy_status()["model_version"]
                    for p in prompts:
                        got = c.generate(p, max_new_tokens=A13_NEW).tolist()
                        streams += 1
                        if got != oracle(kind, v, p):
                            mismatches.append((label, kind, v, len(p)))
                finally:
                    c.close()

        swap_ms: list = []

        def activate(key, version):
            c = GenerationClient(servers[key].host, servers[key].port)
            try:
                t1 = time.perf_counter()
                ok = bool(c.deploy_activate(version, policy="drain")["ok"])
                c.wait_for_swap(timeout=120.0)
                swap_ms.append(1e3 * (time.perf_counter() - t1))
                return ok
            finally:
                c.close()

        health = {"green": True, "slo": False}
        tower = None
        seen_health: list = []
        if watched:
            # the serving tower on an injected clock: each observation is
            # one scrape of the bf16 replica's engine, then the rules
            tower = Watchtower(rules=[ServingSLORule(
                slo={"default": SLOClass(p99_ms=A13_SLO_P99_MS)})])
            tower.add_serving(servers["bf16"].engine)

            def read_health():
                return watchtower_health(tower)
        else:
            def read_health():
                return health["green"], health["slo"]

        def observe(now, fault=False):
            if tower is None:
                return
            tower.tick(now=now)
            if fault:
                tower.store.sample("serve.lat.default.p99_ms", now,
                                   10.0 * A13_SLO_P99_MS)
                tower.watchdog.evaluate(now=now)
            seen_health.append(read_health())

        ctrl = RolloutController(
            router, activate, read_health,
            policy=RolloutPolicy(canary_fraction=0.5, bake_s=0.0,
                                 green_checks=1, red_checks=1,
                                 cooldown_s=0.0))
        wait_fleet({"bf16": va, "int8": va})
        check_replicas("base")
        ctrl.begin(vb)
        observe(1.0)
        legs = [[a["action"] for a in ctrl.step(1.0)]]
        canary, = ctrl.canary_keys
        rest, = set(servers) - {canary}
        wait_fleet({canary: vb, rest: va})
        check_replicas("canary")
        observe(2.0)
        legs.append([a["action"] for a in ctrl.step(2.0)])
        wait_fleet({"bf16": vb, "int8": vb})
        check_replicas("promoted")
        ctrl.begin(vc)
        observe(3.0)
        legs.append([a["action"] for a in ctrl.step(3.0)])
        check_replicas("canary2")
        health.update(green=False, slo=True)
        observe(4.0, fault=True)
        legs.append([a["action"] for a in ctrl.step(4.0)])
        wait_fleet({"bf16": vb, "int8": vb})
        check_replicas("rolled_back")
        routed = {}
        for p in prompts:
            before = dict(router.stats()["routed"])
            got = router.generate(p, max_new_tokens=A13_NEW).tolist()
            after = router.stats()["routed"]
            kind = next(k for k in after if after[k] != before.get(k, 0))
            routed[kind] = routed.get(kind, 0) + 1
            streams += 1
            if got != oracle(kind, vb, p):
                mismatches.append(("routed", kind, vb, len(p)))
        journal = [dict(action=j["action"], version=j.get("version"),
                        keys=j["keys"], activated=j["activated"])
                   for j in ctrl.journal]
    finally:
        if router is not None:
            router.close()
        for srv in servers.values():
            srv.stop(drain=False)
        st.close()
        if dsrv is not None:
            dsrv.stop()
        torch.cuda.empty_cache()
    launches = read_launches()
    watch = None
    if watched:
        lag = t.watchtower_.store.get("ps.deploy_lag_folds")
        watch = dict(
            lag_bound=A13_LAG_BOUND,
            max_deploy_lag_folds=(max(v for _, v in lag.points())
                                  if lag is not None else None),
            trainer_alerts=t.watch_alerts_, health=seen_health,
            serving_alerts=tower.alerts_json(),
            served_p99_ms=tower.store.last("serve.lat.default.p99_ms"))
    rec = dict(phase=name, device=SMI, depth=A13_DEPTH,
               width=dict(vocab=LM_VOCAB, dim=LM_DIM, heads=LM_HEADS,
                          maxlen=LM_L),
               reduced=dict(depth=f"{LM_DEPTH} -> {A13_DEPTH}"),
               workers=2, folds=stats["num_updates"], train_s=train_s,
               snapshot_every=A13_SNAPSHOT_EVERY, versions=versions,
               candidates=[va, vb, vc],
               streamed_version=streamed,
               deploy_version=stats["deploy_version"],
               deploy_lag_folds=stats["deploy_lag_folds"], legs=legs,
               journal=journal, streams=streams, routed=routed,
               mismatches=mismatches, swap_ms=swap_ms, launches=launches,
               **({"watch": watch} if watched else {}),
               phase_wall_s=time.perf_counter() - t_phase)
    log(json.dumps(rec))
    fails = []
    if mismatches:
        fails.append(f"streams off their version's fresh engine: "
                     f"{mismatches}")
    if legs != [["canary"], ["promote"], ["canary"], ["rollback"]]:
        fails.append(f"transitions {legs}")
    if [j["action"] for j in journal] != ["canary", "promote", "canary",
                                          "rollback"] \
            or any(j["activated"] != len(j["keys"]) for j in journal):
        fails.append(f"journal {journal}")
    # the PS's lag is read when training ends, while the publisher may
    # still be reporting: bounded by the folds, whatever has landed
    if stats["num_updates"] != folds or not (
            stats["deploy_version"] + stats["deploy_lag_folds"] == folds
            and 0 <= stats["deploy_lag_folds"] <= folds):
        fails.append(f"{stats['num_updates']} folds (expected {folds}), "
                     f"deploy version {stats['deploy_version']}, lag "
                     f"{stats['deploy_lag_folds']}")
    for k in ("q_matmul", "flash_attention", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv", "fused_adam"):
        if launches[k] < 1:
            fails.append(f"{k} never launched")
    if watched:
        fired = [a for a in watch["trainer_alerts"]["log"]
                 if a["state"] == "firing"]
        if any(a["kind"] == "deploy_lag" for a in fired):
            fails.append(f"DeployLagRule fired over {A13_LAG_BOUND} folds: "
                         f"{fired}")
        if watch["max_deploy_lag_folds"] is None:
            fails.append("the trainer's tower never sampled the deploy lag")
        if seen_health[:3] != [(True, False)] * 3 \
                or seen_health[3:] != [(False, True)]:
            fails.append(f"the serving tower's health {seen_health}: green "
                         f"through the promotion, the SLO alone at the "
                         f"fault")
    if fails:
        raise AssertionError(f"{name}: " + "; ".join(fails))
    return rec


def _metrics_action(port: int) -> dict:
    """One ``metrics`` wire action against the server at ``port``."""
    from distkeras_tpu_torch import networking

    sock = networking.connect("127.0.0.1", port, timeout=30.0)
    try:
        networking.send_data(sock, {"action": "metrics"})
        return networking.recv_data(sock)
    finally:
        sock.close()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _observability_cli(*args) -> dict:
    """``python -m distkeras_tpu_torch.observability *args`` from the
    checkout's root: its exit code, stdout, stderr's tail and seconds."""
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "distkeras_tpu_torch.observability", *args],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    return dict(rc=cli.returncode, stdout=cli.stdout,
                stderr=cli.stderr[-2000:], s=time.perf_counter() - t0)


def _scrape_live(port: int, done: threading.Event, out: dict) -> None:
    """The observe phase's side thread: once the PS at ``port`` has folded
    a window of every worker (read through its ``metrics`` action), the
    CLI scrapes it while the run goes on, ``dump --prom`` then ``health
    --watch --count 2``; the results land in ``out``."""
    deadline = time.monotonic() + 300
    while not done.is_set() and time.monotonic() < deadline:
        try:
            m = _metrics_action(port)["metrics"]
            if m["dk_ps_commits_total"]["samples"][0]["value"] >= PS5_W:
                break
        except (OSError, EOFError, KeyError):
            pass
        time.sleep(0.05)
    out["dump"] = _observability_cli("dump", "--port", str(port), "--prom")
    out["dump"]["run_still_going"] = not done.is_set()
    out["watch"] = _observability_cli(
        "health", "--watch", "--host", "127.0.0.1", "--port", str(port),
        "--count", "2", "--interval", str(A13_SCRAPE))


def _prom_value(text: str, name: str):
    """The unlabeled sample of ``name`` in a Prometheus exposition."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return None


def _windows_by_worker(history) -> dict:
    out: dict = {}
    for r in history:
        if "loss" in r:
            w = str(r["worker"])
            out[w] = out.get(w, 0) + 1
    return out


_BUCKETS = ("compute", "compress", "wire", "decode", "lock_wait", "fold",
            "wal", "pull")


def _analysis_summary(a: dict) -> dict:
    """What an observe phase prints of the analyzer's report: the host's
    busy share, the regime with its fractions and recommendations, each
    worker's critical-path buckets and window ms, and the overlap."""
    tr = a["training"] or {}
    return dict(
        host_busy_fraction=a["host_busy_fraction"],
        host_cores=a["host_cores"], wall_s=a["wall_s"],
        regime=a["verdict"]["regime"],
        fractions=a["verdict"]["fractions"],
        recommendations=a["verdict"]["recommendations"],
        dropped_spans=a["dropped_spans"],
        skipped_windows=a["skipped_windows"],
        overlap=tr.get("overlap"),
        critical_path_ms={w: {k: v[f"{k}_ms"] for k in _BUCKETS}
                          for w, v in (tr.get("workers") or {}).items()},
        window_ms={w: dict(mean=v["mean_window_ms"], p50=v["p50_window_ms"],
                           cycle=v["mean_cycle_ms"], stall=v["stall_ms"])
                   for w, v in (tr.get("workers") or {}).items()},
        windows={w: v["windows"]
                 for w, v in (tr.get("workers") or {}).items()},
        totals_ms=tr.get("totals_ms"), union_ms=tr.get("union_ms"),
        stragglers=tr.get("stragglers"),
        counters=a.get("counters"))


def _analysis_gates(name, t, ps_steps, launches) -> list:
    """The gates both observe phases share: the analysis exists, names a
    regime (not idle), lost no span and skipped no window, assembled as
    many windows for each worker as it ran, with an overlap in [0, 1];
    K5, K6 and K7 launched as often as in ``ps_config5_inprocess``."""
    from distkeras_tpu_torch.observability.analyze import REGIMES

    fails = []
    a = t.analysis_
    if a is None:
        return [f"{name}: no analysis_ (the post-run analysis failed)"]
    regime = a["verdict"]["regime"]
    if regime not in REGIMES or regime == "idle":
        fails.append(f"{name}: regime {regime!r}")
    if a["dropped_spans"] != 0 or a["skipped_windows"] != 0:
        fails.append(f"{name}: {a['dropped_spans']} dropped spans, "
                     f"{a['skipped_windows']} skipped windows")
    ran = _windows_by_worker(t.history.records)
    got = {w: v["windows"] for w, v in
           ((a["training"] or {}).get("workers") or {}).items()}
    if got != ran:
        fails.append(f"{name}: windows assembled {got}, run {ran}")
    frac = ((a["training"] or {}).get("overlap") or {}).get("fraction")
    if not isinstance(frac, float) or not 0.0 <= frac <= 1.0:
        fails.append(f"{name}: overlap fraction {frac!r}")
    for k in ("fused_adam", "lstm_forward", "lstm_backward"):
        if launches[k] != ps_steps:
            fails.append(f"{name}: {k} launched {launches[k]} times, "
                         f"expected {ps_steps} as in ps_config5_inprocess")
    return fails


def train_a13_observe_ps(torch, train, ps_steps):
    """``a13_observe_ps_config5``: config 5 at its published width under
    DynSGD through the socket PS (``_config5``: PS5_W workers of batch
    IMDB_BATCH, window IMDB_WINDOW, PS5_EPOCHS epochs, fused Adam) with a
    WAL and ``analyze=True, watch=True, trace_dir=, watch_dir=,
    scrape_interval=A13_SCRAPE``. While it runs, the CLI scrapes the live
    server's ``metrics`` action (``dump --prom``, then ``health --watch
    --count 2``); after it, ``analyze <trace> --series <dump> --json``
    reads the saved files. Gates: ``_analysis_gates``; the CLI's dump
    answered while the run went on; its ``dk_ps_commits_total`` at most
    the final commits, which ``ps_metrics`` of the final stats carries
    equal; the CLI's regime equal to ``analysis_``'s and its fractions
    within 1e-3 (the file keeps µs floats); the watch dump loads back
    with ``ps.tau_p95``, ``ps.wal_fsync_p95_ms``, ``train.loss`` and
    every worker's ``worker.<wid>.windows``; no scraper source disabled;
    the alert ledger's log a list (printed whole)."""
    from distkeras_tpu_torch.observability.metrics import ps_metrics
    from distkeras_tpu_torch.observability.timeseries import TimeSeriesStore

    name = "a13_observe_ps_config5"
    work = tempfile.mkdtemp(prefix="dk-a13-observe-")
    port = _free_port()
    cli: dict = {}
    done = threading.Event()
    try:
        t, rows = _config5(
            "socket", ps_port=port, ps_wal_dir=os.path.join(work, "wal"),
            analyze=True, watch=True, trace_dir=os.path.join(work, "trace"),
            watch_dir=os.path.join(work, "watch"),
            scrape_interval=A13_SCRAPE)
        scraper = threading.Thread(target=_scrape_live,
                                   args=(port, done, cli), daemon=True)

        def run():
            scraper.start()
            t0 = time.perf_counter()
            try:
                t.train(train.gather(np.arange(rows)))
            finally:
                done.set()
            return time.perf_counter() - t0

        wall, launches = counted(run)
        scraper.join(300)
        stats = t.ps_stats_
        analyzed = _observability_cli("analyze", t.trace_path_, "--series",
                                      t.watch_path_, "--json")
        report = (json.loads(analyzed["stdout"]) if analyzed["rc"] == 0
                  else None)
        store = TimeSeriesStore.load(t.watch_path_)
        series = store.names()
        dead = sorted(t.watchtower_.scraper._dead)
        dump = cli.get("dump", {})
        scraped = _prom_value(dump.get("stdout", ""), "dk_ps_commits_total")
        final_metric = ps_metrics(stats).to_json()[
            "dk_ps_commits_total"]["samples"][0]["value"]
        watch_lines = [json.loads(ln) for ln in
                       cli.get("watch", {}).get("stdout", "").splitlines()
                       if ln.strip()]
    finally:
        done.set()
        torch.cuda.empty_cache()
    a = t.analysis_
    frac_diff = None
    if report is not None and a is not None:
        fa, fb = a["verdict"]["fractions"], report["verdict"]["fractions"]
        frac_diff = (max(abs(fa[k] - fb[k]) for k in fa)
                     if set(fa) == set(fb) and fa else
                     (0.0 if fa == fb else float("inf")))
    rec = dict(phase=name, device=SMI, transport="socket", workers=PS5_W,
               wall_s=wall, commits=stats["commits"],
               window_wall_ms=1e3 * wall / (PS5_WINDOWS * PS5_EPOCHS),
               analysis=_analysis_summary(a) if a is not None else None,
               cli=dict(dump_rc=dump.get("rc"),
                        dump_during_run=dump.get("run_still_going"),
                        dump_s=dump.get("s"),
                        scraped_commits=scraped, final_commits=stats["commits"],
                        final_metric_commits=final_metric,
                        watch_rc=cli.get("watch", {}).get("rc"),
                        watch_transitions=watch_lines,
                        analyze_rc=analyzed["rc"],
                        analyze_regime=(report or {}).get("verdict", {}).get(
                            "regime"),
                        fraction_max_diff=frac_diff),
               series=len(series), disabled_sources=dead,
               watch_alerts=t.watch_alerts_, launches=launches)
    log(json.dumps(rec))
    fails = _analysis_gates(name, t, ps_steps, launches)
    if dump.get("rc") != 0 or scraped is None:
        fails.append(f"{name}: the live dump failed: rc {dump.get('rc')} "
                     f"{dump.get('stderr', '')[-500:]}")
    elif not scraped <= stats["commits"] == final_metric:
        fails.append(f"{name}: scraped {scraped} commits, final "
                     f"{stats['commits']}, ps_metrics {final_metric}")
    if cli.get("watch", {}).get("rc") not in (0, 1):
        fails.append(f"{name}: health --watch rc {cli.get('watch')}")
    if report is None or a is None \
            or report["verdict"]["regime"] != a["verdict"]["regime"] \
            or frac_diff is None or frac_diff > 1e-3:
        fails.append(f"{name}: the CLI's analysis (rc {analyzed['rc']}, "
                     f"{analyzed['stderr'][-500:]}) differs from analysis_: "
                     f"fractions {frac_diff}")
    want = {"ps.tau_p95", "ps.wal_fsync_p95_ms", "train.loss"} | {
        f"worker.{w}.windows" for w in range(PS5_W)}
    if not want <= set(series):
        fails.append(f"{name}: the watch dump lacks "
                     f"{sorted(want - set(series))}")
    if dead:
        fails.append(f"{name}: scraper sources disabled: {dead}")
    if not isinstance((t.watch_alerts_ or {}).get("log"), list):
        fails.append(f"{name}: watch_alerts_ {t.watch_alerts_!r}")
    if fails:
        raise AssertionError("; ".join(fails))
    shutil.rmtree(work, ignore_errors=True)
    return rec


def train_a13_observe_native(torch, train, ps_steps):
    """``a13_observe_native_config5``: the same run on the native PS with
    the C++ WAL, ``RetryPolicy(seed=0)`` (the resilient clients stamp
    ``w<id>:s<seq>`` on their commits, as the C++ ring records them) and
    ``analyze=True``; the run scrapes the C++ span ring into its trace
    before the server stops. Gates: ``_analysis_gates``; the trace holds
    one ``ps.fold`` span of ``cat`` "dkps" for each of the server's folds,
    each with a ``w<id>:s<seq>`` corr; every worker's commits decomposed
    against them (its critical-path fold time above 0)."""
    import re

    from distkeras_tpu_torch.observability.analyze import load_trace
    from distkeras_tpu_torch.resilience import RetryPolicy

    name = "a13_observe_native_config5"
    work = tempfile.mkdtemp(prefix="dk-a13-native-")
    try:
        t, rows = _config5(
            "native", ps_wal_dir=os.path.join(work, "wal"),
            retry_policy=RetryPolicy(seed=0, max_attempts=PS5_ATTEMPTS),
            analyze=True, trace_dir=os.path.join(work, "trace"))

        def run():
            t0 = time.perf_counter()
            t.train(train.gather(np.arange(rows)))
            return time.perf_counter() - t0

        wall, launches = counted(run)
        stats = t.ps_stats_
        events, _ = load_trace(t.trace_path_)
    finally:
        torch.cuda.empty_cache()
    folds = [e for e in events if e["name"] == "ps.fold"
             and e["cat"] == "dkps"]
    bad_corr = [e["corr"] for e in folds
                if not re.fullmatch(r"w\d+:s\d+", str(e["corr"]))]
    a = t.analysis_
    rec = dict(phase=name, device=SMI, transport="native", workers=PS5_W,
               wall_s=wall, folds=stats["num_updates"],
               commits=stats["commits"], dup_commits=stats["dup_commits"],
               window_wall_ms=1e3 * wall / (PS5_WINDOWS * PS5_EPOCHS),
               dkps_spans={n: sum(1 for e in events if e["cat"] == "dkps"
                                  and e["name"] == n)
                           for n in ("ps.fold", "ps.wal_wait", "wal.fsync")},
               analysis=_analysis_summary(a) if a is not None else None,
               launches=launches)
    log(json.dumps(rec))
    fails = _analysis_gates(name, t, ps_steps, launches)
    if len(folds) != stats["num_updates"] or bad_corr:
        fails.append(f"{name}: {len(folds)} dkps fold spans for "
                     f"{stats['num_updates']} folds; corr not w<id>:s<seq>: "
                     f"{bad_corr[:5]}")
    if a is not None and not all(
            v["fold_ms"] > 0 for v in a["training"]["workers"].values()):
        fails.append(f"{name}: a worker's commits were not decomposed "
                     f"against the C++ folds: "
                     f"{_analysis_summary(a)['critical_path_ms']}")
    if fails:
        raise AssertionError("; ".join(fails))
    shutil.rmtree(work, ignore_errors=True)
    return rec


def serve_a13_watched(torch):
    """``a13_watch_serving``: the served 400M MQA decoder (VOCAB, DIM,
    HEADS, KV_HEADS, DEPTH: phase 9's config) in int8 (``quantize_lm``)
    through ``GenerationServer`` with tracing on and a ``Watchtower``
    (``add_serving(engine)``; ``ServingSLORule`` and
    ``PrefixHitRateRule``) attached as the server's ``watchtower``, the
    same 4 clients and prompts as phase 9 (``serve``). Gates: K1 (decode
    and prefill) and K2 launched; the ``metrics`` action's reply carries
    the ``dk_serve_*`` metrics, the completed count and the alert ledger;
    ``analyze_events`` over the trace gives a serving report counting
    every request served; every stream tie-aware equal to a full forward,
    as phase 9 holds it. The server's flight recorder (``trace_dir=``, a
    temporary directory) writes its timeline at stop: ``trace_path_`` is
    set and the file exists, ``load_trace`` of it counts one
    ``serve.request`` span a request, as many as the in-memory events, and
    ``analyze_events`` over the file's events counts the same requests
    served. Prints the report's queue, prefill and decode split."""
    from distkeras_tpu_torch.models import quantize_lm, transformer_lm
    from distkeras_tpu_torch.observability.analyze import (
        analyze_events,
        load_trace,
    )
    from distkeras_tpu_torch.observability.watch import (
        PrefixHitRateRule,
        ServingSLORule,
        Watchtower,
    )

    name = "a13_watch_serving"
    model = transformer_lm(
        vocab=VOCAB, maxlen=MAXLEN, dim=DIM, heads=HEADS, depth=DEPTH,
        kv_heads=KV_HEADS, pos_embedding="rope", attn_impl="flash",
        dtype=torch.bfloat16, device=DEVICE, seed=0)
    qmodel = quantize_lm(model)
    del model
    tower = Watchtower(rules=[ServingSLORule(), PrefixHitRateRule()],
                       interval=A13_SCRAPE)
    zero_launches()
    with contextlib.ExitStack() as stack:
        events = stack.enter_context(_traced())
        stack.enter_context(torch.inference_mode())
        trace_dir = stack.enter_context(tempfile.TemporaryDirectory())
        prompts, res, wall, stats = serve(torch, qmodel, "int8 watched",
                                          tower=tower, trace_dir=trace_dir)
        # the recorder's file, read before its directory goes
        path = stats.pop("trace_path")
        file_events = load_trace(path)[0] if path and os.path.exists(path) \
            else None
    launches = read_launches()
    with torch.inference_mode():
        tie_aware_check(torch, qmodel, prompts, res, "int8 watched")
    del qmodel
    torch.cuda.empty_cache()
    report = analyze_events(events)
    reply = stats.pop("metrics_reply")
    metrics = reply.get("metrics") or {}
    completed = (metrics.get("dk_serve_completed_total") or {}).get(
        "samples", [{}])[0].get("value")
    sv = report["serving"] or {}
    rec = dict(phase=name, device=SMI, config=dict(
                   vocab=VOCAB, dim=DIM, heads=HEADS, kv_heads=KV_HEADS,
                   depth=DEPTH, dtype="int8"),
               requests=len(prompts), new_tokens=NEW_TOKENS, wall_s=wall,
               serving=sv, regime=report["verdict"]["regime"],
               fractions=report["verdict"]["fractions"],
               host_busy_fraction=report["host_busy_fraction"],
               latency=stats.get("latency"),
               serve_metrics=sorted(k for k in metrics
                                    if k.startswith("dk_serve_")),
               alerts=reply.get("alerts"),
               series=len(tower.store.names()),
               disabled_sources=sorted(tower.scraper._dead),
               spans={n: sum(1 for e in events if e["name"] == n)
                      for n in ("serve.enqueue", "serve.queued",
                                "serve.prefill", "serve.decode_step",
                                "serve.request")},
               launches=launches)
    file_requests = None
    if file_events is not None:
        file_requests = (analyze_events(file_events)["serving"]
                         or {}).get("requests")
        per_req = collections.Counter(
            e["corr"] for e in file_events if e["name"] == "serve.request")
        rec["flight_recorder"] = dict(
            file=os.path.basename(path), events=len(file_events),
            serve_request_spans=sum(per_req.values()),
            requests_with_one_span=sum(1 for v in per_req.values()
                                       if v == 1),
            analyzed_requests=file_requests)
    log(json.dumps(rec))
    fails = []
    fr = rec.get("flight_recorder")
    if fr is None:
        fails.append(f"the flight recorder wrote no file: trace_path_ "
                     f"{path!r}")
    elif not (fr["serve_request_spans"] == len(prompts)
              == fr["requests_with_one_span"]
              == rec["spans"]["serve.request"]
              and file_requests == sv.get("requests") == len(prompts)):
        fails.append(f"the flight recorder's file: {fr}, in memory "
                     f"{rec['spans']['serve.request']} serve.request spans")
    for k in ("q_matmul", "q_matmul_prefill", "flash_attention"):
        if launches[k] < 1:
            fails.append(f"{k} never launched")
    if not reply.get("ok") or completed != len(prompts) \
            or not rec["serve_metrics"] \
            or set(reply.get("alerts") or {}) < {"active", "log", "counts"}:
        fails.append(f"metrics reply: completed {completed}, "
                     f"{rec['serve_metrics']}, alerts {reply.get('alerts')}")
    if sv.get("requests") != len(prompts) \
            or stats["completed"] != len(prompts):
        fails.append(f"the serving report counts {sv.get('requests')} of "
                     f"{len(prompts)} requests")
    if rec["disabled_sources"]:
        fails.append(f"scraper sources disabled: {rec['disabled_sources']}")
    if fails:
        raise AssertionError(f"{name}: " + "; ".join(fails))
    return rec


def _a22_delta(init, worker: int, step: int) -> dict:
    """One seeded DynSGD delta of config 5's center: every leaf
    N(0, 1e-3) in f32."""
    rng = np.random.default_rng(1000 * worker + step)
    return {k: (rng.standard_normal(np.shape(v), dtype=np.float32)
                * np.float32(1e-3)) for k, v in init.items()}


def _lane_segments() -> list:
    from distkeras_tpu_torch import shm

    prefix = f"{shm.SEGMENT_PREFIX}_native"
    return sorted(s["name"] for s in shm.segment_inventory()["segments"]
                  if s["name"].startswith(prefix))


def native_shm_lane(torch):
    """``a22_native_shm_lane``: the native PS's shm ring lane at config
    5's center (``_config5_init()``, ~10.8 MB in f32, larger than the 8 MiB
    ring, so every frame streams through it) under DynSGD with IMDB_W
    workers. Host code only: no kernel runs here. Gates: (a) serial, IMDB_W
    lane clients x A22_EXCHANGES exchanges on server A and the same seeded
    deltas over TCP on server B from the same center leave bit-equal
    replies and centers, A22_EXCHANGES * IMDB_W folds on each; (b) a TCP
    client of A pulls what a lane client of A pulls; (c) the lane's int8
    pull stream equals TCP's; (d) after ``set_model`` a lane pull returns
    the new center bit-equal; (e) IMDB_W lane clients exchanging at once on
    a third server: commits = folds = A22_EXCHANGES * IMDB_W; (f) after
    ``stop()`` no ``dktshm_native*`` segment is left. Prints the median and
    min-max ms of one exchange over the lane and over TCP (host time)."""
    from distkeras_tpu_torch.native_ps import (
        NativePSClient,
        NativeSocketParameterServer,
    )
    from distkeras_tpu_torch.parallel.merge_rules import DynSGDMerge

    name = "a22_native_shm_lane"
    t_phase = time.perf_counter()
    init = _config5_init()
    W, E = IMDB_W, A22_EXCHANGES
    before = _lane_segments()

    def server():
        ps = NativeSocketParameterServer(init, DynSGDMerge(), W)
        ps.initialize()
        ps.run()
        return ps

    def drive(clients, ms):
        replies = [c.pull() for c in clients]
        for step in range(E):
            for w, c in enumerate(clients):
                d = _a22_delta(init, w, step)
                t0 = time.perf_counter()
                replies.append(c.exchange(w, d, seq=step + 1))
                ms.append((time.perf_counter() - t0) * 1e3)
        return replies

    def equal(a, b):
        return a.keys() == b.keys() and all(
            np.array_equal(a[k], b[k]) for k in a)

    gates, timing = {}, {"lane": [], "tcp": []}
    servers, clients = [], []
    try:
        a, b = server(), server()
        servers += [a, b]
        lane = [NativePSClient.connect_shm(a, w) for w in range(W)]
        tcp = [NativePSClient("127.0.0.1", b.port, w, b.spec)
               for w in range(W)]
        clients += lane + tcp
        seg_bytes = int(lane[0]._seg.size)   # the header and two rings
        lane_replies = drive(lane, timing["lane"])
        tcp_replies = drive(tcp, timing["tcp"])
        gates["a_serial_bit_equal"] = (
            all(equal(x, y) for x, y in zip(lane_replies, tcp_replies))
            and equal(a.get_model(), b.get_model())
            and a.num_updates == b.num_updates == W * E)
        del lane_replies, tcp_replies
        # (b): each probe pull is mirrored on b, which keeps the servers'
        # pull versions (DynSGD's staleness bases) equal for (c)
        probes = [NativePSClient("127.0.0.1", s.port, W, s.spec)
                  for s in (a, b)]
        clients += probes
        gates["b_one_center_two_lanes"] = equal(probes[0].pull(),
                                                lane[0].pull())
        probes[1].pull()
        tcp[0].pull()
        qa = NativePSClient.connect_shm(a, W + 1, pull_compression="int8")
        qb = NativePSClient("127.0.0.1", b.port, W + 1, b.spec,
                            pull_compression="int8")
        clients += [qa, qb]
        same = []
        for k in range(A22_INT8_PULLS):
            d = _a22_delta(init, 0, E + k)
            lane[0].commit(0, d)
            tcp[0].commit(0, d)
            same.append(equal(qa.pull(), qb.pull()))
        gates["c_int8_pull_stream_equal"] = all(same)
        fresh = {k: v + np.float32(1.0) for k, v in init.items()}
        a.set_model(fresh)
        gates["d_set_model_bit_equal"] = equal(lane[1].pull(), fresh)
        lane_live = len(_lane_segments()) - len(before)
        for c in clients:
            c.close()
        clients = []
        a.stop()
        b.stop()
        servers = []
        c = server()
        servers = [c]
        threaded = [NativePSClient.connect_shm(c, w) for w in range(W)]
        clients = list(threaded)
        errors = []

        def work(w):
            try:
                threaded[w].pull()
                for step in range(E):
                    threaded[w].exchange(w, _a22_delta(init, w, step),
                                         seq=step + 1)
            except BaseException as e:  # noqa: BLE001
                errors.append(repr(e))

        threads = [threading.Thread(target=work, args=(w,))
                   for w in range(W)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        st = c.stats()
        center = c.get_model()
        gates["e_threaded_commits_equal_folds"] = (
            not errors and st["commits"] == c.num_updates == W * E
            and all(np.isfinite(v).all() for v in center.values()))
        threaded_counts = dict(commits=st["commits"],
                               folds=c.num_updates, errors=errors)
    finally:
        for cl in clients:
            cl.close()
        for srv in servers:
            srv.stop()
    left = sorted(set(_lane_segments()) - set(before))
    gates["f_no_segment_left"] = not left
    shm_df = shutil.disk_usage("/dev/shm") if os.path.isdir("/dev/shm") \
        else None
    rec = dict(phase=name, device=SMI, host_path=True,
               center_floats=int(sum(np.size(v) for v in init.values())),
               center_mb=sum(np.asarray(v).nbytes
                             for v in init.values()) / 1e6,
               workers=W, exchanges_per_worker=E, segment_bytes=seg_bytes,
               lane_segments_live=lane_live, threaded=threaded_counts,
               left=left, gates=gates,
               dev_shm_total_mb=None if shm_df is None
               else shm_df.total / 1e6,
               exchange_ms={k: dict(n=len(v), median_ms=float(np.median(v)),
                                    min_ms=min(v), max_ms=max(v))
                             for k, v in timing.items()},
               wall_s=time.perf_counter() - t_phase)
    log(json.dumps(rec))
    log(f"{name}: one exchange at config 5's center (host time, "
        f"{SMI}): lane median {rec['exchange_ms']['lane']['median_ms']:.3f}"
        f" ms (min {rec['exchange_ms']['lane']['min_ms']:.3f}, max "
        f"{rec['exchange_ms']['lane']['max_ms']:.3f}); TCP median "
        f"{rec['exchange_ms']['tcp']['median_ms']:.3f} ms (min "
        f"{rec['exchange_ms']['tcp']['min_ms']:.3f}, max "
        f"{rec['exchange_ms']['tcp']['max_ms']:.3f})")
    fails = [k for k, ok in gates.items() if not ok]
    if fails:
        raise AssertionError(f"{name}: gates failed: {fails}")
    return rec


def _example_phase(torch, name, run):
    """``run()`` (an example twin) under the launch counters, K1's also
    by rows: ``(its result, its record)``; the record, with the card's
    name and power limit, its wall time and launches, printed as one JSON
    line."""
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    _zero_rows()
    t0 = time.perf_counter()
    out = run()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    rec = dict(phase=name, card=SMI, wall_s=time.perf_counter() - t0,
               launches=_read_rows())
    log(json.dumps(rec))
    return out, rec


def _losses_fall(losses) -> bool:
    """Finite step losses whose second half's mean is below their first
    half's (a single step at batch 32 is noisy)."""
    losses = np.asarray(losses, np.float64)
    half = len(losses) // 2
    return bool(np.all(np.isfinite(losses)) and half > 0
                and losses[half:].mean() < losses[:half].mean())


def run_example_lm(torch):
    """``examples_lm``: the LM twin at its defaults, gated on its own
    self-check (greedy, beam-4 and int8 decodes each at 0.9 continuation
    accuracy, rc 0); at its head dim (16, bf16) the small-D kernels: the
    fused backward once a block a training step (one launch serves both
    stacked workers) and K3 and K4 never, the small-D forward as often
    plus the three decodes' prefills and K2's other kernels never; and on
    the card K1 at its decode plan (M=4) and its prefill plan (M=32)."""
    from distkeras_tpu_torch.examples import lm as twin

    argv = ["--device", DEVICE]
    args = twin.parse_args(argv)
    if (args.vocab, args.dim, args.heads, args.depth, args.seq_len,
            args.workers, args.batch_size) != (
            EX_LM_VOCAB, EX_LM_DIM, EX_LM_HEADS, EX_LM_DEPTH, EX_LM_L,
            EX_LM_W, EX_LM_BATCH):
        raise AssertionError(f"examples_lm: the twin's defaults {args} are "
                             f"not the shapes checked above")
    rc, rec = _example_phase(torch, "examples_lm", lambda: twin.main(argv))
    steps = args.epochs * EX_LM_WINDOW * (
        args.rows // (args.workers * args.batch_size * EX_LM_WINDOW))
    n = rec["launches"]
    fails = [] if rc == 0 else [f"the twin's self-check failed (rc {rc})"]
    want = {"flash_attention_bwd_small": args.depth * steps,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "flash_attention": 0}
    fails += [f"{k} launched {n[k]} times, expected {v}"
              for k, v in want.items() if n[k] != v]
    if n["flash_attention_small"] < args.depth * (steps + 3):
        fails.append(f"flash_attention_small launched "
                     f"{n['flash_attention_small']} times, expected at "
                     f"least {args.depth * (steps + 3)}")
    rows = n["q_matmul_rows"]
    if DEVICE == "cuda" and not (
            rows.get(EX_LM_PROMPTS) and rows.get(
                EX_LM_PROMPTS * EX_LM_PROMPT_LEN)
            and n["q_matmul_prefill"] >= 1):
        fails.append(f"K1 not launched at M={EX_LM_PROMPTS} and "
                     f"M={EX_LM_PROMPTS * EX_LM_PROMPT_LEN}: {rows}")
    if fails:
        raise AssertionError("examples_lm: " + "; ".join(fails))
    return dict(rec, steps=steps)


def run_example_longcontext(torch):
    """``examples_longcontext``: the long-context twin at its defaults
    (one rank): the flash+remat step's loss finite, K2 twice a block (the
    forward and remat's recompute), K3 and K4 once a block; the
    sequence-parallel leg's loss and gradient norm finite."""
    from distkeras_tpu_torch.examples import longcontext as twin

    out, rec = _example_phase(torch, "examples_longcontext",
                              lambda: twin.main(["--device", DEVICE]))
    fr, sp = out["flash_remat"], out["sp"]
    want = {"flash_attention": 2 * EX_LC_DEPTH,
            "flash_attention_bwd_dq": EX_LC_DEPTH,
            "flash_attention_bwd_dkv": EX_LC_DEPTH}
    n = rec["launches"]
    fails = [f"{k} launched {n[k]} times, expected {v}"
             for k, v in want.items() if n[k] != v]
    if (fr["L"], fr["B"], fr["dim"], fr["heads"], fr["depth"]) != (
            EX_LC_L, EX_LC_B, EX_LC_DIM, EX_LC_HEADS, EX_LC_DEPTH):
        fails.append(f"the flash+remat leg ran {fr}, not the checked shape")
    if not (np.isfinite(fr["loss"]) and np.isfinite(sp["loss"])
            and np.isfinite(sp["grad_norm2"])):
        fails.append(f"non-finite results {out}")
    if fails:
        raise AssertionError("examples_longcontext: " + "; ".join(fails))
    return dict(rec, flash_remat=fr, sp=sp)


def run_example_parallelism(torch):
    """``examples_parallelism``: the six demos in a world of one (the
    meshes the twin derives for one rank), each MeshTrainer's loss
    falling, the dp demo's test accuracy printed."""
    from distkeras_tpu_torch.examples import parallelism as twin

    recs, rec = _example_phase(torch, "examples_parallelism",
                               lambda: twin.main(["--device", DEVICE]))
    bad = [k for k in ("tp", "fsdp", "pp", "sp", "ep")
           if not _losses_fall(recs[k]["losses"])]
    if list(recs) != ["dp", "tp", "fsdp", "pp", "sp", "ep"] or bad:
        raise AssertionError(f"examples_parallelism: the loss of {bad} did "
                             f"not fall: {json.dumps(recs)}")
    return dict(rec, dp_acc=recs["dp"]["acc"],
                losses={k: [v["losses"][0], v["losses"][-1]]
                        for k, v in recs.items()})


def run_example_rc(torch, name, module, argv):
    """An example twin whose ``main`` returns its self-check's exit code
    (``serve_lm``, ``train_while_serving``): gated on 0."""
    import importlib

    twin = importlib.import_module(f"distkeras_tpu_torch.examples.{module}")
    rc, rec = _example_phase(torch, name, lambda: twin.main(
        argv + ["--device", DEVICE]))
    if rc != 0:
        raise AssertionError(f"{name}: the twin's self-check failed (rc "
                             f"{rc})")
    return rec


def run_example_workflow(torch):
    """``examples_workflow``: the workflow notebook's cells read with
    ``json`` and executed in one namespace on DEVICE at its default rows;
    its last cell asserts both trainers above 0.70 test accuracy."""
    from distkeras_tpu_torch.examples import run_notebook

    old = os.environ.get("DISTKERAS_WORKFLOW_DEVICE")
    os.environ["DISTKERAS_WORKFLOW_DEVICE"] = DEVICE
    try:
        ns, rec = _example_phase(torch, "examples_workflow", run_notebook)
    finally:
        if old is None:
            os.environ.pop("DISTKERAS_WORKFLOW_DEVICE")
        else:
            os.environ["DISTKERAS_WORKFLOW_DEVICE"] = old
    if ns["DEVICE"] != DEVICE or not all(
            v > 0.70 for v in ns["results"].values()):
        raise AssertionError(f"examples_workflow: {ns['results']} on "
                             f"{ns['DEVICE']}")
    return dict(rec, accuracy=ns["results"])


def run_example_alias(torch):
    """``examples_alias``: ``import distkeras_torch`` registers the
    port's modules under the reference's import form; its ADAG is the
    port's, and nothing of JAX is loaded."""
    def check():
        import distkeras_torch
        from distkeras_torch.trainers import ADAG
        from distkeras_tpu_torch import trainers

        bad = sorted(m for m in sys.modules if m.split(".")[0] in (
            "jax", "jaxlib", "flax", "optax", "distkeras_tpu", "distkeras"))
        if not (ADAG is trainers.ADAG and distkeras_torch.ADAG is ADAG
                and distkeras_torch.trainers is trainers) or bad:
            raise AssertionError(f"examples_alias: ADAG is not the port's, "
                                 f"or {bad} loaded")
        return ADAG.__module__

    mod, rec = _example_phase(torch, "examples_alias", check)
    return dict(rec, adag_module=mod)


def run_examples(torch) -> dict:
    """The example twins at their defaults on DEVICE, each phase counting
    its own launches: ``{phase: record}``."""
    out = {"examples_lm": run_example_lm(torch)}
    torch.cuda.empty_cache()
    out["examples_longcontext"] = run_example_longcontext(torch)
    torch.cuda.empty_cache()
    out["examples_parallelism"] = run_example_parallelism(torch)
    for name, module, argv in (
            ("examples_serve_lm", "serve_lm", []),
            ("examples_serve_lm_spec", "serve_lm", ["--spec"]),
            ("examples_train_while_serving", "train_while_serving", [])):
        out[name] = run_example_rc(torch, name, module, argv)
    out["examples_workflow"] = run_example_workflow(torch)
    out["examples_alias"] = run_example_alias(torch)
    torch.cuda.empty_cache()
    return out


def _build_all(_build) -> dict:
    """Every kernel source with ``nvcc`` (``_build.build``) and, at the
    same time, the native parameter server's C++ core with ``g++``
    (``native.build``): seconds per library, the core's as ``dkps``."""
    from distkeras_tpu_torch import native

    out, errors = {}, []

    def gxx():
        try:
            out["dkps"] = native.build()
        except BaseException as e:   # re-raised below, after nvcc
            errors.append(e)

    th = threading.Thread(target=gxx)
    th.start()
    try:
        secs = _build.build()
    finally:
        th.join()
    if errors:
        raise errors[0]
    return {**secs, **out}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    if len(sys.argv) > 2 and sys.argv[1] == "--ps-rank":
        # a rank of a12_ps_two_process, started by that phase
        return ps_rank_main(sys.argv[2])
    from distkeras_tpu_torch.models import quantize_lm, transformer_lm
    from distkeras_tpu_torch.ops import _build
    from distkeras_tpu_torch.ops import flash_attention as fa
    from distkeras_tpu_torch.ops import pallas_kernels as pk
    from distkeras_tpu_torch.ops import quant
    from distkeras_tpu_torch.ops import recurrent as rec

    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 is f32
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    global SMI
    SMI = smi
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    secs = _build_all(_build)
    log(f"build: {json.dumps(secs)} total {time.perf_counter() - t0:.2f}s")
    sass = check_sass(_build)

    with torch.inference_mode():
        qrows, q_err = check_q_matmul(torch, quant)
        frows, f_err = check_flash(torch, fa)
        arows, a_err = check_adam(torch, pk)
    fwd_rows, bwd_rows, l_err = check_lstm(torch, rec)
    with torch.no_grad():
        (fa_train_rows, dq_rows, dkv_rows, small_rows, dq_err, dkv_err,
         small_err) = check_flash_bwd(torch, fa)
    check_flash_vmap(torch, fa)
    check_fused_ce(torch)
    log(f"kernel checks done at {time.perf_counter() - t0:.1f}s")
    train, test = imdb_data()
    compare_window(torch, train)

    model = transformer_lm(
        vocab=VOCAB, maxlen=MAXLEN, dim=DIM, heads=HEADS, depth=DEPTH,
        kv_heads=KV_HEADS, pos_embedding="rope", attn_impl="flash",
        dtype=torch.bfloat16, device=DEVICE, seed=0)
    qmodel = quantize_lm(model)
    torch.cuda.synchronize()

    with torch.inference_mode():
        quant.q_matmul.launches = 0
        quant.q_matmul.prefill_launches = 0
        fa._fa_forward.launches = 0
        prompts, res16, wall16, st16 = serve(torch, model, "bf16")
        _, res8, wall8, st8 = serve(torch, qmodel, "int8")
        launches = {"q_matmul": quant.q_matmul.launches,
                    "q_matmul_prefill": quant.q_matmul.prefill_launches,
                    "flash_attention": fa._fa_forward.launches}
        log(f"launches on the served path: {json.dumps(launches)}")
        if min(launches.values()) < 1:
            raise AssertionError(f"a kernel never launched on the served "
                                 f"path: {launches}")

        tie_aware_check(torch, model, prompts, res16, "bf16")
        tie_aware_check(torch, qmodel, prompts, res8, "int8")
        # the prefix-affine router over two int8 replicas registered in a
        # membership directory, one hard-killed mid-stream
        router_launches = serve_router(torch, qmodel)["launches"]
        # the front door: prefix cache, chunked prefill, SLO admission
        # with preemption, and a refill weight swap
        frontdoor = serve_frontdoor(torch, model, qmodel)
        # decoding beyond the paged engine: dense generate, beams,
        # speculation (dense and in the engine), the resilient client,
        # GeneratorPredictor
        n_tok = NEW_TOKENS * len(PROMPTS)
        decode = serve_decode(torch, model, qmodel, plain={
            "bf16": dict(tokens_per_s=n_tok / wall16, steps=st16["steps"]),
            "int8": dict(tokens_per_s=n_tok / wall8, steps=st8["steps"])})
    del model, qmodel
    torch.cuda.empty_cache()

    pk.fused_adam_step.launches = 0
    rec.lstm_forward.launches = 0
    rec.lstm_backward.launches = 0
    dynsgd_rec = train_dynsgd(torch, train, test)
    trained = {"fused_adam": pk.fused_adam_step.launches,
               "lstm_forward": rec.lstm_forward.launches,
               "lstm_backward": rec.lstm_backward.launches}
    log(f"launches on the training path: {json.dumps(trained)}")
    if min(trained.values()) < 1:
        raise AssertionError(f"a kernel never launched on the training "
                             f"path: {trained}")
    launches.update(trained)
    train_adag_lenet(torch)
    torch.cuda.empty_cache()
    log(f"slice 1-2 paths done at {time.perf_counter() - t0:.1f}s")

    compare_lm_window(torch)
    from distkeras_tpu_torch.ops import fused_ce as fce
    counters = {"flash_attention": fa._fa_forward,
                "flash_attention_bwd_dq": fa._fa_bwd_dq,
                "flash_attention_bwd_dkv": fa._fa_bwd_dkv,
                "fused_adam": pk.fused_adam_step}
    ce_counters = {"ce_fwd_rows": fce.ce_fwd_rows,
                   "ce_bwd_rows": fce.ce_bwd_rows}
    for fn in (*counters.values(), *ce_counters.values()):
        fn.launches = 0
    lm_rec = train_lm(torch)
    lm_launches = {k: fn.launches for k, fn in
                   {**counters, **ce_counters}.items()}
    log(f"launches on the LM training path: {json.dumps(lm_launches)}")
    if min(lm_launches.values()) < 1:
        raise AssertionError(f"a kernel never launched on the LM training "
                             f"path: {lm_launches}")
    launches.update({k: lm_launches[k] for k in (
        "flash_attention_bwd_dq", "flash_attention_bwd_dkv")})
    torch.cuda.empty_cache()

    for fn in counters.values():
        fn.launches = 0
    cls_trainer = train_classifier(torch)
    cls_launches = {k: counters[k].launches for k in (
        "flash_attention", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")}
    log(f"launches on the classifier training path: "
        f"{json.dumps(cls_launches)}")
    if min(cls_launches.values()) < 1:
        raise AssertionError(f"a kernel never launched on the classifier "
                             f"training path: {cls_launches}")
    # serve_decode's last run: the trained classifier served in int8
    quantized_cls = serve_quantized_classifier(torch, cls_trainer)
    del cls_trainer
    torch.cuda.empty_cache()
    log(f"training paths done at {time.perf_counter() - t0:.1f}s")

    # the parameter-server path (backend="ps"): each phase's launches are
    # counted from 0 just before it and read just after
    t_ps = time.perf_counter()
    vgg_rec, ps3 = counted(lambda: train_ps_vgg(torch))
    log(f"launches on the socket PS path: {json.dumps(ps3)}")
    log(json.dumps({"phase": "ps_config3_socket",
                    "wall_s": time.perf_counter() - t_ps}))
    torch.cuda.empty_cache()
    t_ps = time.perf_counter()
    lstm_rec, ps5 = counted(lambda: train_ps_lstm(torch, train))
    ps5_steps = PS5_W * PS5_WINDOWS * IMDB_WINDOW * PS5_EPOCHS
    log(f"launches on the in-process PS path: {json.dumps(ps5)}")
    for name in ("fused_adam", "lstm_forward", "lstm_backward"):
        if ps5[name] != ps5_steps:
            raise AssertionError(f"in-process PS: {name} launched "
                                 f"{ps5[name]} times, expected {ps5_steps} "
                                 f"(one a step a worker)")
    log(json.dumps({"phase": "ps_config5_inprocess",
                    "wall_s": time.perf_counter() - t_ps}))
    t_ps = time.perf_counter()
    compare_ps_window(torch, train)
    log(json.dumps({"phase": "ps_one_worker_parity",
                    "wall_s": time.perf_counter() - t_ps}))
    t_ps = time.perf_counter()
    run_mnist_twin()
    log(json.dumps({"phase": "mnist_twin",
                    "wall_s": time.perf_counter() - t_ps}))
    torch.cuda.empty_cache()

    # the pipelined exchange and the native and shm transports; config 3's
    # runs are gated after the kernels line (ps3_failures), so a run that
    # does not learn still leaves every kernel's numbers printed
    t_ps = time.perf_counter()
    _, ps5p = counted(lambda: train_ps_lstm_native_pipelined(
        torch, train, lstm_rec))
    log(f"launches on the native pipelined PS path: {json.dumps(ps5p)}")
    for name in ("fused_adam", "lstm_forward", "lstm_backward"):
        if ps5p[name] != ps5_steps:
            raise AssertionError(f"native pipelined PS: {name} launched "
                                 f"{ps5p[name]} times, expected "
                                 f"{ps5_steps} (one a step a worker)")
    log(json.dumps({"phase": "ps_config5_native_pipelined",
                    "wall_s": time.perf_counter() - t_ps}))
    t_ps = time.perf_counter()
    compare_ps_pipeline(torch, train)
    log(json.dumps({"phase": "ps_pipeline_parity",
                    "wall_s": time.perf_counter() - t_ps}))
    torch.cuda.empty_cache()
    t_ps = time.perf_counter()
    vgg_runs = train_ps_vgg_transports(torch)
    log(json.dumps({"phase": "ps_config3_transports",
                    "wall_s": time.perf_counter() - t_ps}))
    torch.cuda.empty_cache()

    # the resilience layer on config 5: chaos over the socket PS with a
    # WAL, a standby failover, the native PS's C++ WAL (each counts its
    # own launches and gates them)
    resilience = {}
    for name, fn in (
            ("config5_chaos_socket",
             lambda: train_ps_lstm_chaos(torch, train, lstm_rec)),
            ("config5_failover",
             lambda: train_ps_lstm_failover(torch, train)),
            ("config5_native_wal",
             lambda: train_ps_lstm_native_wal(torch, train, lstm_rec))):
        resilience[name] = fn()
        log(f"launches on the {name} path: "
            f"{json.dumps(resilience[name]['launches'])}")
        torch.cuda.empty_cache()

    # the sharded center: config 5 over chained socket shards with a shard
    # killed, one worker sharded against unsharded, config 3 over native
    # shards (gated after the kernels line, as config 3's other runs)
    sharded = {}
    for name, fn in (
            ("config5_sharded_chain",
             lambda: train_ps_lstm_sharded_chain(
                 torch, train, resilience["config5_failover"])),
            ("sharded_parity", lambda: compare_ps_sharded(torch, train)),
            ("config3_sharded_native",
             lambda: train_ps_vgg_sharded_native(
                 torch, vgg_runs["config3_native"][0])[0])):
        t_ps = time.perf_counter()
        sharded[name] = fn()
        log(f"launches on the {name} path: "
            f"{json.dumps(sharded[name]['launches'])}")
        log(json.dumps({"phase": f"ps_{name}",
                        "wall_s": time.perf_counter() - t_ps}))
        torch.cuda.empty_cache()
    log(f"parameter-server paths done at {time.perf_counter() - t0:.1f}s")

    # checkpoints and the center's EMA, each phase counting and gating its
    # own launches: config 5 collective checkpointed, resumed and
    # averaged; config 5 through the PS with a barrier checkpoint, a
    # worker restored from it, the EMA and a resume
    ckema: dict = {}
    for name, fn in (
            ("config5_resume_collective",
             lambda: train_resume_collective(torch, train)),
            ("config5_ema_collective",
             lambda: train_ema_collective(
                 torch, train, ckema["config5_resume_collective"])),
            ("ps_config5_checkpoint_ema",
             lambda: train_ps_checkpoint_ema(torch, train))):
        t_ps = time.perf_counter()
        ckema[name] = fn()
        log(f"launches on the {name} path: "
            f"{json.dumps(ckema[name]['launches'])}")
        log(json.dumps({"phase": name,
                        "wall_s": time.perf_counter() - t_ps}))
        torch.cuda.empty_cache()
    ckema["ps_config5_checkpoint_ema_resume"] = {
        "launches": ckema["ps_config5_checkpoint_ema"]["resume_launches"]}
    log(f"checkpoint and EMA paths done at {time.perf_counter() - t0:.1f}s")

    # elastic membership on config 5, each phase counting and gating its
    # own launches: a live join and a preemption drain on the in-process
    # and the socket PS (with a WAL), on the native PS pipelined and over
    # socket shards; the autoscaler growing the pool
    elastic: dict = {}
    t_ps = time.perf_counter()
    for name, rec in train_ps_lstm_elastic(torch, train).items():
        elastic[f"config5_elastic_{name}"] = rec
    log(json.dumps({"phase": "ps_config5_elastic",
                    "wall_s": time.perf_counter() - t_ps}))
    for name, fn in (
            ("config5_elastic_native_pipelined",
             lambda: train_ps_lstm_elastic_native_pipelined(
                 torch, train, elastic["config5_elastic_inprocess"])),
            ("config5_elastic_sharded",
             lambda: train_ps_lstm_elastic_sharded(torch, train)),
            ("config5_autoscale",
             lambda: train_ps_lstm_autoscale(torch, train))):
        t_ps = time.perf_counter()
        elastic[name] = fn()
        log(json.dumps({"phase": f"ps_{name}",
                        "wall_s": time.perf_counter() - t_ps}))
        torch.cuda.empty_cache()
    for name, rec in elastic.items():
        log(f"launches on the {name} path: {json.dumps(rec['launches'])}")
    log(f"elastic paths done at {time.perf_counter() - t0:.1f}s")

    # the membership directory on config 5, each phase counting and gating
    # its own launches: the elastic sharded run with a hosted directory, a
    # shard primary and the directory primary killed; a trainer that finds
    # an external fleet through its directory alone
    directory_runs: dict = {}
    for name, fn in (
            ("ps_config5_directory_chaos",
             lambda: train_ps_lstm_directory_chaos(torch, train)),
            ("ps_config5_ps_directory",
             lambda: train_ps_lstm_ps_directory(torch, train))):
        directory_runs[name] = fn()
        torch.cuda.empty_cache()
    directory_runs["serve_router_int8"] = {"launches": router_launches}
    log(f"directory paths done at {time.perf_counter() - t0:.1f}s")

    # the model families: ResNet with sync and per-worker BatchNorm, the
    # SRU and MoE classifiers (K5 on each), config 9 with remat (K2-K5)
    a10 = run_a10(torch, train, dynsgd_rec)
    log(f"model family paths done at {time.perf_counter() - t0:.1f}s")
    # one model over a mesh: MeshTrainer on config 9 and on config 6
    # (fsdp+megatron, with a .dkc resume), the three strategies
    a12 = run_a12(torch, train)
    log(f"mesh paths done at {time.perf_counter() - t0:.1f}s")
    # W workers over processes: config 5 and config 9 through mesh=
    # against mesh=None, the multi-process PS in two processes
    a122 = run_a122(torch, train, lm_rec)
    log(f"W-over-processes paths done at {time.perf_counter() - t0:.1f}s")
    # deploy streaming: train, stream versions, canary, promote, roll back
    a13 = {"a13_deploy_stream": train_a13_deploy_stream(torch)}
    log(f"deploy path done at {time.perf_counter() - t0:.1f}s")
    # observability: config 5's PS path analyzed and watched (socket, with
    # the CLI scraping it live; native, with the C++ span ring), the
    # served decoder traced and watched, the rollout on a watchtower
    t_obs = time.perf_counter()
    for name, fn in (
            ("a13_observe_ps_config5",
             lambda: train_a13_observe_ps(torch, train, ps5_steps)),
            ("a13_observe_native_config5",
             lambda: train_a13_observe_native(torch, train, ps5_steps)),
            ("a13_watch_serving", lambda: serve_a13_watched(torch)),
            ("a13_watch_rollout",
             lambda: train_a13_deploy_stream(torch, watched=True))):
        t_ps = time.perf_counter()
        a13[name] = fn()
        log(json.dumps({"phase": name,
                        "wall_s": time.perf_counter() - t_ps}))
        torch.cuda.empty_cache()
    log(json.dumps({"phase": "a13_observability",
                    "wall_s": time.perf_counter() - t_obs}))
    log(f"observability paths done at {time.perf_counter() - t0:.1f}s")
    # the native PS's shm ring lane at config 5's center (host code: no
    # kernel runs there, so no launch is counted)
    native_shm_lane(torch)
    log(f"shm lane path done at {time.perf_counter() - t0:.1f}s")
    # the example twins at their own defaults: the LM (K1-K4), long
    # context (K2-K4 at L=4096), the parallelism portfolio in a world of
    # one, serving with and without speculation, train-while-serving, the
    # workflow notebook and the distkeras_torch alias
    t_ex = time.perf_counter()
    examples = run_examples(torch)
    log(json.dumps({"phase": "examples",
                    "wall_s": time.perf_counter() - t_ex}))
    log(f"example paths done at {time.perf_counter() - t0:.1f}s")

    def total(rows, pick, key):
        vals = [r[key] * w for r, w in pick(rows)]
        return None if any(v is None for v in vals) else sum(vals)

    def decode_step(rows):    # one decode step's q_matmul calls at M=8
        return [(r, PER_STEP[(r["K"], r["N"])]) for r in rows
                if r["M"] == 8 and r["dtype"] == "bfloat16"
                and r["model"] == "lm"]

    def prefill_1024(rows):   # one 1024-token prefill's calls (8 layers, head)
        return [(r, PER_STEP[(r["K"], r["N"])]) for r in rows
                if r["M"] == 1024 and r["dtype"] == "bfloat16"
                and r["model"] == "lm"]

    def served_prefill(rows):  # one layer's prefill attention, 4 prompts
        return [(r, 1) for r in rows if (r["B"], r["H"], r["Hkv"]) ==
                (1, HEADS, KV_HEADS) and r["L"] in SERVED_LENGTHS]

    def one_launch(rows):      # one launch at the collective path's shapes
        return [(r, 1) for r in rows if r.get("path") != "ps"]

    def lm_shape(rows):        # one launch at config 9's training shape
        return [(r, 1) for r in rows
                if (r["L"], r["D"]) == (LM_L, LM_DIM // LM_HEADS)]

    def twin_shape(rows):      # one launch at the LM twin's training shape
        return [(r, 1) for r in rows if r.get("route") == "small" and (
            r["B"], r["L"], r["D"]) == (EX_LM_W * EX_LM_BATCH, EX_LM_L,
                                        EX_LM_DIM // EX_LM_HEADS)]

    # the small-D kernels run on the LM twin's path (examples_lm)
    for name in ("flash_attention_small", "flash_attention_bwd_small"):
        launches[name] = examples["examples_lm"]["launches"][name]
    small_fwd_rows = [r for r in frows + fa_train_rows
                      if r.get("route") == "small"]
    small_fwd_err = max(r["max_abs_err"] for r in small_fwd_rows)

    decode_runs = {f"serve_decode_{kind}_{k}": v["launches"]
                   for kind in ("dense", "engine", "predictor")
                   for k, v in decode[kind].items()}
    decode_runs["serve_decode_quantized_classifier"] = \
        quantized_cls["launches"]
    sass_for = dict(sass, lstm_backward=dict(
        dwh=sass["lstm_backward"], scan=sass["lstm_backward_scan"],
        direct_scan=sass["lstm_backward_direct_scan"]))
    kernels = []
    for name, src, replaces, rows, pick, err in (
            ("q_matmul", "distkeras_tpu_torch/csrc/quant.cu",
             "distkeras_tpu/ops/quant.py:93", qrows, decode_step, q_err),
            ("q_matmul_prefill", "distkeras_tpu_torch/csrc/quant.cu",
             "distkeras_tpu/ops/quant.py:93", qrows, prefill_1024, q_err),
            ("flash_attention", "distkeras_tpu_torch/csrc/flash_attention.cu",
             "distkeras_tpu/ops/flash_attention.py:146", frows,
             served_prefill, f_err),
            ("fused_adam", "distkeras_tpu_torch/csrc/adam.cu",
             "distkeras_tpu/ops/pallas_kernels.py:36", arows, one_launch,
             a_err),
            ("lstm_forward", "distkeras_tpu_torch/csrc/lstm.cu",
             "distkeras_tpu/ops/recurrent.py:75", fwd_rows, one_launch,
             max(r["max_abs_err"] for r in fwd_rows)),
            ("lstm_backward", "distkeras_tpu_torch/csrc/lstm.cu",
             "distkeras_tpu/ops/recurrent.py:109", bwd_rows, one_launch,
             max(r["max_abs_err"] for r in bwd_rows)),
            ("flash_attention_bwd_dq",
             "distkeras_tpu_torch/csrc/flash_attention_bwd.cu",
             "distkeras_tpu/ops/flash_attention.py:336", dq_rows, lm_shape,
             dq_err),
            ("flash_attention_bwd_dkv",
             "distkeras_tpu_torch/csrc/flash_attention_bwd.cu",
             "distkeras_tpu/ops/flash_attention.py:426", dkv_rows, lm_shape,
             dkv_err),
            ("flash_attention_small",
             "distkeras_tpu_torch/csrc/flash_attention.cu",
             "distkeras_tpu/ops/flash_attention.py:146", small_fwd_rows,
             twin_shape, small_fwd_err),
            ("flash_attention_bwd_small",
             "distkeras_tpu_torch/csrc/flash_attention_bwd.cu",
             "distkeras_tpu/ops/flash_attention.py:336", small_rows,
             twin_shape, small_err)):
        by_bytes = sum(r["bound_ms"] * w for r, w in pick(rows)
                       if r["bound_by"] == "bytes")
        bound_ms = total(rows, pick, "bound_ms")
        ps_rows = [r for r in rows if r.get("path") == "ps"]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=err,
            ms=total(rows, pick, "kernel_ms"),
            plain_ms=total(rows, pick, "plain_ms"),
            bound_ms=bound_ms,
            bound_by="bytes" if by_bytes >= 0.5 * bound_ms else "operations",
            library_ms=total(rows, pick, "library_ms"),
            checked=True,
            **({k: total(rows, pick, k) for k in ("scan_ms", "dwh_ms")}
               if "scan_ms" in rows[0] else {}),
            ps_launches={"config3_socket": ps3[name],
                         "config5_inprocess": ps5[name],
                         **{k: v[1][name] for k, v in vgg_runs.items()},
                         "config5_native_pipelined": ps5p[name],
                         **{k: v["launches"][name]
                            for k, v in resilience.items()},
                         **{k: v["launches"][name]
                            for k, v in sharded.items()}},
            checkpoint_ema_launches={k: v["launches"][name]
                                     for k, v in ckema.items()},
            elastic_launches={k: v["launches"][name]
                              for k, v in elastic.items()},
            directory_launches={k: v["launches"][name]
                                for k, v in directory_runs.items()},
            frontdoor_launches={f"serve_frontdoor_{k}":
                                frontdoor[k]["launches"][name]
                                for k in ("int8", "bf16")},
            decode_launches={k: v[name] for k, v in decode_runs.items()},
            a10_launches={k: v["launches"][name] for k, v in a10.items()},
            a12_launches={k: v["launches"][name] for k, v in a12.items()},
            a12_2_launches={k: v["launches"][name]
                            for k, v in a122.items()},
            a13_launches={k: v["launches"][name] for k, v in a13.items()},
            examples_launches={k: v["launches"][name]
                               for k, v in examples.items()},
            **({"ps_shape": ps_rows[0]} if ps_rows else {}),
            **({"replaces_also": "distkeras_tpu/ops/flash_attention.py:426"}
               if name == "flash_attention_bwd_small" else {}),
            shapes=[r for r, _ in pick(rows)] if name == "q_matmul_prefill"
            else rows,
            **({"sass": sass_for[name]} if name in sass_for else {})))
    print(json.dumps({"kernels": kernels}), flush=True)
    failures = ps3_failures("config3_socket", vgg_rec, ps3, False)
    for name, (rec3, launches3) in vgg_runs.items():
        failures += ps3_failures(name, rec3, launches3, True)
    rec3 = sharded["config3_sharded_native"]
    failures += ps3_failures("config3_sharded_native", rec3,
                             rec3["launches"], True)
    failures += ps3_sharded_failures(rec3)
    if failures:
        raise AssertionError("config 3's gates failed: "
                             + "; ".join(failures))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
