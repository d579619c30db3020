#!/usr/bin/env python3
"""On-card smoke check of the PyTorch + CUDA port (``federated_pytorch_test_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX.  Phases, each of
which stops the script with a non-zero exit if it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``csrc/infonce.cu``, ``csrc/gram.cu`` and ``csrc/quant.cu`` with
   ``nvcc`` for ``sm_90a``, the three compilers started together (the
   ptxas reports on one line each, the build seconds), in a thread while
   phases 15-21, which launch no hand-written kernel, run; phase 3 and
   the rest follow them;
3. InfoNCE kernels vs plain: the forward and backward kernels against
   their plain PyTorch versions at the CPC path's shape (D=4096, P=9), at
   D=8/P=1, D=4099/P=130, D=256/P=1000, with an all-zero column in Z and
   in Zhat, on each side of ``plan``'s threshold (P=32 takes the cluster
   branch, P=33 the rows branch), at D=100,003/P=9 (a block's rows in
   tiles) and at D=20,000/P=4 and D=10,000/P=13 (a backward tile of more
   rows than a block's threads form at once), each case printed with its
   branch; at the path's shape three runs of both kernels equal bit for
   bit; then, at the path's shape, the time per call of kernel and plain
   version from CUDA events around 200 back-to-back calls (``ms``, host
   launch cost included), the kernels' device time from ``torch.profiler``
   (``device_ms``), the device kernels a call from a CUDA graph capture
   of one call (``device_kernels``, which must be 1; every profiler window
   is logged with the records it lost), the host-only time per call
   (``host_ms``: ``time.perf_counter`` around the calls, read before the
   device is synchronised), the card's bound, and the device time of the
   same calls on the rows branch, the first design's kernels
   (``rows_branch_device_ms``);
4. Gram kernel vs plain: ``gram`` against ``gram_plain`` at [10, 928] (the
   ResNet18 stem block's shard), [10, 2,360,320] (the largest block's
   shard), [1, 1], [3, 513], [16, 100,003], [128, 4,096], K = 17 and 33
   (tiled), n under one pipeline stage ([10, 300], [17, 700]), a slab with
   an all-zero row, column slabs ``w[:, 3:3+n]`` of a wider [10, n+8]
   matrix (rows off 16-byte alignment) at n = 928 and 100,003, and a row
   stride that is not a multiple of 4, within
   ``|kernel - plain| <= 1e-5 * max_i G_ii + 1e-6``, symmetric, repeating
   bit for bit; then three calls back to back at other n and the first
   again (the cross-block counter resets, G repeats bit for bit).  At the
   largest shard and at the stem: the time per call of the kernel and of
   ``torch.matmul(a, a.T)`` (TF32 off; the library yardstick), taken in
   turns, the plain version's, the kernel's device time, the host-only
   time per call, the device kernels per call (1, from a graph capture)
   and the bound;
5. slice 1 at full width: ``drivers.federated_cpc`` with its defaults
   (K=4, Lc=256, Rc=32, batch 128, patch 32, Niter=10, Nloop=1, Nadmm=1:
   one rotation of 4 communication rounds; nothing cut), with the InfoNCE
   launch counts set to 0 just before and read just after; every round's
   loss and dual residual finite, every trained block changed, both
   kernels launched;
6. slice 1's own data: the CPC loss and its gradient in the predictor's
   flat vector, at the initial weights and one real minibatch, through the
   kernels and through the plain versions;
7. a profile of one L-BFGS step per CPC sub-model at full width: host wall
   time, device busy time and the InfoNCE kernels' share (printed only);
8. slice 2 at full width: ``drivers.consensus_multi`` (ADMM consensus,
   ResNet18, K=10 clients, batch 128, float32, krum with
   ``--robust-chunked`` over a 2-shard client mesh), with the Gram launch
   count set to 0 just before and read just after.  Cut: Nloop 12 -> 1 and
   Nadmm 5 -> 1 (one rotation over the 10 blocks, 10 rounds; Nadmm 2
   until slice 10, whose phase 32 needed the time), 1,280
   training images per client instead of 5,000, 1,000 test images; the
   data is the synthetic CIFAR-10 (the dataset is not in the repository).
   Every round's loss and residuals finite, every block changed, the Gram
   kernel launched in every round;
9. slice 2's own data: at the largest block's ([54,59], N = 4,720,640)
   first comm round, the real ``y + rho*x`` stack's shard Grams through
   the kernel and through ``gram_plain`` within the tolerance of phase 4,
   and krum's selection both ways.  Selections that differ fail, unless
   the float32 tie band of a score reaches the spread of all the scores:
   then krum is undecidable in float32 on that stack (on the synthetic
   data the clients move alike), which is printed as "undecided" and not
   counted as a pass.  Then the same stack with f clients (krum's
   attacker count) moved away, by a seeded offset that clears the others'
   scores by at least 100 tie bands: the shard Grams within tolerance,
   krum dropping exactly the moved clients through the kernel and through
   ``gram_plain`` alike, and the engine's krum estimate equal to the kept
   clients' mean;
10. a profile of one Adam step of all K clients on the stem block and on
    the largest block (printed only);
11. quantize (B1) and dequantize-accumulate (B2) kernels vs plain: at
    [9,220, 256] (the largest block's shard at D=2) with qmax 127 and 7,
    [4, 256] (the stem block's shard), [1, 2], [3, 130], [33, 64],
    [7, 512], [37, 1,000] and [5, 2,048],
    each with a zero row and a saturating row, and a row holding inf and
    NaN (its scale only: the cast of NaN to int8 has no defined value).
    Scale and q exactly equal; B2 bit for bit out of place, into a given
    ``out`` and in place (``out=acc``).  Then at [9,220, 256], over a ring
    of inputs larger than the L2 cache: the time per call of B2 out of
    place against ``torch.addcmul`` and in place against
    ``Tensor.addcmul_`` (each pair taken in turns), B1's, the device and
    host-only times, the plain versions' time and the bound;
12. slice 3 at full width: ``drivers.consensus_multi`` with ResNet18,
    ``--compress q8 --fused-collective --num-devices 2`` and slice 2's cuts
    (10 rounds), the B1/B2 launch counts set to 0 just before and read just
    after.  Every round's loss and residuals finite, every block changed,
    both kernels launched in every round, ``bytes_fused`` equal to the byte
    model and ``bytes_on_wire`` to K times the codec's payload;
13. slice 3's own data: at the largest block's first comm round, the real
    ``y + rho*x`` stack's fused mean through the kernels and through the
    plain versions bit for bit equal, at D=2 (butterfly) and D=5 (ring),
    both within ``(log2 D + 1)`` grid steps of the dense mean;
14. a profile of one comm step (encode, fused mean with the hops
    accumulating in place, ADMM update) at the largest block (printed
    only);
15. slice 4 at full width: ``drivers.federated_multi`` (FedAvg, ResNet18,
    K=10, batch 128, float32, Adam lr 1e-3, biased_input) with
    ``--compress topk --topk-frac 0.1 --error-feedback --fused-collective
    --num-devices 2`` (the sparse fused mean) and slice 2's cuts (Nloop
    12 -> 1, Nadmm 3 -> 2: 20 rounds; 1,280 training images per client,
    1,000 test images, synthetic CIFAR-10).  topk_frac is 0.1, not the
    default 0.01: at 1% the stem block ships only BatchNorm parameters,
    FedAvg's write-back zeroes the stem convolution and the next backward
    pass is NaN, in the JAX package as in the port.  Every round's loss and
    dual residual finite, every block changed, every client holding z in
    the active block after every round, ``bytes_on_wire`` = K*8k and
    ``bytes_fused`` = (D-1)*K*8k at every N (37,765,120 twice at the
    largest block).  Then, on the largest block's first comm round, at
    the run's k and at the 1% k from the same EF input: the selection on
    the card equal to the CPU's and to a numpy stable sort (indices and
    order), also on a row built with 100 ties at the k-th magnitude; the
    sparse fused mean three times bit for bit, bit for bit the CPU's, and
    within ``TOPK_MEAN_REL`` of the float64 dense mean of the
    reconstructions; the byte models at both k (3,776,480 twice at 1%);
    the selection, encode and sparse-mean times;
16. ``drivers.no_consensus_multi`` on ResNet18 (the whole net trains, Adam
    afresh every epoch), Nepoch 20 -> 2 with the data cuts of phase 15:
    both epochs finite, every parameter tensor changed, Adam's step count
    restarting at 1 in every epoch; the epoch times and the peak device
    memory;
17. ``drivers.fedprox_multi`` on ResNet18, Nloop 12 -> 1, Nadmm 5 -> 1 (10
    rounds), the data cuts, with ``--be-verbose``: finite, every block
    changed, z never written back; one ``verbose:`` line an epoch
    (blocks x Nadmm x Nepoch = 10), each at its round's block and nadmm
    with K losses, and a round's lines summed over its epochs and its
    clients equal to its record's ``loss`` within the four-digit print;
18. ``drivers.federated_multi --model net --optimizer lbfgs``, Nloop 12 ->
    1, Nadmm 3 -> 1 (5 rounds), the data cuts: finite, every block
    changed, the closure evaluations of every L-BFGS step counted;
19. ``drivers.accuracy_comparison.run_comparison`` at its defaults (K=10,
    Nadmm 3, batch 64, 1,024 images a client, 2,048 test images, the
    synthetic multi-prototype data) but Nloop 3 -> 1: the four final
    accuracies, every curve finite and not empty;
20. slice 5: ``drivers.federated_vae`` (layer-wise FedAvg on
    ``AutoEncoderCNN``, K=10, batch 128, latent 10, biased_input, Adam lr
    1e-3, Nadmm 3) cut Nloop 12 -> 1 (12 layers x 3 = 36 rounds), 1,280
    training images per client, 1,000 test images, with every kernel's
    launch count set to 0 just before and read just after (none
    launches).  Every round's loss and dual residual finite, every layer
    changed, each client's final mean test ELBO per sample finite; the
    round times, the peak device memory.  Then the first round once more
    on the card and on the CPU in this process, from the same weights and
    the same noise (drawn on the CPU): its loss and z's update from the
    common init within ``VAE_FIRST_ROUND_TOL`` (relative) of the CPU's
    (cuDNN against the CPU, TF32 off);
21. slice 5: ``drivers.federated_vae_cl`` (FedAvg on ``AutoEncoderCNNCL``,
    K=1, Kc=10, Lc=32, batch 128, Nadmm 3; L-BFGS history 10 and 4
    iterations on the encoder and decoder, Adam lr 1e-4 on the latent
    block, lambda2 1e-3) cut Nloop 12 -> 1 (3 blocks x 3 = 9 rounds) and
    the data cuts of phase 20: the checks of phase 20, and the closure
    evaluations of every L-BFGS step counted.

22. slice 6, krum under attack: ``drivers.consensus_multi`` on ResNet18
    (slice 2's configuration and data cuts, Nadmm 5 -> 2: 20 rounds) with
    ``--trim-frac 0.25 --participation 0.8 --fault-spec
    corrupt=0.2,mode=scale,scale=100,seed=3 --update-guard
    --quarantine-rounds 1``, the Gram count set to 0 just
    before and read just after.  Every round finite; every round's
    exchanged count (``n_active``) and ``fault_corrupted``, and the
    activity and corruption vectors the engine used, equal a numpy replay
    of the participation (tag 11), fault (tag 47) and quarantine ledgers,
    the guard's verdicts read from the recorded rounds; the Gram kernel
    launched twice in every round with an exchange and never without one;
    the guard's bound equal to its replay (+inf in a block's first round,
    then the EMA of the accepted norms) and every verdict equal to one
    recomputed from the round's own updates against that bound (how many
    corrupted updates trip it from a block's second round is printed, not
    checked: the first round calibrates the bound on parameter norms, see
    PERF.md section 6); in a block's first round krum selects no corrupted
    client whenever they number at most its f = floor(0.25 m) (rounds with
    more are printed, not counted); at the largest block's first round
    the captured shard slabs, absent clients' rows zeroed, through
    ``gram`` and ``gram_plain`` within the tolerance of phase 4;
23. slice 6, async rounds with churn: ``drivers.federated_multi`` on
    ResNet18 with ``--compress q8 --error-feedback --fused-collective
    --num-devices 2 --async-rounds --max-staleness 2 --staleness-alpha 0.5
    --fault-spec delay=0.4,drop=0.1,join=0.2,leave=0.1,seed=5`` (Nadmm 3 ->
    2, 20 rounds), the B1/B2 counts set to 0 just before and read just after.
    ``async_arrived``, ``admission_rejected``, ``buffer_depth``,
    ``staleness_hist``, ``members_active``, ``joined`` and ``left`` equal a
    numpy replay of the schedule in every round; B1 and B2 launched in
    every round that admits an update and in no other; at the first round
    with a fractional (stale) weight, the weighted fused mean through the
    kernels bit for bit the plain versions' and within ``(log2 D + 1)``
    grid steps of the dense weighted mean;
24. slice 6, population cohorts: ``drivers.federated_multi`` on ResNet18
    with ``--population 40 --cohort-sampling stratified --participation 0.9
    --compress q8 --error-feedback`` (Nadmm 2, 20 rounds): every round's
    cohort equal to ``sample_cohort`` replayed; at every cohort rotation a
    client sampled again within the block holds the error-feedback and
    stream rows it left with, bit for bit (digests of the rows), and a
    client new to the block its slot's fresh rows;
25. slice 6, preemption and resume, in child processes that set
    ``CUBLAS_WORKSPACE_CONFIG`` and ``torch.use_deterministic_algorithms``
    before their first cuBLAS handle: ``consensus_multi --model net
    --participation 0.7 --update-guard --midrun-checkpoint`` (Nadmm 5 -> 3,
    15 rounds) with ``--fault-spec drop=0.1,preempt=0.1,seed=S``, S picked
    with ``round_preempt`` so the preemption fires inside a block past the
    first.  Child 1 exits on ``CollectiveTimeoutError`` at the predicted
    round; child 2 (``--load-model``) resumes and finishes; a reference
    child, started beside child 1, runs the spec without ``preempt=``.  Histories and end-of-run
    checkpoints bit for bit equal; then, with the newest mid-run slot's
    checksum damaged, a resume falls back to the older slot and still
    ends bit for bit equal.

26. slice 7, the CPC under attack: ``drivers.federated_cpc`` at its
    defaults (K=4, Lc=256, Rc=32, batch 128, patch 32, Niter=10; nothing
    cut) with ``--Nadmm 2 --participation 0.75 --fault-spec
    corrupt=0.25,mode=scale,scale=100,seed=3 --update-guard
    --quarantine-rounds 1 --robust-agg krum --trim-frac 0.25
    --robust-chunked --num-devices 2`` and ``--obs-dir`` (8 rounds), the
    B3, B4 and B5 counts set to 0 just before and read just after.  Every
    round finite; every round's ``n_active``, ``fault_corrupted`` and
    ``quarantined`` equal a numpy replay of the participation (tag 11),
    fault (tag 47) and quarantine ledgers keyed on the rotation's flat
    block index, the guard's verdicts read from the stream's client
    records; B4 and B5 launched in every round in which a client trains
    and in no other, B3 twice in every round with an exchange; the first
    exchange's shard slabs through ``gram`` and ``gram_plain`` within the
    tolerance of phase 4; every line of the JSONL valid under the port's
    ``validate_record``, one ``round`` and one ``client`` record a round in
    file order.  Then the first round once more under ``--profile-dir``:
    the Chrome trace holds its ``record_function`` span; the device-busy
    share of the span is printed, not checked;
27. slice 7, supervised CPC preemption, in child processes set up as
    phase 25's: the defaults with ``--Nadmm 2 --async-rounds
    --max-staleness 2 --fault-spec delay=0.3,join=0.2,leave=0.1,
    preempt=0.15,seed=S --max-restarts 2 --restart-backoff 0.5``, S picked
    with ``round_preempt`` so the preemption fires inside a block past the
    first (a resumed segment arms none), and beside it the same spec
    without ``preempt=``.  Histories (``*_seconds`` stripped) and end-of-run
    checkpoints bit for bit equal; the preempted stream's control records
    exactly one ``restart`` (attempt 1 at the preempted round, backoff
    ``restart_backoff_seconds(0.5, 69, 1)``, between 0.25 and 0.75 s), no
    ``ladder_override``; the port's ``control.replay`` returns 0 on it;
28. slice 7, classifier chaos with the shield rung:
    ``drivers.consensus_multi --model resnet18`` (ADMM) with slice 2's
    configuration and cuts (Nadmm 2, 20 rounds) and ``--compress q8
    --error-feedback --fused-collective --num-devices 2 --async-rounds
    --max-staleness 2 --fault-spec corrupt=0.5,mode=inf,clients=3,seed=3,
    delay=0.25,delay_max=1 --health-action abort --health-streak 1
    --health-residual --control act --max-restarts 2 --restart-backoff 0``
    (the JAX package's chaos acceptance at full width, with the attack
    ``CHAOS_ARGV``'s comment explains), the B1/B2 counts set to 0 just
    before and read just after.  The run completes every round with finite
    parameters; the first run and restart 1 run q8 without the guard,
    restart 2 q4 with the guard and quarantine 2 (the shield rung, capped
    at q4 by the fused collective); ``restart`` records at attempts 1 and
    2; the ``ladder_override`` set {compress -> q4, update_guard -> True,
    quarantine_rounds -> 2}, each at ladder stage 1; no control record
    with ``time_unix``; the port's replay returns 0 on the stream and 1 on
    a copy with one backoff forged; B1 and B2 launched in every exchanging
    round;
29. slice 8, serving at full width: slice 2's krum consensus (ResNet18,
    K=10, D=2, the data cuts) with Nadmm 1 (10 rounds) and ``--serve-spec
    qps=8,round_minutes=0.5,buckets=8+32+128,swap_every=2,drift_at=6,
    seed=5 --control act --health-action warn --health-window 2
    --health-streak 1``, the B3 count set to 0 just before and read just
    after.  One ``serve`` record a round whose pure fields equal
    ``ServeSchedule.record_fields``; the port's replay returns 0 on the
    stream; the publishes fall on the schedule's swap rounds plus the
    forced refreshes (ceil(10 / 2) + 1), and the last version is the
    schedule's; a ``serve_drift`` alert, a ``serve_swap`` control on its
    round and ``forced_refresh`` on the next round's serve record; the
    predictor's shapes within the buckets; the served logits of one pool
    batch a bucket within ``SERVE_LOGIT_RTOL`` of a float32 CPU forward of
    the same consensus; B3 launched every round.  Prints the latencies,
    QPS and swap gaps the card measured;
30. slice 8, a soak campaign at full width through the soak harness:
    ``drivers.federated_multi --model resnet18 --compress q8
    --error-feedback --fused-collective --num-devices 2 --update-guard``
    with ``--campaign-spec`` ``SOAK_SPEC`` (5 virtual hours, storms,
    bursts, churn, a preemption at hour 3) ``--campaign-accel 3600
    --max-restarts 1 --restart-backoff 1`` (Nadmm 1, 10 rounds), the B1/B2
    counts set to 0 just before and read just after.  Exactly one
    ``restart``, at round 6 with the seeded backoff; the port's replay
    accepts the two-segment stream (campaign and supervisor records);
    every round's ``n_active``, ``fault_*``, ``members_active``,
    ``joined`` and ``left`` equal a numpy replay of the schedule's draws
    (the guard's verdicts read from the client records); the parameters
    and losses finite; the virtual clock waited the recorded backoff over
    3600 in wall time; B1 and B2 launched in every exchanging round.
31. slice 9, the readers on the card's streams and the full-batch L-BFGS.
    Phases 28-30 copy their streams to ``build/streams/`` before they
    delete their directories; on each, the port's readers run as a user
    runs them (``python -m federated_pytorch_test_tpu_torch.obs.report
    --json``, ``.obs.trace -o``, ``.obs.clients --json``, ``.obs.profile
    --json``, all in parallel), each exiting 0: the report's round count
    and ``bytes_on_wire`` total equal the stream's own, the trace passes
    ``validate_chrome_trace``, the ledger holds K clients, the profile
    reads every round and no ``compile`` record.  ``.obs.compare`` of
    phase 29's stream with itself exits 0 with no regression and no
    verdict but ok(noise) (rows without a direction carry "info", no
    verdict).  ``report --selftest --device cuda`` (every chained
    selftest; the serving ones on the card) exits 0 in a process without
    ``jax`` in ``sys.modules``.  Then one full-batch L-BFGS step
    (``batch_mode=False``, the cubic strong-Wolfe search, max_iter 4) on a
    stiff quadratic of 1,000,000 float32 on the card and the same call on
    the CPU: the loss falls and stays finite, the closure evaluations
    agree, x within ``LBFGS_FULL_RTOL`` of max |x|.
32. slice 10, the engine's throughput knobs at full width:
    ``drivers.consensus_multi`` on ResNet18 in float32, K=10, batch 128,
    1,280 synthetic images per client, the sweep cut to its first block,
    Nadmm 2 (``KNOBS_BASE``), the six runs in turn in one deterministic
    child (phase 25's mechanism), started before phase 30 and collected
    after phase 31: (a) ``--compress q8 --fused-collective --num-devices 2
    --Nepoch 2``, ``--no-device-data`` against ``--device-data
    --fused-rounds``: the parameters (a sha256 of every tensor) and every
    loss and residual bit for bit, ``host_dispatches`` [2, 2] off and
    [1, 1] on, B1 and B2 launched in every round; (b) ``--robust-agg krum
    --robust-chunked --num-devices 2``, ``--no-device-data`` against
    ``--device-data --overlap-staging --overlap-round``: bit for bit,
    ``overlap_dispatch_seconds`` above 0 on the block's first round and
    0.0 on its last, B3 launched in every round; (c) dense ADMM at D=2,
    Nadmm 1, against ``--sharded-update`` (on the one-card mesh the
    replicated mean serves it): the trained block within
    ``SHARDED_RTOL``/``SHARDED_ATOL``, and whether every parameter is bit
    for bit printed.  The child runs one intra-op thread and prints its
    start-up and runs' seconds.  Printed only: each run's round times.
33. slice 11, the elastic federation at full width, in one deterministic
    child (phase 32's mechanism) started after phase 11 (it needs the
    kernels; phases 3, 4 and 11 time them alone) and collected after
    phase 32, with every kernel's launch count set to 0 at its start and
    read at its end (all of its runs are main-path runs): ResNet18 in
    float32, K=10, batch 128, 1,280 synthetic images per client, the sweep
    cut to its first block (``ELASTIC_BASE``).  (a) dense ADMM at
    ``--num-devices 5``, Nadmm 2, killed after round 0 (its checkpoint on
    disk) and resumed three ways from copies of it: at D=5 with
    ``--elastic-resume``, every record and tensor bit for bit the
    uninterrupted D=5 run; at D=2 with the flag, every number of every
    record and every parameter and statistic within ``ELASTIC_RTOL``,
    ``ELASTIC_ATOL`` of it; at D=2 without the flag, a
    ``CheckpointGeometryError`` naming ``--elastic-resume``.  (b) ``--Nadmm
    2 --compress q8 --fused-collective --num-devices 5 --fault-spec
    preempt=0.5,seed=S --elastic-resume --max-restarts 2`` under a JSONL
    recorder, S the first seed whose draw fires in round 1 (printed): the
    run completes, its trainers are built on [5, 2] meshes and its run
    headers say so, exactly one ``reshape`` record 5 -> 2, B1 and B2
    launched in both rounds (one a segment), and the port's
    ``control.replay`` exits 0 on the stream and 1 with the record's
    ``to_value`` tampered and with it dropped;
34. slice 11, the sanitizer at full width, in the same child: (a) chunked
    krum at D=2 (B3), one round (``SANITIZE_ARGV``), with ``--sanitize``
    and without: bit for bit (a sha256 of every tensor, every number of
    the record), B3 launched under the sanitizer; (b) the same with
    ``--fault-spec corrupt=1.0,mode=nan,clients=3,seed=1``: with
    ``--sanitize`` a ``SanitizerError`` naming the comm step of block 0,
    round 0 and a NaN; without, the round finishes; (c)
    ``drivers.federated_cpc`` at its defaults, its first round (one round
    of the encoder), without ``--sanitize``, with it and without again:
    the sub-models and z bit for bit, B4 and B5 launched under the
    sanitizer.  Printed only: a round's seconds with the sanitizer and
    without (its cost; phase 34's runs share the card with phases 12-32).

Phases 15-21, 24 and 25 run no hand-written kernel (top-k, the
scatter-add, the L-BFGS update and the VAEs are stock PyTorch, as in the
JAX package they are XLA; phase 24's q8 exchange is not fused); the
kernel line's launches are those of phases 5, 26, 27 and 34 (B4, B5;
phases 27 and 34 counted in their children), phases 8, 22, 26, 29, 32
and 34 (B3) and phases 12, 23, 28, 30, 32 and 33 (B1, B2; phases 32-33
counted in their children); phase 31 runs none.  Every driver phase
before 26 passes ``--obs-sinks none``.

The line before the last is the per-kernel JSON record (with each
kernel's host-only time, and B3's stem and B2's in-place fields); the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

#: forward: |kernel - plain| <= FWD_ATOL + FWD_RTOL*|plain| elementwise.
#: Both are float32 with the dot products summed in different orders, so
#: log_p (of order log P) agrees to a few ulps.
FWD_RTOL, FWD_ATOL = 1e-5, 1e-5
#: backward: |kernel - plain| <= BWD_RTOL*|plain| + BWD_ATOL_REL*max|plain|.
#: Gradients are sums of P products of scores, so a few ulps of the largest
#: element is the scale of the rounding difference.
BWD_RTOL, BWD_ATOL_REL = 1e-4, 1e-5
#: phase 3's InfoNCE cases (D, P, zero columns): the CPC path's shape, a
#: single column, the rows branch at P = 130 and 1,000, a zero column in Z
#: and in Zhat, the last P of the cluster branch and the first of the rows
#: branch (ops/infonce.py plan), a D whose block rows go in tiles, and two
#: whose backward tiles (1,252 rows of P = 4, 628 of P = 13) hold more rows
#: than a block's 512 threads form at once
INFONCE_CASES = ((4096, 9, False), (8, 1, False), (4099, 130, False),
                 (256, 1000, False), (4096, 9, True), (4096, 32, False),
                 (4096, 33, False), (100_003, 9, False), (20_000, 4, False),
                 (10_000, 13, False))
#: the CPC loss through kernels vs plain versions, and its gradient
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
#: Gram: |kernel - plain| <= GRAM_REL * max_i G_ii + GRAM_ABS.  Both sum
#: float32 products in different orders; every entry is bounded by the
#: largest diagonal entry (Cauchy-Schwarz), so that sets the rounding scale.
GRAM_REL, GRAM_ABS = 1e-5, 1e-6
#: the Gram shapes: the stem and largest shards of ResNet18 at D=2, then
#: edge cases (one column, K past one tile and past two, n under one
#: pipeline stage)
GRAM_SHAPES = ((10, 928), (10, 2_360_320), (1, 1), (3, 513), (16, 100_003),
               (128, 4096), (17, 5_000), (33, 5_000), (10, 300), (17, 700))
GRAM_PATH_SHAPE = (10, 2_360_320)
GRAM_STEM_SHAPE = (10, 928)
#: column slabs w[:, 3:3+n] of a wider [10, n+8] matrix: rows off 16 B
GRAM_SLAB_NS = (928, 100_003)
#: back-to-back calls at different n (each several column chunks), then
#: the first again
GRAM_SEQUENCE = ((10, 100_003), (10, 1_000_000), (17, 60_000))
#: slice 2 as chip_smoke drives it (see the module docstring for the cuts)
SLICE2_ARGV = ["--device", "cuda", "--model", "resnet18", "--robust-agg",
               "krum", "--robust-chunked", "--num-devices", "2", "--Nloop",
               "1", "--Nadmm", "1", "--n-train", "1280", "--n-test", "1000",
               "--no-save-model",
    "--obs-sinks", "none"]
#: rounds of phases 15, 22 and 24 (one rotation of the 10 blocks, Nadmm 2)
SLICE2_ROUNDS = 20
#: rounds of phases 8 and 12 (Nadmm 1 since slice 10, for the 900 s budget:
#: phases 22 and 23 run B3 and B1/B2 at Nadmm 2)
SLICE23_ROUNDS = 10
LARGEST_BLOCK_N = 4_720_640
#: B1/B2 shapes: the largest and the stem shard of ResNet18 at D=2, then
#: edge cases (a 2-wide row, a width that is not a multiple of 4, rows that
#: take B1's vector path with 1, 4 and 8 float4 a lane, a row wider than
#: the vector path's 1,024)
QUANT_SHAPES = ((9220, 256), (4, 256), (1, 2), (3, 130), (33, 64), (7, 512),
                (37, 1000), (5, 2048))
QUANT_PATH_SHAPE = (9220, 256)
#: timing ring: inputs enough to exceed the H100's 50 MB L2 cache in total
QUANT_RING = 8
#: slice 3 as chip_smoke drives it: slice 2's configuration and cuts with
#: the q8 fused collective in place of krum
SLICE3_ARGV = ["--device", "cuda", "--model", "resnet18", "--compress", "q8",
               "--fused-collective", "--num-devices", "2", "--Nloop", "1",
               "--Nadmm", "1", "--n-train", "1280", "--n-test", "1000",
               "--no-save-model",
    "--obs-sinks", "none"]
#: the byte models at the largest block (ops/packed_reduce.py,
#: compress/quantize.py): what the records must carry
LARGEST_BYTES_FUSED = 9_588_800
LARGEST_BYTES_ON_WIRE = 47_944_000
#: slice 4 as chip_smoke drives it: FedAvg on ResNet18 with top-k and error
#: feedback over the sparse fused collective, slice 2's cuts
#: (federated_multi's Nadmm 3 -> 2: 20 rounds).  topk_frac 0.1, not the
#: default 0.01: at 1% the stem block's k = 19 coordinates are all
#: BatchNorm parameters, FedAvg's write-back of z (zeros at the block's
#: start, plus the sparse mean) then zeroes the stem convolution, and the
#: next backward pass is NaN, in the JAX package as in the port
SLICE4_ARGV = ["--device", "cuda", "--model", "resnet18", "--compress", "topk",
               "--topk-frac", "0.1", "--error-feedback", "--fused-collective",
               "--num-devices", "2", "--Nloop", "1", "--Nadmm", "2",
               "--n-train", "1280", "--n-test", "1000", "--no-save-model",
    "--obs-sinks", "none"]
#: top-k at the largest block, for the run's frac and the default 1%:
#: (k = round(frac * 4,720,640), bytes_on_wire K * 8k, bytes_fused
#: (D-1) * K * 8k at D = 2)
TOPK_FRACS = (0.1, 0.01)
TOPK_LARGEST = {0.1: (472_064, 37_765_120, 37_765_120),
                0.01: (47_206, 3_776_480, 3_776_480)}
#: the sparse fused mean vs the float64 dense mean of the reconstructions:
#: |got - ref| <= TOPK_MEAN_REL * max |ref| (float32 sums of 10 clients)
TOPK_MEAN_REL = 1e-6
#: the no-consensus baseline on ResNet18: Nepoch 20 -> 2, the data cuts
NO_CONSENSUS_EPOCHS = 2
NO_CONSENSUS_ARGV = ["--device", "cuda", "--model", "resnet18", "--Nepoch",
                     str(NO_CONSENSUS_EPOCHS), "--n-train", "1280",
                     "--n-test", "1000", "--no-save-model",
    "--obs-sinks", "none"]
#: FedProx on ResNet18: Nloop 12 -> 1, Nadmm 5 -> 1 (10 rounds), the data
#: cuts, with --be-verbose (one line of per-client losses an epoch)
FEDPROX_ARGV = ["--device", "cuda", "--model", "resnet18", "--Nloop", "1",
                "--Nadmm", "1", "--n-train", "1280", "--n-test", "1000",
                "--no-save-model", "--be-verbose",
    "--obs-sinks", "none"]
#: FedAvg with L-BFGS on Net: Nloop 12 -> 1, Nadmm 3 -> 1 (5 rounds), the
#: data cuts
LBFGS_ARGV = ["--device", "cuda", "--model", "net", "--optimizer", "lbfgs",
              "--Nloop", "1", "--Nadmm", "1", "--n-train", "1280",
              "--n-test", "1000", "--no-save-model",
    "--obs-sinks", "none"]
#: phase 19: the accuracy comparison's defaults, Nloop 3 -> 1 (the
#: script's time went to slice 6's phases)
ACCURACY_NLOOP = 1
#: the Pallas sites B1 and B2 replace
#: phases 20-21 (slice 5): the reference widths with the data cuts
VAE_ARGV = ["--device", "cuda", "--Nloop", "1", "--n-train", "1280",
            "--n-test", "1000", "--no-save-model",
    "--obs-sinks", "none"]
VAE_ROUNDS = {"federated_vae": 12 * 3, "federated_vae_cl": 3 * 3}
#: the first round on the card against the CPU, same weights and noise,
#: per phase: (the round's loss, relative; z's update from the common
#: init, the norm of the card's minus the CPU's over the CPU's).  float32
#: convolutions summed in other orders, carried through 10 Adam or L-BFGS
#: steps.  Read on an H100 80GB HBM3 at 700 W, three runs (PERF.md): the
#: loss 0 and 6.6e-8, the update 9.0e-7 to 9.6e-7 and 3.5e-4 to 4.0e-4,
#: for federated_vae and federated_vae_cl.
VAE_FIRST_ROUND_TOL = {"federated_vae": (1e-6, 1e-5),
                       "federated_vae_cl": (1e-6, 2e-3)}
#: phases 22-25 (slice 6): the robustness shell of a round, slice 2's
#: data cuts.  Phase 22: krum against x100 corruption under partial
#: participation, the update guard and quarantine (20 rounds)
KRUM_ATTACK_ARGV = [
    "--device", "cuda", "--model", "resnet18", "--robust-agg", "krum",
    "--robust-chunked", "--trim-frac", "0.25", "--num-devices", "2",
    "--participation", "0.8", "--fault-spec",
    "corrupt=0.2,mode=scale,scale=100,seed=3", "--update-guard",
    "--quarantine-rounds", "1", "--Nloop", "1", "--Nadmm", "2",
    "--n-train", "1280", "--n-test", "1000", "--no-save-model",
    "--obs-sinks", "none"]
#: phase 23: buffered async rounds with transit delay and churn over the
#: q8 fused collective (FedAvg, Nadmm 3 -> 2: 20 rounds, staleness 0 or 1;
#: the script's time went to slice 8's phases)
ASYNC_ARGV = [
    "--device", "cuda", "--model", "resnet18", "--compress", "q8",
    "--error-feedback", "--fused-collective", "--num-devices", "2",
    "--async-rounds", "--max-staleness", "2", "--staleness-alpha", "0.5",
    "--fault-spec", "delay=0.4,drop=0.1,join=0.2,leave=0.1,seed=5",
    "--Nloop", "1", "--Nadmm", "2", "--n-train", "1280", "--n-test", "1000",
    "--no-save-model",
    "--obs-sinks", "none"]
ASYNC_ROUNDS = 20
#: phase 24: 40 registered clients over the K=10 slots, stratified cohorts
#: (FedAvg with q8 + error feedback, Nadmm 3 -> 2: 20 rounds)
POPULATION_ARGV = [
    "--device", "cuda", "--model", "resnet18", "--population", "40",
    "--cohort-sampling", "stratified", "--participation", "0.9",
    "--compress", "q8", "--error-feedback", "--Nloop", "1", "--Nadmm", "2",
    "--n-train", "1280", "--n-test", "1000", "--no-save-model",
    "--obs-sinks", "none"]
#: phase 25: ADMM on Net, deterministic child processes, Nadmm 5 -> 3
PREEMPT_NADMM, PREEMPT_P = 3, 0.1
PREEMPT_ARGV = [
    "--device", "cuda", "--model", "net", "--participation", "0.7",
    "--update-guard", "--midrun-checkpoint", "--Nloop", "1", "--Nadmm",
    str(PREEMPT_NADMM), "--n-train", "1280", "--n-test", "1000",
    "--obs-sinks", "none"]
#: phases 26-28 (slice 7).  Phase 26: the CPC at its defaults (nothing
#: cut) under partial participation, x100 corruption, the guard with
#: quarantine and krum over a 2-shard mesh, Nadmm 1 -> 2 (8 rounds)
CPC_ATTACK_ARGV = [
    "--device", "cuda", "--Nadmm", "2", "--participation", "0.75",
    "--fault-spec", "corrupt=0.25,mode=scale,scale=100,seed=3",
    "--update-guard", "--quarantine-rounds", "1", "--robust-agg", "krum",
    "--trim-frac", "0.25", "--robust-chunked", "--num-devices", "2",
    "--no-save-model"]
CPC_BLOCKS, CPC_NADMM = 4, 2
CPC_ROUNDS = CPC_BLOCKS * CPC_NADMM
#: phase 27: the supervised CPC (async rounds with delay and churn) and a
#: simulated preemption; the driver's default seed keys the backoff
CPC_PREEMPT_P, CPC_SEED = 0.15, 69
CPC_PREEMPT_FAULTS = "delay=0.3,join=0.2,leave=0.1"
CPC_PREEMPT_ARGV = [
    "--device", "cuda", "--Nadmm", str(CPC_NADMM), "--async-rounds",
    "--max-staleness", "2", "--max-restarts", "2", "--restart-backoff", "0.5"]
#: phase 28: ADMM on ResNet18 over the q8 fused collective, async rounds,
#: one client shipping inf half the time it delivers, the abort watchdog,
#: the act-mode control plane and two restarts (slice 2's cuts, 20 rounds).
#: inf, not NaN: the codec maps a NaN row to finite values (its scale
#: guard reads NaN as 0), so a NaN attack never reaches z and nothing
#: trips.  One attacker: with every client attacking the shielded run
#: trips guard_spike at streak 1.  Seed 3 puts the first attack on a
#: block's last round; a first attack on a block's first round poisons
#: the slot a plain restart would replay (ROADMAP.md, queue C)
CHAOS_ARGV = [
    "--device", "cuda", "--model", "resnet18", "--compress", "q8",
    "--error-feedback", "--fused-collective", "--num-devices", "2",
    "--async-rounds", "--max-staleness", "2", "--fault-spec",
    "corrupt=0.5,mode=inf,clients=3,seed=3,delay=0.25,delay_max=1",
    "--health-action", "abort", "--health-streak", "1", "--health-residual",
    "--control", "act", "--max-restarts", "2", "--restart-backoff", "0",
    "--Nloop", "1", "--Nadmm", "2", "--n-train", "1280", "--n-test", "1000",
    "--no-save-model"]
#: phases 29-30 (slice 8).  Phase 29: slice 2's krum consensus (ResNet18,
#: K=10, D=2, the data cuts, Nadmm 1: 10 rounds) serving its consensus
#: every round: 216-264 seeded requests a round in buckets of 8, 32 and
#: 128, a hot-swap every 2 rounds, a total label shift from round 6 (the
#: served accuracy is near 1 by round 2 on the synthetic data), the act
#: mode control plane and a warn watchdog warmed over 2 rounds
SERVE_SPEC = ("qps=8,round_minutes=0.5,buckets=8+32+128,swap_every=2,"
              "drift_at=6,seed=5")
SERVE_ARGV = [
    "--device", "cuda", "--model", "resnet18", "--robust-agg", "krum",
    "--robust-chunked", "--num-devices", "2", "--serve-spec", SERVE_SPEC,
    "--control", "act", "--health-action", "warn", "--health-window", "2",
    "--health-streak", "1", "--Nloop", "1", "--Nadmm", "1", "--n-train",
    "1280", "--n-test", "1000", "--no-save-model"]
SERVE_ROUNDS = 10
#: the served logits of one pool batch a bucket, the card's consensus vs a
#: float32 CPU forward of the same consensus: max |card - cpu| <=
#: SERVE_LOGIT_RTOL * max |cpu| (float32 convolutions summed in other
#: orders through 18 layers, TF32 off)
SERVE_LOGIT_RTOL = 1e-4
#: phase 30: FedAvg on ResNet18 over the q8 fused collective with the
#: guard, under a 5-virtual-hour soak campaign (10 rounds of 30 virtual
#: minutes, slice 2's cuts, Nadmm 1) through the soak harness.  Seed 2 puts
#: straggler storms at hours 0 and 3 and corruption bursts at hours 1 and
#: 2; the diurnal trough keeps the drop probability at 0.26-0.34; the
#: preemption at hour 3 lands at round 6, survived by one restart whose
#: backoff the virtual clock divides by 3600
SOAK_SPEC = ("hours=6,round_minutes=30,diurnal=0.3,drop=0.05,join=0.2,"
             "leave=0.05,storm=0.5,storm_len=1,burst=0.5,burst_len=1,"
             "burst_corrupt=0.3,mode=scale,scale=100,preempt_at=3,seed=2")
SOAK_ACCEL = 3600.0
SOAK_ARGV = [
    "--device", "cuda", "--model", "resnet18", "--compress", "q8",
    "--error-feedback", "--fused-collective", "--num-devices", "2",
    "--update-guard", "--campaign-spec", SOAK_SPEC, "--campaign-accel",
    str(SOAK_ACCEL), "--max-restarts", "1", "--restart-backoff", "1",
    "--Nloop", "1", "--Nadmm", "1", "--n-train", "1280", "--n-test", "1000",
    "--no-save-model"]
SOAK_ROUNDS, SOAK_PREEMPT_ROUND = 10, 6
#: phase 31: the streams of phases 28-30 kept for the readers, under
#: build/ (listed in .gitignore)
#: phase 32 (slice 10): the throughput knobs at full width, ResNet18 in
#: float32, K=10, batch 128, 1,280 synthetic images per client, one block
#: (the children cut the sweep to its first block), Nadmm 2; each case a
#: pair of deterministic children, the knobs off and on
KNOBS_BASE = [
    "--device", "cuda", "--model", "resnet18", "--K", "10",
    "--default-batch", "128", "--Nloop", "1", "--Nadmm", "2",
    "--n-train", "1280", "--n-test", "1000", "--no-check-results",
    "--no-save-model", "--obs-sinks", "none"]
#: case -> (flags of both runs, the knobs-off run's, the knobs-on run's)
KNOBS_CASES = {
    "fused": (["--compress", "q8", "--fused-collective", "--num-devices",
               "2", "--Nepoch", "2"], ["--no-device-data"],
              ["--device-data", "--fused-rounds"]),
    "overlap": (["--robust-agg", "krum", "--robust-chunked",
                 "--num-devices", "2"], ["--no-device-data"],
                ["--device-data", "--overlap-staging", "--overlap-round"]),
    "sharded": (["--num-devices", "2", "--Nadmm", "1"], [],
                ["--sharded-update"]),
}
#: the sharded update's band against the replicated mean (the JAX
#: package's declared rtol)
SHARDED_RTOL, SHARDED_ATOL = 2e-5, 1e-6
#: phases 33-34 (slice 11): ResNet18 in float32, K=10, batch 128, 1,280
#: synthetic images per client, the sweep cut to its first block (the
#: stem), in one deterministic child started after phase 11
ELASTIC_BASE = [
    "--device", "cuda", "--model", "resnet18", "--K", "10",
    "--default-batch", "128", "--Nloop", "1", "--n-train", "1280",
    "--n-test", "1000", "--no-check-results", "--no-save-model"]
#: phase 33: the elastic resume's band when the mesh changes (the JAX
#: package's contract, tests/test_resume.py); the supervised preemption's
#: probability (the seed is picked so that it fires in round 1)
ELASTIC_RTOL, ELASTIC_ATOL = 1e-4, 1e-6
ELASTIC_PREEMPT_P = 0.5
#: phase 34: chunked krum at D=2, one round; the NaN attack on client 3
SANITIZE_ARGV = ["--Nadmm", "1", "--robust-agg", "krum", "--robust-chunked",
                 "--num-devices", "2", "--obs-sinks", "none"]
SANITIZE_NAN = ["--fault-spec", "corrupt=1.0,mode=nan,clients=3,seed=1"]
#: phase 34 (c): the CPC at its defaults, the rotation's first round
SANITIZE_CPC_ARGV = ["--device", "cuda", "--Nadmm", "1", "--no-save-model",
                     "--obs-sinks", "none"]
STREAMS_DIR = os.path.join(ROOT, "build", "streams")
KEPT_STREAMS: dict = {}
#: phase 31's full-batch L-BFGS: a stiff quadratic 0.5 * sum(h * x^2) over
#: n float32 with h log-spaced over [1e-2, 1e2], one step of max_iter
#: inner iterations with the cubic strong-Wolfe search, on the card and on
#: the CPU from the same x0.  The two sum 1e6 products in other orders, and
#: the search's cubic steps divide differences of such sums, so x is held
#: at LBFGS_FULL_RTOL of max |x| (the closure evaluations, which count the
#: search's branches, exactly)
LBFGS_FULL_N, LBFGS_FULL_ITERS = 1_000_000, 4
LBFGS_FULL_RTOL = 1e-3
QUANTIZE_SITE = "federated_pytorch_test_tpu/ops/comm_kernels.py:124"
DEQUANT_SITE = "federated_pytorch_test_tpu/ops/comm_kernels.py:182"
#: phase 9's separated case: each moved client's offset has squared norm
#: OUTLIER_SCALE2 * max G_ii, and the moved clients' krum scores must clear
#: the others' by SEPARATION float32 tie bands
OUTLIER_SCALE2, SEPARATION = 0.1, 100.0
#: the krum estimate vs a plain mean of the kept rows (float32, 9 rows
#: summed in another order): |est - mean| <= KRUM_MEAN_REL * max |kept rows|
KRUM_MEAN_REL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def within(got, want, rtol: float, atol: float) -> tuple:
    """(max |got - want|, whether every element is within atol + rtol*|want|)."""
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all()) and bool(
        got.isfinite().all() == want.isfinite().all())
    return float(err.max()), ok


def cuda_time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(fns: dict, iters: int = 200, rounds: int = 3) -> dict:
    """``cuda_time_ms`` of each function, taken in turns (a, b, a, b, ...)
    over ``rounds`` rounds; the median of each.  A kernel and the library
    call it is compared with are timed so, because the host's speed drifts
    within a call."""
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            times[k].append(cuda_time_ms(fn, iters=iters, warmup=10))
    return {k: statistics.median(v) for k, v in times.items()}


def host_time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Host time per call (ms): ``time.perf_counter`` around ``iters``
    back-to-back calls, read before the device is synchronised, so it is
    the wrapper's own cost (checks, allocation, the launch) and not the
    kernel's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def kernels_a_call(fn) -> int:
    """Kernels that one call of ``fn`` launches, counted in a CUDA graph
    capture of the call: exact, where the profiler can lose records.  The
    first capture is a warm-up (a wrapper may set up state for the capture
    stream); nothing captured runs."""
    import ctypes

    import torch

    cuda = ctypes.CDLL("libcuda.so.1")
    for _ in range(2):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            fn()
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        fail("cuGraphGetNodes failed on a captured call")
    nodes = (ctypes.c_void_p * n.value)()
    cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds.append(kind.value)
    graph.reset()
    return sum(k == 0 for k in kinds)       # CU_GRAPH_NODE_TYPE_KERNEL


def profiled(fn, name: str, iters: int = 50, tries: int = 3) -> tuple:
    """(device time per call (ms) of the CUDA kernels whose name contains
    ``name``, or None if the profiler saw none; device kernels per call,
    from :func:`kernels_a_call`), the time from ``torch.profiler``.  Every
    window is logged.  A window in which the profiler recorded none of the
    named kernels is taken again, up to ``tries`` windows.  In a long
    process the profiler can lose kernel records (on the H100, 43 of 50
    launches of a wrapper that launches one kernel a call, every call); a
    window that recorded fewer kernels than the capture's count times the
    calls is logged as such, and its time scaled by the share recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    per_call = kernels_a_call(fn)
    fn()
    torch.cuda.synchronize()
    for t in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        us = sum(e.self_device_time_total for e in ev if name in e.key)
        count = sum(e.count for e in ev if name in e.key)
        total = sum(e.count for e in ev)
        lost = per_call * iters - total
        log(f"profile {name!r} window {t + 1}: {count} named and {total} "
            f"device kernels recorded in {iters} calls of {per_call} "
            f"kernels each, {us:.3f} us named"
            + (f"; the profiler lost {lost} records" if lost else ""))
        if count:
            break
    if us and lost > 0:
        us *= per_call * iters / total
    return (us / iters / 1e3 if us > 0 else None, per_call)


def profiled_device_ms(fn, name: str, iters: int = 50):
    """Device time per call (ms) of the CUDA kernels whose name contains
    ``name``, from ``torch.profiler``; None if the profiler saw none."""
    return profiled(fn, name, iters)[0]


def fwd_bound(D: int, P: int) -> tuple:
    """(bytes, flops) the forward must move and do: Z and Zhat read once,
    log_p written once; D*P^2 multiply-adds of the scores, the 2*D*P
    squares-and-adds of the norms."""
    return (2 * D * P + P) * 4, 2 * D * P * P + 4 * D * P


def bwd_bound(D: int, P: int) -> tuple:
    """(bytes, flops) of the backward: Z, Zhat, log_p, ghat read once, dZ and
    dZhat written once; the score rebuild (2DP^2), the norms (4DP), the two
    [D,P]x[P,P] products (4DP^2) and the two norm-path terms (4DP)."""
    return (4 * D * P + 2 * P) * 4, 6 * D * P * P + 8 * D * P


def bound_ms(nbytes: int, flops: int) -> tuple:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def check_device():
    """Phase 1; returns (the nvidia-smi line of card 0, the torch device)."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} count={torch.cuda.device_count()}")
    return card, torch.device("cuda:0")


def build() -> None:
    """Phase 2: one nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from federated_pytorch_test_tpu_torch.ops import cuda_build

    names = ("infonce", "gram", "quant")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        for f in [pool.submit(cuda_build.load_library, n) for n in names]:
            f.result()
    log(f"build: {', '.join(n + '.cu' for n in names)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for n in names:
        info = cuda_build.BUILD_INFO[n]
        log(f"build {n}: nvcc {info['seconds']:.2f} s -> {info['path']}")
        log(f"ptxas {n}: {info['ptxas']}")


def check_kernels(dev, card: str):
    """Phase 3; returns ({kernel: max_abs_err at the path's shape},
    {kernel: (kernel_ms, plain_ms, (bound_ms, bound_by))},
    {kernel: device_ms}, {kernel: {"host_ms": host-only ms a call,
    "device_kernels": device kernels a call}})."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import infonce
    from federated_pytorch_test_tpu_torch.ops.infonce_core import log_p_flat

    rng = np.random.default_rng(0)

    def case(D, P, zero_cols=False):
        Z = rng.standard_normal((D, P)).astype(np.float32)
        Zh = rng.standard_normal((D, P)).astype(np.float32)
        if zero_cols:
            Z[:, 1] = 0.0
            Zh[:, P - 1] = 0.0
        g = rng.standard_normal(P).astype(np.float32)
        return (torch.from_numpy(Z).to(dev), torch.from_numpy(Zh).to(dev),
                torch.from_numpy(g).to(dev))

    path_err = {}
    for D, P, zero in INFONCE_CASES:
        Z, Zh, ghat = case(D, P, zero)
        lp_k = infonce.infonce_fwd(Z, Zh)
        lp_p = log_p_flat(Z, Zh)
        dz_k, dzh_k = infonce.infonce_bwd(Z, Zh, lp_p, ghat)
        dz_p, dzh_p = infonce.grads_plain(Z, Zh, lp_p, ghat)
        torch.cuda.synchronize()
        ef, okf = within(lp_k, lp_p, FWD_RTOL, FWD_ATOL)
        scale = float(torch.maximum(dz_p.abs().max(), dzh_p.abs().max()))
        eb1, okb1 = within(dz_k, dz_p, BWD_RTOL, BWD_ATOL_REL * scale)
        eb2, okb2 = within(dzh_k, dzh_p, BWD_RTOL, BWD_ATOL_REL * scale)
        log(f"kernel check D={D} P={P} zero_cols={zero} "
            f"branch={infonce.plan(D, P).branch}: fwd max_abs_err={ef:.3e} "
            f"bwd max_abs_err dZ={eb1:.3e} dZhat={eb2:.3e} (grad scale {scale:.3e})")
        if not (okf and okb1 and okb2):
            fail(f"kernel disagrees with its plain version at D={D} P={P} "
                 f"zero_cols={zero}: fwd ok={okf} dZ ok={okb1} dZhat ok={okb2}")
        if zero and not (lp_k.isfinite().all() and dz_k.isfinite().all()
                         and dzh_k.isfinite().all()):
            fail("non-finite kernel output with a zero-norm column")
        if (D, P, zero) == (4096, 9, False):
            path_err = {"infonce_fwd": ef, "infonce_bwd": max(eb1, eb2)}

    D, P = 4096, 9
    Z, Zh, ghat = case(D, P)
    lp = log_p_flat(Z, Zh)
    runs = [(infonce.infonce_fwd(Z, Zh), *infonce.infonce_bwd(Z, Zh, lp, ghat))
            for _ in range(3)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run)):
        fail("InfoNCE kernels do not repeat bit for bit at D=4096 P=9")
    log("kernel check D=4096 P=9: log_p, dZ and dZhat equal bit for bit over 3 runs")
    timing = {
        "infonce_fwd": (cuda_time_ms(lambda: infonce.infonce_fwd(Z, Zh)),
                        cuda_time_ms(lambda: log_p_flat(Z, Zh)),
                        bound_ms(*fwd_bound(D, P))),
        "infonce_bwd": (cuda_time_ms(lambda: infonce.infonce_bwd(Z, Zh, lp, ghat)),
                        cuda_time_ms(lambda: infonce.grads_plain(Z, Zh, lp, ghat)),
                        bound_ms(*bwd_bound(D, P))),
    }
    calls = {"infonce_fwd": (lambda: infonce.infonce_fwd(Z, Zh), "infonce_fwd"),
             "infonce_bwd": (lambda: infonce.infonce_bwd(Z, Zh, lp, ghat),
                             "infonce_bwd_")}
    prof = {k: profiled(fn, key) for k, (fn, key) in calls.items()}
    device = {k: v[0] for k, v in prof.items()}
    extra = {k: {"host_ms": host_time_ms(fn), "device_kernels": prof[k][1]}
             for k, (fn, _) in calls.items()}
    for k, (_, per_call) in prof.items():
        if per_call != 1:
            fail(f"{k} at D={D} P={P} ran {per_call} device kernels a call; "
                 f"expected 1")
    # the same calls on the rows branch (the first design's kernels)
    rows = {"infonce_fwd": lambda: infonce.infonce_fwd(Z, Zh, branch="rows"),
            "infonce_bwd": lambda: infonce.infonce_bwd(Z, Zh, lp, ghat,
                                                       branch="rows")}
    for k, fn in rows.items():
        extra[k]["rows_branch_device_ms"] = profiled(fn, calls[k][1])[0]
    for name, (k_ms, p_ms, (b_ms, b_by)) in timing.items():
        log(json.dumps({"kernel": name, "D": D, "P": P,
                        "branch": infonce.plan(D, P).branch, "kernel_ms": k_ms,
                        "device_ms": device[name], **extra[name],
                        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None, "card": card}))
    return path_err, timing, device, extra


def gram_within(got, want) -> tuple:
    """(max |got - want|, tolerance, whether every entry is within it)."""
    tol = GRAM_REL * float(want.diagonal().max()) + GRAM_ABS
    err = float((got - want).abs().max())
    return err, tol, err <= tol and bool(got.isfinite().all())


def gram_bound(K: int, n: int) -> tuple:
    """(bytes, flops) of A.A^T for A [K, n] float32: A read once, G written
    once; 2*K^2*n operations for the product."""
    return (K * n + K * K) * 4, 2 * K * K * n


def gram_cases(dev, gen) -> list:
    """(label, A) of phase 4: GRAM_SHAPES, a slab with an all-zero row,
    column slabs ``w[:, 3:3+n]`` of a wider [10, n+8] matrix (base 12 B off
    16-byte alignment), and a row stride that is not a multiple of 4."""
    import torch

    cases = [(f"[{K}, {n}]", torch.randn(K, n, generator=gen, device=dev))
             for K, n in GRAM_SHAPES]
    a = torch.randn(10, 100_003, generator=gen, device=dev)
    a[4] = 0.0
    cases.append(("[10, 100003] zero row 4", a))
    for n in GRAM_SLAB_NS:
        w = torch.randn(10, n + 8, generator=gen, device=dev)
        cases.append((f"w[:, 3:3+{n}] of [10, {n + 8}]", w[:, 3:3 + n]))
    w = torch.randn(10, 1_001, generator=gen, device=dev)
    cases.append(("w[:, :1000] of [10, 1001] (lda % 4 = 1)", w[:, :1_000]))
    return cases


def check_gram(dev, card: str):
    """Phase 4; returns (max_abs_err at the path's shape,
    (kernel_ms, plain_ms, library_ms, (bound_ms, bound_by)), device_ms,
    {the host-only, kernels-per-call and stem fields of the JSON line})."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import gram

    gen = torch.Generator(device=dev).manual_seed(0)
    path_err = None
    for label, a in gram_cases(dev, gen):
        g_k = gram.gram(a)
        g_p = gram.gram_plain(a)
        repeat = torch.equal(g_k, gram.gram(a))
        torch.cuda.synchronize()
        err, tol, ok = gram_within(g_k, g_p)
        vec = gram.vector_path(a.data_ptr(), a.stride(0) if a.shape[0] > 1
                               else 0, a.shape[1])
        log(f"gram check {label} strides {a.stride()} "
            f"{'16-byte' if vec else '4-byte'} copies: max_abs_err={err:.3e} "
            f"tol={tol:.3e} symmetric={torch.equal(g_k, g_k.t())} "
            f"repeats={repeat}")
        if not (ok and repeat and torch.equal(g_k, g_k.t())):
            fail(f"gram kernel disagrees with gram_plain (or is not symmetric "
                 f"or not repeatable) at {label}")
        if "zero row" in label and not (g_k[4].eq(0).all()
                                        and g_k[:, 4].eq(0).all()):
            fail("gram of a zero row is not a zero row and column")
        if tuple(a.shape) == GRAM_PATH_SHAPE:
            path_err = err
    # back to back at three n (each with several chunks, so the cross-block
    # counter is used), then the first again: the counter was reset, and G
    # repeats bit for bit
    seq = [torch.randn(K, n, generator=gen, device=dev)
           for K, n in GRAM_SEQUENCE]
    first = [gram.gram(a) for a in seq]
    again = gram.gram(seq[0])
    torch.cuda.synchronize()
    for (K, n), a, g_k in zip(GRAM_SEQUENCE, seq, first):
        err, tol, ok = gram_within(g_k, gram.gram_plain(a))
        if not ok:
            fail(f"gram kernel disagrees with gram_plain at [{K}, {n}] in a "
                 f"back-to-back sequence")
    log(f"gram sequence {list(GRAM_SEQUENCE)} then the first again: "
        f"bit-for-bit repeat {torch.equal(first[0], again)}")
    if not torch.equal(first[0], again):
        fail("gram does not repeat bit for bit after calls at other n")

    out = {}
    for key, (K, n) in (("", GRAM_PATH_SHAPE), ("stem_", GRAM_STEM_SHAPE)):
        a = torch.randn(K, n, generator=gen, device=dev)
        big = key == ""
        turns = paired_ms({"kernel": lambda: gram.gram(a),
                           "library": lambda: torch.matmul(a, a.t())},
                          iters=100)
        k_ms, l_ms = turns["kernel"], turns["library"]
        p_ms = cuda_time_ms(lambda: gram.gram_plain(a), iters=3 if big else 50,
                            warmup=1)
        dev_ms, per_call = profiled(lambda: gram.gram(a), "gram_")
        out[key] = {"kernel_ms": k_ms, "device_ms": dev_ms,
                    "host_ms": host_time_ms(lambda: gram.gram(a)),
                    "kernels_per_call": per_call, "plain_ms": p_ms,
                    "library_ms": l_ms, "bound": bound_ms(*gram_bound(K, n))}
        if per_call != 1:
            fail(f"gram at [{K}, {n}] ran {per_call} device kernels a call; "
                 f"expected 1")
    big, stem = out[""], out["stem_"]
    extra = {"host_ms": big["host_ms"],
             "kernels_per_call": big["kernels_per_call"],
             **{f"stem_{k}": stem[k] for k in (
                 "kernel_ms", "device_ms", "host_ms", "kernels_per_call",
                 "plain_ms", "library_ms")},
             "stem_bound_ms": stem["bound"][0],
             "stem_bound_by": stem["bound"][1]}
    K, n = GRAM_PATH_SHAPE
    log(json.dumps({"kernel": "gram", "K": K, "n": n,
                    "kernel_ms": big["kernel_ms"],
                    "device_ms": big["device_ms"], "plain_ms": big["plain_ms"],
                    "library_ms": big["library_ms"],
                    "bound_ms": big["bound"][0], "bound_by": big["bound"][1],
                    **extra, "card": card}))
    return path_err, (big["kernel_ms"], big["plain_ms"], big["library_ms"],
                      big["bound"]), big["device_ms"], extra


def run_slice(dev):
    """Phase 5; returns (trainer, launches on the main path)."""
    import torch

    from federated_pytorch_test_tpu_torch.drivers import federated_cpc
    from federated_pytorch_test_tpu_torch.ops import infonce
    from federated_pytorch_test_tpu_torch.train.cpc_engine import SUBMODELS
    from federated_pytorch_test_tpu_torch.utils import codec

    for k in infonce.LAUNCHES:
        infonce.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer, state, history = federated_cpc.main(
        ["--device", "cuda", "--no-save-model", "--obs-sinks", "none"],
        log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(infonce.LAUNCHES)
    log(f"slice: {len(history)} rounds in {wall:.2f} s, launches {launches}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated(dev)} B")
    for rec in history:
        log(json.dumps({k: rec[k] for k in (
            "model", "block", "N", "loss", "dual_residual", "round_seconds",
            "stage_seconds", "compute_seconds", "kernel_launches")}))
    if len(history) != 4:
        fail(f"expected 4 rounds (one rotation), got {len(history)}")
    for rec in history:
        if not (np.isfinite(rec["loss"]) and np.isfinite(rec["dual_residual"])):
            fail(f"non-finite loss or dual residual: {rec}")
    for mdl in SUBMODELS:
        for ci in range(len(trainer.models[mdl].train_order_block_ids())):
            order, mask, _ = trainer.block(mdl, ci)
            before = codec.get_trainable_values(trainer.state0[mdl], order, mask)
            after = codec.get_trainable_values(state[mdl], order, mask)
            if torch.equal(before, after):
                fail(f"block {ci} of {mdl} did not change")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    return trainer, launches


def profile_steps(trainer) -> None:
    """One L-BFGS step of client 0 on block 0 of each sub-model at full
    width, under ``torch.profiler`` (CUDA activity only): host wall time,
    device busy time, and the InfoNCE kernels' share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from federated_pytorch_test_tpu_torch.train.cpc_engine import (
        SUBMODELS,
        client_params,
    )
    from federated_pytorch_test_tpu_torch.utils import codec

    px, py, batch = trainer.data.round_batches(1, clients=[0])
    y = trainer.stage(batch)[0, 0]
    params = client_params(trainer.state0, 0)
    for mdl in SUBMODELS:
        order, mask, _ = trainer.block(mdl, 0)
        x = codec.get_trainable_values(params[mdl], order, mask)
        loss_fn = trainer.block_loss(mdl, order, mask, params, y, px, py)
        trainer.lbfgs.step(loss_fn, x, trainer.lbfgs.init(x))     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, st, _ = trainer.lbfgs.step(loss_fn, x, trainer.lbfgs.init(x))
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        ev = prof.key_averages()
        busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
        nce_ms = sum(e.self_device_time_total for e in ev
                     if "infonce_" in e.key) / 1e3
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:5]
        log(json.dumps({
            "profile_step": mdl, "closure_evals": st.func_evals,
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1.0 - busy_ms / wall_ms) if wall_ms else None,
            "infonce_device_ms": nce_ms,
            "top_kernels": [[e.key[:60], e.self_device_time_total / 1e3,
                             e.count] for e in top]}))


def check_path_data(trainer) -> None:
    """Phase 6: loss and predictor gradient, kernels vs plain versions."""
    from federated_pytorch_test_tpu_torch.ops import infonce
    from federated_pytorch_test_tpu_torch.optim.lbfgs import value_and_grad
    from federated_pytorch_test_tpu_torch.train.cpc_engine import client_params
    from federated_pytorch_test_tpu_torch.utils import codec

    px, py, batch = trainer.data.round_batches(1, clients=[0])
    y = trainer.stage(batch)[0, 0]
    params = client_params(trainer.state0, 0)
    order, mask, _ = trainer.block("predictor", 0)
    x0 = codec.get_trainable_values(params["predictor"], order, mask)
    out = {}
    for label, impl in (("kernels", infonce.KERNELS), ("plain", infonce.PLAIN)):
        loss_fn = trainer.block_loss("predictor", order, mask, params, y,
                                     px, py, impl)
        out[label] = value_and_grad(loss_fn, x0)
    (lk, gk), (lp, gp) = out["kernels"], out["plain"]
    loss_err = abs(float(lk) - float(lp))
    g_err, g_ok = within(gk, gp, GRAD_RTOL, GRAD_ATOL_REL * float(gp.abs().max()))
    log(f"path data: loss kernels={float(lk):.8e} plain={float(lp):.8e} "
        f"abs_err={loss_err:.3e}; grad max_abs_err={g_err:.3e} "
        f"(max |grad| {float(gp.abs().max()):.3e})")
    if loss_err > LOSS_RTOL * abs(float(lp)) or not g_ok:
        fail("CPC loss or gradient through the kernels disagrees with the "
             "plain versions on the path's data")


def run_slice2(dev):
    """Phase 8; returns (the Gram launches of the run, the captured
    ``y + rho*x`` stack of the largest block's first comm round)."""
    import torch

    from federated_pytorch_test_tpu_torch.drivers import consensus_multi
    from federated_pytorch_test_tpu_torch.ops import gram
    from federated_pytorch_test_tpu_torch.parallel import comm

    captured = {}
    chunked = comm.robust_federated_mean_chunked

    def capture(x, w=None, **kw):
        # the engine's krum estimator sees the ADMM stack y + rho*x itself
        if x.shape[1] == LARGEST_BLOCK_N and "stack" not in captured:
            captured["stack"] = x.detach().clone()
        return chunked(x, w, **kw)

    comm.robust_federated_mean_chunked = capture
    try:
        gram.LAUNCHES["gram"] = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer, state, history = consensus_multi.main(SLICE2_ARGV, log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = gram.LAUNCHES["gram"]
    finally:
        comm.robust_federated_mean_chunked = chunked
    log(f"slice 2: {len(history)} rounds in {wall:.2f} s, gram launches "
        f"{launches}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev)} B")
    for rec in history:
        log(json.dumps({k: rec[k] for k in (
            "block", "nadmm", "N", "loss", "dual_residual", "primal_residual",
            "round_seconds", "stage_seconds", "train_seconds", "comm_seconds",
            "kernel_launches")}))
    if len(history) != SLICE23_ROUNDS:
        fail(f"expected {SLICE23_ROUNDS} rounds, got {len(history)}")
    for rec in history:
        if not all(np.isfinite(rec[k]) for k in
                   ("loss", "dual_residual", "primal_residual")):
            fail(f"non-finite loss or residual: {rec}")
        if rec["kernel_launches"]["gram"] < 1:
            fail(f"the Gram kernel was not launched in round {rec}")
    if launches < len(history):
        fail(f"gram launched {launches} times over {len(history)} rounds")
    same = blocks_unchanged(trainer, state)
    if same:
        fail(f"blocks {same} did not change")
    if "stack" not in captured:
        fail("the largest block's comm round was not reached")
    return launches, captured["stack"], trainer, state


def profile_slice2(trainer, state) -> None:
    """Phase 10 (printed only): one Adam step of all K clients on the stem
    block [0,2] and on the largest block [54,59] under ``torch.profiler``
    (CUDA activity): host wall time, device busy time and idle share, the
    top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from federated_pytorch_test_tpu_torch.train.engine import (
        AdamState,
        ClientState,
    )

    K = trainer.cfg.K
    xb, yb, wb = trainer._stage_epoch(last=True)
    xb, yb, wb = xb[:, :1], yb[:, :1], wb[:, :1]
    for ci in (0, 8):
        N = trainer.block_size(ci)
        zeros = torch.zeros(K, N, device=trainer.device)
        st = ClientState(state.params, state.batch_stats,
                         AdamState(zeros, zeros.clone(),
                                   torch.zeros(K, dtype=torch.int64)))
        args = (ci, zeros, zeros[0], torch.tensor(0.1, device=trainer.device),
                xb, yb, wb)
        trainer.train_epoch(st, *args)                  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trainer.train_epoch(st, *args)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        ev = prof.key_averages()
        busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:5]
        log(json.dumps({
            "profile_step": f"classifier block {ci}", "N": N, "clients": K,
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1.0 - busy_ms / wall_ms) if wall_ms else None,
            "top_kernels": [[e.key[:60], e.self_device_time_total / 1e3,
                             e.count] for e in top]}))


def krum_two_ways(stack, trainer, label: str) -> dict:
    """Krum on ``stack`` [K, N] over the trainer's client mesh, with the
    shard Grams from the kernel and from ``gram_plain``.  Fails if a shard
    Gram is out of the tolerance of phase 4.  Returns the summed Grams,
    selections and scores both ways, the active mask, f, and the float32
    tie band of a score: a squared distance is ``G_ii + G_jj - 2 G_ij``,
    so it carries the two Grams' difference (x4) plus the rounding of its
    own three operations on values up to ``2 max G_ii``, and a score sums
    ``n_nb`` of them."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import gram
    from federated_pytorch_test_tpu_torch.parallel import comm

    K, mesh, trim = stack.shape[0], trainer.mesh, trainer.cfg.trim_frac
    slabs = mesh.all_to_all(stack)
    finite = mesh.psum([(~torch.isfinite(s)).float().sum(dim=1)
                        for s in slabs]) == 0
    _, act, m, _ = comm._screen(None, K, finite, stack)
    safe = [comm._where0(act[:, None], s) for s in slabs]
    kern = [gram.gram(s) for s in safe]
    plain = [gram.gram_plain(s) for s in safe]
    torch.cuda.synchronize()
    for d, (gk, gp) in enumerate(zip(kern, plain)):
        err, tol, ok = gram_within(gk, gp)
        log(f"path data ({label}): shard {d} gram [{K}, {safe[d].shape[1]}] "
            f"max_abs_err={err:.3e} tol={tol:.3e} "
            f"(max G_ii {float(gp.diagonal().max()):.6e})")
        if not ok:
            fail(f"gram kernel disagrees with gram_plain on shard {d} of the "
                 f"path's {label} stack")
    out = {"act": act, "m": m}
    for way, parts in (("kernel", kern), ("plain", plain)):
        g = mesh.psum(parts)
        score, f = comm.krum_scores(g, act, m, trim)
        out[way] = (comm.krum_select(g, act, m, trim), score, g)
    out["f"] = int(f)
    g_k, g_p = out["kernel"][2], out["plain"][2]
    n_nb = max(float(m) - out["f"] - 2.0, 1.0)
    ulp = torch.finfo(torch.float32).eps * 2.0 * float(g_p.diagonal().max())
    out["band"] = n_nb * (4.0 * float((g_k - g_p).abs().max()) + 3.0 * ulp)
    for way in ("kernel", "plain"):
        sel, score, _ = out[way]
        log(f"path data ({label}): krum keeps clients "
            f"{torch.nonzero(sel).flatten().tolist()} ({way}); scores "
            f"{score.tolist()}")
    log(f"path data ({label}): float32 tie band of a score {out['band']:.3e}")
    return out


def check_gram_path_data(stack, trainer) -> str:
    """Phase 9: krum on the real ``y + rho*x`` stack, and on the same stack
    with f clients moved away, through the kernel and ``gram_plain``.
    Returns what the raw stack showed: "same" or "undecided"."""
    import torch

    raw = krum_two_ways(stack, trainer, "y + rho*x")
    act = raw["act"]
    if torch.equal(raw["kernel"][0], raw["plain"][0]):
        verdict = "same"
    else:
        scores = torch.cat([raw[w][1][act] for w in ("kernel", "plain")])
        spread = float(scores.max() - scores.min())
        if raw["band"] < spread:
            fail("krum selects other clients through the kernel than "
                 "through gram_plain on the path's own data, while the "
                 f"scores spread {spread:.3e}, beyond the float32 tie band "
                 f"{raw['band']:.3e}")
        verdict = "undecided"
        log(f"path data (y + rho*x): UNDECIDED, not counted as a pass: the "
            f"selections differ, and the float32 tie band of a score "
            f"{raw['band']:.3e} reaches the spread of all scores "
            f"{spread:.3e}, so no float32 summation order decides krum here")

    # The separated case: move f clients (krum's attacker count) away from
    # the rest by an offset of norm^2 OUTLIER_SCALE2 * max G_ii in a random
    # direction each.  Krum must then drop exactly those, both ways alike.
    f = raw["f"]
    if f < 1:
        fail("the configuration gives krum no client to drop (f = 0)")
    outl = sorted(np.random.default_rng(1).choice(
        torch.nonzero(act).flatten().tolist(), f, replace=False).tolist())
    r = (OUTLIER_SCALE2 * float(raw["plain"][2].diagonal().max())) ** 0.5
    gen = torch.Generator(device=stack.device).manual_seed(1)
    sep = stack.clone()
    for i in outl:
        u = torch.randn(stack.shape[1], generator=gen, device=stack.device)
        sep[i] += r * u / u.norm()
    moved = torch.zeros_like(act)
    moved[outl] = True
    keep = act & ~moved
    res = krum_two_ways(sep, trainer, "separated")
    for way in ("kernel", "plain"):
        score = res[way][1]
        gap = float(score[moved].min() - score[keep].max())
        log(f"path data (separated): clients {outl} moved by "
            f"{r:.4e}; score gap ({way}) {gap:.4e} = "
            f"{gap / res['band']:.1f} tie bands")
        if gap < SEPARATION * res["band"]:
            fail(f"the offset separates the moved clients by {gap:.3e}, "
                 f"less than {SEPARATION} tie bands ({res['band']:.3e})")
    sk, sp = res["kernel"][0], res["plain"][0]
    if not torch.equal(sk, sp) or not torch.equal(sk, keep):
        fail(f"krum keeps {torch.nonzero(sk).flatten().tolist()} through the "
             f"kernel and {torch.nonzero(sp).flatten().tolist()} through "
             f"gram_plain; expected every active client but {outl}")
    # the engine's own estimator on the separated stack: the mean of the
    # kept clients
    est = trainer.mean_fn(sep)
    want = sep[keep].mean(dim=0)
    torch.cuda.synchronize()
    err = float((est - want).abs().max())
    tol = KRUM_MEAN_REL * float(sep[keep].abs().max())
    log(f"path data (separated): krum estimate vs the kept clients' mean "
        f"max_abs_err={err:.3e} tol={tol:.3e}")
    if not err <= tol:
        fail("the engine's krum estimate is not the mean of the clients "
             "krum keeps")
    return verdict

def same_scale(a, b) -> bool:
    """Scales equal element for element, a NaN matching a NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def quant_bound(c: int, w: int, name: str) -> tuple:
    """(bytes, operations) of B1 or B2 on [c, w] rows, each input read once
    and each output written once.  B1 reads v (f32) and writes q (int8) and
    the scales; per element abs, max, divide, round and two clamps.  B2
    reads acc (f32), q (int8) and the scales and writes out (f32); per
    element a multiply and an add."""
    if name == "quantize_chunks":
        return c * w * 4 + c * w + c * 4, 6 * c * w
    return c * w * 4 + c * w + c * 4 + c * w * 4, 2 * c * w


def check_quant(dev, card: str):
    """Phase 11; returns ({kernel: max_abs_err at the path's shape},
    {kernel: (kernel_ms, plain_ms, library_ms, (bound_ms, bound_by))},
    {kernel: device_ms}, {kernel: {host-only and in-place fields}})."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import quant

    gen = torch.Generator(device=dev).manual_seed(3)
    path_err = {}
    for c, w in QUANT_SHAPES:
        for qmax in (127, 7):
            v = torch.randn(c, w, generator=gen, device=dev)
            if c >= 3:
                v[1] = 0.0                              # a zero row
                v[2] *= 1e-6                            # a saturating row
                v[2, w // 2] = -50.0
            q_k, s_k = quant.quantize_chunks(v, qmax)
            q_p, s_p = quant.quantize_plain(v, qmax)
            acc = torch.randn(c, w, generator=gen, device=dev)
            o_p = quant.dequant_add_plain(acc, q_p, s_p)
            # B2 out of place, into a given out, and in place (out=acc) on
            # a clone of acc
            o_k = quant.dequant_add(acc, q_p, s_p)
            o_out = torch.empty_like(acc)
            quant.dequant_add(acc, q_p, s_p, out=o_out)
            o_in = acc.clone()
            quant.dequant_add(o_in, q_p, s_p, out=o_in)
            torch.cuda.synchronize()
            s_err = float((s_k - s_p).abs().max())
            q_err = int((q_k.int() - q_p.int()).abs().max())
            o_err = max(float((o - o_p).abs().max()) for o in (o_k, o_out, o_in))
            sat = c < 3 or int(q_k[2, w // 2]) == -qmax
            b2_same = [torch.equal(o, o_p) for o in (o_k, o_out, o_in)]
            log(f"quant check [{c}, {w}] qmax={qmax}: scale max_abs_err="
                f"{s_err:.3e} q max_abs_err={q_err} dequant_add max_abs_err="
                f"{o_err:.3e} bitwise (out of place, into out, in place) "
                f"{b2_same} saturating row -> -qmax: {sat}")
            if not (same_scale(s_k, s_p) and torch.equal(q_k, q_p)
                    and all(b2_same) and sat):
                fail(f"quantize/dequant_add kernels disagree with their plain "
                     f"versions at [{c}, {w}] qmax={qmax}")
            if (c, w) == QUANT_PATH_SHAPE and qmax == 127:
                path_err = {"quantize_chunks": max(s_err, float(q_err)),
                            "dequant_add": o_err}
    # a row with inf, a row with NaN, a row with both: the scale only (the
    # cast of NaN to int8 has no defined value on either side)
    v = torch.randn(4, 256, generator=gen, device=dev)
    v[1, 3] = float("inf")
    v[2, 5] = float("nan")
    v[3, 0], v[3, 7] = float("-inf"), float("nan")
    _, s_k = quant.quantize_chunks(v, 127)
    _, s_p = quant.quantize_plain(v, 127)
    torch.cuda.synchronize()
    log(f"quant check non-finite rows: scales kernel {s_k.tolist()} plain "
        f"{s_p.tolist()}")
    if not (same_scale(s_k, s_p) and s_k[1].isinf() and s_k[2].isnan()
            and s_k[3].isnan()):
        fail("the quantize kernel's scale of a non-finite row disagrees with "
             "the plain version's")

    # time at the path's shape over a ring of inputs (75 MB of v, 94 MB of
    # acc: more than the 50 MB L2), so that each call reads device memory
    c, w = QUANT_PATH_SHAPE
    vs = [torch.randn(c, w, generator=gen, device=dev)
          for _ in range(QUANT_RING)]
    accs = [torch.randn(c, w, generator=gen, device=dev)
            for _ in range(QUANT_RING)]
    packs = [quant.quantize_plain(x, 127) for x in vs]
    safes = [torch.where(s > 0, s, torch.ones_like(s))[:, None]
             for _, s in packs]
    turn = [0]

    def ring(fn):
        def call():
            i = turn[0] = (turn[0] + 1) % QUANT_RING
            return fn(i)
        return call

    b1 = ring(lambda i: quant.quantize_chunks(vs[i], 127))
    b1_plain = ring(lambda i: quant.quantize_plain(vs[i], 127))
    b2 = ring(lambda i: quant.dequant_add(accs[i], *packs[i]))
    b2_plain = ring(lambda i: quant.dequant_add_plain(accs[i], *packs[i]))
    b2_lib = ring(lambda i: torch.addcmul(accs[i], packs[i][0], safes[i]))
    # in place: the accumulators grow by one decoded payload a call
    b2_in = ring(lambda i: quant.dequant_add(accs[i], *packs[i], out=accs[i]))
    b2_in_lib = ring(lambda i: accs[i].addcmul_(packs[i][0], safes[i]))
    out_of_place = paired_ms({"kernel": b2, "library": b2_lib})
    in_place = paired_ms({"kernel": b2_in, "library": b2_in_lib})
    timing = {
        "quantize_chunks": (cuda_time_ms(b1), cuda_time_ms(b1_plain, iters=50),
                            None, bound_ms(*quant_bound(c, w, "quantize_chunks"))),
        "dequant_add": (out_of_place["kernel"],
                        cuda_time_ms(b2_plain, iters=50),
                        out_of_place["library"],
                        bound_ms(*quant_bound(c, w, "dequant_add"))),
    }
    device = {"quantize_chunks": profiled_device_ms(b1, "quantize_"),
              "dequant_add": profiled_device_ms(b2, "dequant_add_")}
    extra = {
        "quantize_chunks": {"host_ms": host_time_ms(b1)},
        "dequant_add": {"host_ms": host_time_ms(b2),
                        "inplace_ms": in_place["kernel"],
                        "inplace_device_ms": profiled_device_ms(
                            b2_in, "dequant_add_"),
                        "inplace_host_ms": host_time_ms(b2_in),
                        "inplace_library_ms": in_place["library"]},
    }
    for name, (k_ms, p_ms, l_ms, (b_ms, b_by)) in timing.items():
        log(json.dumps({"kernel": name, "c": c, "chunk": w, "qmax": 127,
                        "kernel_ms": k_ms, "device_ms": device[name],
                        **extra[name], "plain_ms": p_ms, "library_ms": l_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "timed_over": f"a ring of {QUANT_RING} inputs",
                        "card": card}))
    return path_err, timing, device, extra


def run_slice3(dev):
    """Phase 12; returns (the B1/B2 launches of the run, the captured
    ``y + rho*x`` stack of the largest block's first comm round, the
    trainer, the final state)."""
    import torch

    from federated_pytorch_test_tpu_torch.drivers import consensus_multi
    from federated_pytorch_test_tpu_torch.ops import quant
    from federated_pytorch_test_tpu_torch.ops.packed_reduce import (
        fused_bytes_on_wire,
    )
    from federated_pytorch_test_tpu_torch.train import engine

    captured = {}
    make = engine.make_fused_mean

    def capturing(compressor, mesh, K):
        mean_fn = make(compressor, mesh, K)

        def fn(stack, w=None):
            # the engine's fused mean sees the ADMM stack y + rho*x itself
            if stack.shape[1] == LARGEST_BLOCK_N and "stack" not in captured:
                captured["stack"] = stack.detach().clone()
            return mean_fn(stack, w)

        return fn

    engine.make_fused_mean = capturing
    try:
        for k in quant.LAUNCHES:
            quant.LAUNCHES[k] = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer, state, history = consensus_multi.main(SLICE3_ARGV, log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(quant.LAUNCHES)
    finally:
        engine.make_fused_mean = make
    log(f"slice 3: {len(history)} rounds in {wall:.2f} s, launches "
        f"{launches}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev)} B")
    K, comp = trainer.cfg.K, trainer.compressor
    for rec in history:
        log(json.dumps({k: rec[k] for k in (
            "block", "nadmm", "N", "loss", "dual_residual", "primal_residual",
            "round_seconds", "stage_seconds", "train_seconds", "comm_seconds",
            "bytes_on_wire", "bytes_fused", "kernel_launches")}))
    if len(history) != SLICE23_ROUNDS:
        fail(f"expected {SLICE23_ROUNDS} rounds, got {len(history)}")
    for rec in history:
        if not all(np.isfinite(rec[k]) for k in
                   ("loss", "dual_residual", "primal_residual")):
            fail(f"non-finite loss or residual: {rec}")
        if min(rec["kernel_launches"][k] for k in launches) < 1:
            fail(f"a quantize kernel was not launched in round {rec}")
        N = rec["N"]
        if rec["bytes_fused"] != fused_bytes_on_wire(comp, N, trainer.D, K):
            fail(f"bytes_fused {rec['bytes_fused']} is not the byte model's "
                 f"{fused_bytes_on_wire(comp, N, trainer.D, K)} at N={N}")
        if rec["bytes_on_wire"] != K * comp.bytes_on_wire(N):
            fail(f"bytes_on_wire {rec['bytes_on_wire']} is not "
                 f"{K} x {comp.bytes_on_wire(N)} at N={N}")
        if N == LARGEST_BLOCK_N and (
                rec["bytes_fused"], rec["bytes_on_wire"]) != (
                LARGEST_BYTES_FUSED, LARGEST_BYTES_ON_WIRE):
            fail(f"the largest block's bytes {rec['bytes_fused']}, "
                 f"{rec['bytes_on_wire']} are not {LARGEST_BYTES_FUSED}, "
                 f"{LARGEST_BYTES_ON_WIRE}")
    same = blocks_unchanged(trainer, state)
    if same:
        fail(f"blocks {same} did not change")
    if "stack" not in captured:
        fail("the largest block's comm round was not reached")
    return launches, captured["stack"], trainer, state


def check_fused_path_data(stack, trainer) -> None:
    """Phase 13: the fused mean of the real ``y + rho*x`` stack through the
    kernels and through the plain versions, at D=2 and D=5."""
    import math

    import torch

    from federated_pytorch_test_tpu_torch.ops import packed_reduce as pr
    from federated_pytorch_test_tpu_torch.ops import quant
    from federated_pytorch_test_tpu_torch.parallel.mesh import ClientMesh

    K, n = stack.shape
    bits, chunk = pr.transport_params(trainer.compressor)
    dense = stack.double().mean(dim=0)
    pad = -n % chunk
    top = torch.nn.functional.pad(dense.abs(), (0, pad)).reshape(-1, chunk)
    step = (2.0 * top.amax(dim=1) / (2 ** bits - 2)).repeat_interleave(chunk)[:n]
    for D in (2, 5):
        mesh = ClientMesh(D)
        local, div = pr._weighted_local_sum(stack, None, K, mesh)
        before = dict(quant.LAUNCHES)
        got = pr.packed_fused_mean(local, div, mesh, bits, chunk, quant.KERNELS)
        launched = {k: quant.LAUNCHES[k] - before[k] for k in before}
        plain = pr.packed_fused_mean(local, div, mesh, bits, chunk, quant.PLAIN)
        torch.cuda.synchronize()
        steps = float(((got.double() - dense).abs() / step.clamp(min=1e-30))
                      .max())
        log(f"path data (fused mean, D={D}): kernels vs plain bitwise "
            f"{torch.equal(got, plain)} (max_abs_err "
            f"{float((got - plain).abs().max()):.3e}); launches {launched}; "
            f"vs the dense mean {steps:.4f} grid steps (limit "
            f"{math.log2(D) + 1:.4f}); max |mean| {float(dense.abs().max()):.4e}")
        if not torch.equal(got, plain):
            fail(f"the fused mean through the kernels differs from the plain "
                 f"versions on the path's stack at D={D}")
        if min(launched.values()) < 1:
            fail(f"the fused mean at D={D} launched no kernel: {launched}")
        if not steps <= math.log2(D) + 1:
            fail(f"the fused mean at D={D} lies {steps:.3f} grid steps from "
                 f"the dense mean, beyond log2(D) + 1")


def profile_comm_step(trainer, state) -> None:
    """Phase 14 (printed only): one comm step at the largest block: the
    encode (with the decode), the fused mean and the whole ADMM update,
    each timed on the host clock around a device sync; the whole step's
    wall time; then the step under ``torch.profiler``: device busy time,
    idle share, the B1/B2 share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from federated_pytorch_test_tpu_torch.parallel.comm import decode_stack
    from federated_pytorch_test_tpu_torch.train.engine import ClientState
    from federated_pytorch_test_tpu_torch.utils import codec

    ci = next(c for c in range(trainer.L)
              if trainer.block_size(c) == LARGEST_BLOCK_N)
    K, dev, N = trainer.cfg.K, trainer.device, LARGEST_BLOCK_N
    z = torch.zeros(N, device=dev)
    y = torch.zeros(K, N, device=dev)
    rho = torch.tensor(trainer.cfg.admm_rho0, device=dev)
    x0 = yhat0 = torch.zeros(K, 1, device=dev)
    st = ClientState(state.params, state.batch_stats, None,
                     trainer._init_comp_state(ci))
    comp = trainer.compressor
    x = codec.get_trainable_stack(st.params, trainer.order,
                                  trainer.mask_for_block(ci))
    trainer.comm_round(st, ci, z, y, rho, x0, yhat0)            # warm-up
    parts = {}
    for _ in range(2):                    # the second pass is the one kept
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payload, _ = comp.encode(x - z[None, :], st.comp)
        xh = z[None, :] + decode_stack(payload, comp, N)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.mean_fn(y + rho * xh, None)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        trainer.algo.global_update(xh, z, y, rho, K, trainer.mesh,
                                   mean_fn=trainer.mean_fn)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        parts = {"encode_decode_ms": (t1 - t0) * 1e3,
                 "fused_mean_ms": (t2 - t1) * 1e3,
                 "admm_update_ms": (t3 - t2) * 1e3}
    # the step's wall time without the profiler (whose start and stop
    # would fall inside the window), then its device time under it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.comm_round(st, ci, z, y, rho, x0, yhat0)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.comm_round(st, ci, z, y, rho, x0, yhat0)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    quant_ms = sum(e.self_device_time_total for e in ev
                   if "quantize_" in e.key or "dequant_add" in e.key) / 1e3
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    log(json.dumps({
        "profile_step": "comm step, largest block", "N": N, "clients": K,
        **parts, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if wall_ms else None,
        "quant_kernels_device_ms": quant_ms,
        "top_kernels": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                        for e in top]}))


def blocks_unchanged(trainer, state) -> list:
    """The blocks of ``trainer`` whose parameters in ``state`` equal the
    common init."""
    import torch

    from federated_pytorch_test_tpu_torch.utils import codec

    same = []
    for ci in range(trainer.L):
        mask = trainer.mask_for_block(ci)
        before = codec.get_trainable_stack(trainer.params0, trainer.order, mask)
        after = codec.get_trainable_stack(state.params, trainer.order, mask)
        if torch.equal(before, after):
            same.append(ci)
    return same


def recording_comm_rounds():
    """Context that wraps the engine's ``comm_round`` to keep, per round,
    (block, params before, params after, z after) and the round's shell
    inputs and outputs (z before, the activity and corruption vectors, the
    guard's bound and verdicts, the cohort): references only, no device
    work inside the timed round; checked after the run.  Yields the two
    lists (rounds, shell)."""
    import contextlib

    from federated_pytorch_test_tpu_torch.train import engine

    rounds, shell = [], []
    orig = engine.BlockwiseFederatedTrainer.comm_round

    def comm_round(self, state, ci, *args, **kw):
        out = orig(self, state, ci, *args, **kw)
        rounds.append((ci, state.params, out[0].params, out[1]))
        shell.append({
            "ci": ci, "z": args[0], "active": kw.get("active"),
            "corrupt": kw.get("corrupt"), "gbound": kw.get("gbound"),
            "okf": out[7],
            "cohort": (None if self._cohort is None
                       else np.array(self._cohort))})
        return out

    @contextlib.contextmanager
    def ctx():
        engine.BlockwiseFederatedTrainer.comm_round = comm_round
        try:
            yield rounds, shell
        finally:
            engine.BlockwiseFederatedTrainer.comm_round = orig

    return ctx()


def stable_order_numpy(v: np.ndarray, k: int) -> np.ndarray:
    """The plain reference of the top-|v| selection: numpy's stable sort
    of -|v| (ties keep index order), first k."""
    return np.argsort(-np.abs(v), kind="stable")[:k].astype(np.int32)


def run_slice4(dev):
    """Phase 15; returns (the captured top-k input, payload and z of the
    largest block's first comm round, the trainer)."""
    import torch

    from federated_pytorch_test_tpu_torch.compress import topk
    from federated_pytorch_test_tpu_torch.drivers import federated_multi
    from federated_pytorch_test_tpu_torch.ops.packed_reduce import (
        fused_bytes_on_wire,
    )
    from federated_pytorch_test_tpu_torch.train import engine
    from federated_pytorch_test_tpu_torch.utils import codec

    captured = {}
    select, make = topk.top_k_abs_indices, engine.make_sparse_fused_mean

    def capturing_select(vecs, k):
        if vecs.shape[-1] == LARGEST_BLOCK_N and "u" not in captured:
            captured["u"] = vecs.detach().clone()
        return select(vecs, k)

    def capturing_make(payload, z, K, mesh):
        if z.shape[0] == LARGEST_BLOCK_N and "payload" not in captured:
            captured["payload"] = {k: v.clone() for k, v in payload.items()}
            captured["z"] = z.clone()
        return make(payload, z, K, mesh)

    topk.top_k_abs_indices = capturing_select
    engine.make_sparse_fused_mean = capturing_make
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        with recording_comm_rounds() as (rounds, _):
            t0 = time.perf_counter()
            trainer, state, history = federated_multi.main(SLICE4_ARGV,
                                                           log=log)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        topk.top_k_abs_indices = select
        engine.make_sparse_fused_mean = make
    log(f"slice 4 (topk): {len(history)} rounds in {wall:.2f} s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated(dev)} B")
    K, D, comp = trainer.cfg.K, trainer.D, trainer.compressor
    for rec in history:
        log(json.dumps({k: rec[k] for k in (
            "block", "nadmm", "N", "loss", "dual_residual", "round_seconds",
            "stage_seconds", "train_seconds", "comm_seconds",
            "bytes_on_wire", "bytes_fused")}))
    if len(history) != SLICE2_ROUNDS or len(rounds) != SLICE2_ROUNDS:
        fail(f"expected {SLICE2_ROUNDS} rounds, got {len(history)}")
    if comp.name != "topk+ef" or not trainer._fused_coll:
        fail(f"slice 4 ran {comp.name} with fused={trainer._fused_coll}")
    for rec in history:
        if not all(np.isfinite(rec[k]) for k in ("loss", "dual_residual")):
            fail(f"non-finite loss or residual: {rec}")
        N, k = rec["N"], comp.inner.k_for(rec["N"])
        if (rec["bytes_on_wire"], rec["bytes_fused"]) != (
                K * 8 * k, (D - 1) * K * 8 * k) or \
                rec["bytes_fused"] != fused_bytes_on_wire(comp, N, D, K):
            fail(f"bytes {rec['bytes_on_wire']}, {rec['bytes_fused']} are "
                 f"not K*8k, (D-1)*K*8k with k={k} at N={N}")
        if N == LARGEST_BLOCK_N and (k, rec["bytes_on_wire"],
                                     rec["bytes_fused"]) != \
                TOPK_LARGEST[comp.inner.frac]:
            fail(f"the largest block's k and bytes {k}, "
                 f"{rec['bytes_on_wire']}, {rec['bytes_fused']} are not "
                 f"{TOPK_LARGEST[comp.inner.frac]}")
    for ci, _, after, z in rounds:
        x = codec.get_trainable_stack(after, trainer.order,
                                      trainer.mask_for_block(ci))
        if not torch.equal(x, z.unsqueeze(0).expand_as(x)):
            fail(f"after a round of block {ci} not every client holds z")
    same = blocks_unchanged(trainer, state)
    if same:
        fail(f"blocks {same} did not change")
    if "payload" not in captured or "u" not in captured:
        fail("the largest block's comm round was not reached")
    return captured, trainer


def check_topk_path_data(captured, trainer) -> None:
    """Phase 15, on the largest block's captured round, at the run's k and
    at the 1% k (``TOPK_FRACS``), both from the round's EF input: the
    top-k selection on the card against the CPU and a numpy stable sort
    (and on a row built with 100 ties at the k-th magnitude); the sparse
    fused mean three times bit for bit, against the CPU bit for bit, and
    against the float64 dense mean of the reconstructions; each timed."""
    import torch

    from federated_pytorch_test_tpu_torch.compress.topk import TopK
    from federated_pytorch_test_tpu_torch.ops.packed_reduce import (
        fused_bytes_on_wire,
        make_sparse_fused_mean,
    )
    from federated_pytorch_test_tpu_torch.ops.topk_select import (
        top_k_abs_indices,
    )

    u, z, mesh = captured["u"], captured["z"], trainer.mesh
    K, n = u.shape
    for frac in TOPK_FRACS:
        comp = TopK(frac)
        k = comp.k_for(n)
        pay, _ = comp.encode(u, None)
        if frac == trainer.compressor.inner.frac and not (
                torch.equal(pay["idx"], captured["payload"]["idx"])
                and torch.equal(pay["val"], captured["payload"]["val"])):
            fail("the selection differs from the one the round shipped")
        # a row with ties at the boundary: the 100 magnitudes around the
        # k-th set to the k-th one, signs alternating
        tied = u[0].clone()
        order = pay["idx"][0].long()
        kth = tied.abs()[order[k - 1]]
        around = torch.sort(tied.abs(), descending=True,
                            stable=True).indices[max(k - 50, 0): k + 50]
        signs = 1.0 - 2.0 * (torch.arange(around.numel(),
                                          device=u.device) % 2)
        tied[around] = kth * signs
        for label, vecs, got in (
                ("the EF input [K, n]", u, pay["idx"]),
                ("a row with 100 ties at the k-th magnitude", tied[None, :],
                 top_k_abs_indices(tied[None, :], k))):
            cpu = top_k_abs_indices(vecs.cpu(), k)
            host = np.stack([stable_order_numpy(r, k)
                             for r in vecs.cpu().numpy()])
            same_cpu = torch.equal(got.cpu(), cpu)
            same_np = bool((got.cpu().numpy() == host).all())
            log(f"path data (top-k selection, frac {frac}, k={k}, {label}): "
                f"card vs CPU equal {same_cpu}, card vs numpy stable sort "
                f"equal {same_np}")
            if not (same_cpu and same_np):
                fail(f"the top-k selection on the card differs on {label}")
        fn = make_sparse_fused_mean(pay, z, K, mesh)
        runs = [fn(None) for _ in range(3)]
        torch.cuda.synchronize()
        repeat = all(torch.equal(runs[0], r) for r in runs[1:])
        cpu = make_sparse_fused_mean({key: v.cpu() for key, v in pay.items()},
                                     z.cpu(), K, mesh)(None)
        ref = z.double() + comp.decode(pay, n).double().sum(dim=0) / K
        err = float((runs[0].double() - ref).abs().max())
        lim = TOPK_MEAN_REL * float(ref.abs().max())
        log(f"path data (sparse fused mean, frac {frac}, k={k}, "
            f"D={mesh.size}): three runs bitwise {repeat}; card vs CPU "
            f"bitwise {torch.equal(runs[0].cpu(), cpu)}; vs the float64 "
            f"dense mean of the reconstructions max_abs_err {err:.3e} "
            f"(limit {lim:.3e}); {torch.unique(pay['idx']).numel()} "
            f"distinct indices of {K * k}")
        if not repeat:
            fail("the sparse fused mean does not repeat bit for bit")
        if not torch.equal(runs[0].cpu(), cpu):
            fail("the sparse fused mean on the card differs from the CPU's")
        if not err <= lim:
            fail(f"the sparse fused mean lies {err:.3e} from the dense mean")
        wire, fused = K * comp.bytes_on_wire(n), fused_bytes_on_wire(
            comp, n, mesh.size, K)
        if (k, wire, fused) != TOPK_LARGEST[frac]:
            fail(f"k, bytes_on_wire, bytes_fused {k}, {wire}, {fused} at "
                 f"frac {frac} are not {TOPK_LARGEST[frac]}")
        sel_ms = cuda_time_ms(lambda: top_k_abs_indices(u, k), iters=10,
                              warmup=2)
        enc_ms = cuda_time_ms(lambda: comp.encode(u, None), iters=10,
                              warmup=2)
        mean_ms = cuda_time_ms(lambda: fn(None), iters=10, warmup=2)
        log(json.dumps({"topk_timing": "largest block", "frac": frac, "N": n,
                        "K": K, "k": k, "bytes_on_wire": wire,
                        "bytes_fused": fused, "selection_ms": sel_ms,
                        "encode_ms": enc_ms,
                        "sparse_fused_mean_ms": mean_ms}))


def run_no_consensus(dev) -> None:
    """Phase 16: ``no_consensus_multi`` on ResNet18 (the whole net trains,
    Adam afresh every epoch); every epoch finite, every parameter tensor
    changed, Adam's step count restarting at 1 in every epoch of every
    client; the epoch times and the peak device memory printed."""
    import torch

    from federated_pytorch_test_tpu_torch.drivers import no_consensus_multi
    from federated_pytorch_test_tpu_torch.train import engine
    from federated_pytorch_test_tpu_torch.utils.tree import leaves

    counts = []
    adam_step = engine.adam_step

    def counting(x, g, mu, nu, count, lr):
        counts.append(count)
        return adam_step(x, g, mu, nu, count, lr)

    engine.adam_step = counting
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer, state, history = no_consensus_multi.main(NO_CONSENSUS_ARGV,
                                                          log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        engine.adam_step = adam_step
    peak = torch.cuda.max_memory_allocated(dev)
    N = trainer.block_size(None)
    log(f"no-consensus: {len(history)} epochs in {wall:.2f} s, trainable "
        f"{N} a client, max_memory_allocated {peak} B")
    for rec in history:
        log(json.dumps({"epoch": rec["epoch"], "loss": rec["loss"],
                        "epoch_seconds": rec["epoch_seconds"],
                        "mean_accuracy": float(np.mean(rec["accuracy"]))}))
    if len(history) != NO_CONSENSUS_EPOCHS or not all(
            np.isfinite(r["loss"]) and np.isfinite(r["accuracy"]).all()
            for r in history):
        fail(f"expected {NO_CONSENSUS_EPOCHS} finite epochs: {history}")
    steps = len(counts) // (trainer.cfg.K * NO_CONSENSUS_EPOCHS)
    if counts != list(range(1, steps + 1)) * trainer.cfg.K * \
            NO_CONSENSUS_EPOCHS:
        fail("Adam's step count did not restart at 1 in every epoch")
    before, after = leaves(trainer.params0), leaves(state.params)
    unchanged = sum(torch.equal(a, b) for a, b in zip(before, after))
    if unchanged:
        fail(f"{unchanged} of {len(before)} parameter tensors did not change")
    log(f"no-consensus: {len(before)} parameter tensors all changed; "
        f"{steps} Adam steps an epoch from count 1")


def run_fedprox(dev) -> None:
    """Phase 17: ``fedprox_multi`` on ResNet18, one round a block; every
    round finite, every block changed, z never written back (a round
    returns the clients' parameters it was given)."""
    import torch

    from federated_pytorch_test_tpu_torch.drivers import fedprox_multi

    logged = []

    def tee(msg: str) -> None:
        logged.append(msg)
        log(msg)

    with recording_comm_rounds() as (rounds, _):
        t0 = time.perf_counter()
        trainer, state, history = fedprox_multi.main(FEDPROX_ARGV, log=tee)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(f"fedprox: {len(history)} rounds in {wall:.2f} s")
    check_verbose(logged, history, trainer.cfg)
    for rec in history:
        log(json.dumps({k: rec[k] for k in (
            "block", "N", "loss", "primal_residual", "dual_residual",
            "round_seconds", "train_seconds", "comm_seconds")}))
    if len(history) != trainer.L or len(rounds) != trainer.L:
        fail(f"expected {trainer.L} rounds, got {len(history)}")
    for rec in history:
        if not all(np.isfinite(rec[k]) for k in
                   ("loss", "primal_residual", "dual_residual")):
            fail(f"non-finite loss or residual: {rec}")
    if not all(before is after for _, before, after, _ in rounds):
        fail("FedProx wrote z back to the clients")
    same = blocks_unchanged(trainer, state)
    if same:
        fail(f"blocks {same} did not change")


def check_verbose(logged: list, history: list, cfg) -> None:
    """Phase 17's ``--be-verbose`` lines: one an epoch of every round, at
    the round's block and nadmm; the per-client losses of a round's lines,
    summed over its epochs and then over the clients as the engine sums
    them, equal the round record's ``loss`` within the four-digit print
    (5e-5 of max(1, |value|) a printed value) and 1e-6 of the loss."""
    lines = []
    for msg in logged:
        if not msg.startswith("verbose: "):
            continue
        head, _, arr = msg.partition(" client_loss=")
        coords = dict(kv.split("=") for kv in head.split()[1:])
        vals = np.asarray(arr.strip()[1:-1].split(), np.float64)
        lines.append(((int(coords["block"]), int(coords["nadmm"]),
                       int(coords["epoch"])), vals))
    want = len(history) * cfg.Nepoch
    log(f"fedprox: {len(lines)} verbose lines (blocks x Nadmm x Nepoch = "
        f"{len(history) // cfg.Nadmm} x {cfg.Nadmm} x {cfg.Nepoch} = {want})")
    if len(lines) != want:
        fail(f"--be-verbose printed {len(lines)} lines, not {want}")
    worst = 0.0
    for r, rec in enumerate(history):
        mine = lines[r * cfg.Nepoch:(r + 1) * cfg.Nepoch]
        coords = [c for c, _ in mine]
        if coords != [(rec["block"], rec["nadmm"], e)
                      for e in range(cfg.Nepoch)]:
            fail(f"round {r}: verbose coordinates {coords}")
        vals = [v for _, v in mine]
        if any(v.shape != (cfg.K,) for v in vals):
            fail(f"round {r}: verbose losses of shapes "
                 f"{[v.shape for v in vals]}, not ({cfg.K},)")
        total = float(np.sum(sum(vals)))
        tol = (sum(float(np.sum(5e-5 * np.maximum(1.0, np.abs(v))))
                   for v in vals) + 1e-6 * abs(rec["loss"]))
        worst = max(worst, abs(total - rec["loss"]) / tol)
        if not abs(total - rec["loss"]) <= tol:
            fail(f"round {r}: verbose losses sum to {total}, the round "
                 f"record's loss is {rec['loss']} (tolerance {tol:.3e})")
    log(f"fedprox: verbose sums vs round loss, worst |diff| / tolerance "
        f"{worst:.3f}")


def counting_closures():
    """Context that counts the closure evaluations of every
    ``LBFGSNew.step``; yields the list of counts, one a step."""
    import contextlib

    from federated_pytorch_test_tpu_torch.optim import lbfgs

    evals = []
    step = lbfgs.LBFGSNew.step

    def counting(self, loss_fn, x, state):
        n = [0]

        def counted(v):
            n[0] += 1
            return loss_fn(v)

        out = step(self, counted, x, state)
        evals.append(n[0])
        return out

    @contextlib.contextmanager
    def ctx():
        lbfgs.LBFGSNew.step = counting
        try:
            yield evals
        finally:
            lbfgs.LBFGSNew.step = step

    return ctx()


def run_lbfgs(dev) -> None:
    """Phase 18: ``federated_multi --optimizer lbfgs`` on Net, one round a
    block; every round finite, every block changed, the closure
    evaluations of each L-BFGS step counted and printed."""
    import torch

    from federated_pytorch_test_tpu_torch.drivers import federated_multi

    with counting_closures() as evals:
        t0 = time.perf_counter()
        trainer, state, history = federated_multi.main(LBFGS_ARGV, log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(f"lbfgs: {len(history)} rounds in {wall:.2f} s, {len(evals)} L-BFGS "
        f"steps, closure evaluations a step min {min(evals)} mean "
        f"{np.mean(evals):.3f} max {max(evals)} (history "
        f"{trainer.lbfgs.history_size}, max_iter {trainer.lbfgs.max_iter})")
    for rec in history:
        log(json.dumps({k: rec[k] for k in (
            "block", "N", "loss", "dual_residual", "round_seconds",
            "train_seconds", "comm_seconds")}))
    if len(history) != trainer.L:
        fail(f"expected {trainer.L} rounds, got {len(history)}")
    for rec in history:
        if not all(np.isfinite(rec[k]) for k in ("loss", "dual_residual")):
            fail(f"non-finite loss or residual: {rec}")
    if not evals or min(evals) < 1:
        fail("no L-BFGS step evaluated its closure")
    same = blocks_unchanged(trainer, state)
    if same:
        fail(f"blocks {same} did not change")


def run_accuracy_comparison() -> None:
    """Phase 19: ``accuracy_comparison.run_comparison`` at its defaults but
    ``ACCURACY_NLOOP`` on the card; the four final accuracies printed,
    every curve finite and not empty."""
    import torch

    from federated_pytorch_test_tpu_torch.drivers import accuracy_comparison

    t0 = time.perf_counter()
    res = accuracy_comparison.run_comparison(Nloop=ACCURACY_NLOOP,
                                             device="cuda", log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    curves = ("standalone", "fedavg", "consensus", "upper_k1")
    log(json.dumps({"accuracy_comparison": res["config"],
                    "data_source": res["data_source"], "seconds": wall,
                    "points": {c: len(res[c]) for c in curves},
                    "final": res["final"]}))
    for c in curves:
        if not res[c] or not np.isfinite(res[c]).all():
            fail(f"the {c} curve is empty or not finite: {res[c]}")

def kernel_launch_tables() -> tuple:
    """The launch counters of every kernel wrapper."""
    from federated_pytorch_test_tpu_torch.ops import gram, infonce, quant

    return infonce.LAUNCHES, gram.LAUNCHES, quant.LAUNCHES


def vae_first_round(name: str, argv: list, dev) -> dict:
    """The first round of the VAE driver ``name`` (its trainer, model and
    flags ``argv``) on the card and on the CPU, from the same weights (the
    common init is drawn on a CPU generator) and the same noise (drawn on
    the CPU, then moved); returns the two losses, their relative
    difference, the relative distance of the two updates of z, the update's
    norm relative to the init's, and the seconds of each side."""
    import importlib

    import torch

    from federated_pytorch_test_tpu_torch.train.engine import torch_normal
    from federated_pytorch_test_tpu_torch.utils import codec

    mod = importlib.import_module(
        f"federated_pytorch_test_tpu_torch.drivers.{name}")
    out = {}
    for device in ("cuda", "cpu"):
        tr = mod.build([*argv, "--Nadmm", "1", "--device", device])
        tr.L = 1
        tr.normal = lambda words, shape, d: torch_normal(words, shape,
                                                         "cpu").to(d)
        mask = tr.mask_for_block(0)
        z0 = codec.get_trainable_stack(tr.params0, tr.order, mask)[0].cpu()
        t0 = time.perf_counter()
        state, hist = tr.run(log=lambda m: None)
        if device == "cuda":
            torch.cuda.synchronize(dev)
        # FedAvg wrote z back to every client
        z = codec.get_trainable_stack(state.params, tr.order, mask)[0].cpu()
        out[device] = (hist[0]["loss"], z - z0, time.perf_counter() - t0)
    (lg, dg, sg), (lc, dc, sc) = out["cuda"], out["cpu"]
    norm = torch.linalg.vector_norm
    return {"loss_cuda": lg, "loss_cpu": lc, "loss_rel": abs(lg - lc) / abs(lc),
            "update_rel": float(norm(dg - dc) / norm(dc)),
            "update_over_init": float(norm(dc) / norm(z0)),
            "seconds_cuda": sg, "seconds_cpu": sc}


def run_vae(name: str, dev) -> None:
    """Phases 20 and 21: the VAE driver ``name`` through its ``main`` at the
    reference widths with the cuts of ``VAE_ARGV``, the kernels' launch
    counts set to 0 just before and read just after; then its first round
    on the card against the CPU."""
    import importlib

    import torch

    mod = importlib.import_module(
        f"federated_pytorch_test_tpu_torch.drivers.{name}")
    tables = kernel_launch_tables()
    for table in tables:
        for k in table:
            table[k] = 0
    torch.cuda.reset_peak_memory_stats(dev)
    with counting_closures() as evals:
        t0 = time.perf_counter()
        trainer, state, history = mod.main(VAE_ARGV, log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: v for table in tables for k, v in table.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    elbo = trainer.evaluate(state)
    eval_s = time.perf_counter() - t0
    cfg, model = trainer.cfg, trainer.model
    log(f"{name}: K={cfg.K} batch {cfg.default_batch} model "
        f"{type(model).__name__} ({trainer.block_size(None)} values a "
        f"client), {len(history)} rounds in {wall:.2f} s, "
        f"max_memory_allocated {peak} B, kernel launches {launches}")
    for rec in history:
        log(json.dumps({k: rec[k] for k in (
            "block", "nadmm", "N", "loss", "dual_residual", "round_seconds",
            "stage_seconds", "train_seconds", "comm_seconds")}))
    log(json.dumps({"phase": name, "test_elbo_per_sample": elbo.tolist(),
                    "eval_seconds": eval_s}))
    if evals:
        log(f"{name}: {len(evals)} L-BFGS steps, closure evaluations a step "
            f"min {min(evals)} mean {np.mean(evals):.3f} max {max(evals)} "
            f"(history {trainer.lbfgs.history_size}, max_iter "
            f"{trainer.lbfgs.max_iter})")
    if len(history) != VAE_ROUNDS[name]:
        fail(f"{name}: expected {VAE_ROUNDS[name]} rounds, got {len(history)}")
    for rec in history:
        if not all(np.isfinite(rec[k]) for k in ("loss", "dual_residual")):
            fail(f"{name}: non-finite loss or residual: {rec}")
    if not np.isfinite(elbo).all() or elbo.shape != (cfg.K,):
        fail(f"{name}: final test ELBO {elbo}")
    if any(launches.values()):
        fail(f"{name} launched a kernel: {launches}")
    if name == "federated_vae_cl" and (not evals or min(evals) < 1):
        fail("no L-BFGS step evaluated its closure")
    same = blocks_unchanged(trainer, state)
    if same:
        fail(f"{name}: sweep units {same} did not change")
    del trainer, state
    first = vae_first_round(name, VAE_ARGV, dev)
    loss_tol, update_tol = VAE_FIRST_ROUND_TOL[name]
    log(json.dumps({"phase": name, "first_round_card_vs_cpu": first,
                    "loss_rtol": loss_tol, "update_rtol": update_tol}))
    if not (first["loss_rel"] <= loss_tol
            and first["update_rel"] <= update_tol):
        fail(f"{name}: the first round on the card is not the CPU's: {first}")


# ---------------------------------------------------------------------------
# slice 6: the robustness shell of a round (phases 22-25)


def masked_gram_check(stack, w, trainer, label: str,
                      need_masked: bool = True) -> None:
    """The shard slabs krum's Gram sees on a partial round (rows of absent
    and non-finite clients zeroed, as ``robust_federated_mean_chunked``
    builds them) through ``gram`` and ``gram_plain``, within the tolerance
    of phase 4; ``need_masked``: the slab must hold a masked row."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import gram
    from federated_pytorch_test_tpu_torch.parallel import comm

    K, mesh = stack.shape[0], trainer.mesh
    slabs = mesh.all_to_all(stack)
    finite = mesh.psum([(~torch.isfinite(s)).float().sum(dim=1)
                        for s in slabs]) == 0
    _, act, m, _ = comm._screen(w, K, finite, stack)
    safe = [comm._where0(act[:, None], s) for s in slabs]
    zero_rows = int((~act).sum())
    for d, s in enumerate(safe):
        gk, gp = gram.gram(s), gram.gram_plain(s)
        torch.cuda.synchronize()
        err, tol, ok = gram_within(gk, gp)
        absent = torch.nonzero(~act).flatten().tolist()
        log(f"path data ({label}): shard {d} gram [{K}, {s.shape[1]}] with "
            f"{zero_rows} zero rows (clients {absent}) "
            f"max_abs_err={err:.3e} tol={tol:.3e}")
        if not ok:
            fail(f"gram kernel disagrees with gram_plain on shard {d} of the "
                 f"masked {label} slab")
    if need_masked and zero_rows < 1:
        fail(f"the captured {label} slab has no masked row")


def run_krum_attack(dev) -> int:
    """Phase 22; returns the Gram launches of the run."""
    import torch

    from federated_pytorch_test_tpu_torch.drivers import consensus_multi
    from federated_pytorch_test_tpu_torch.ops import gram
    from federated_pytorch_test_tpu_torch.parallel import comm
    from federated_pytorch_test_tpu_torch.train import engine
    from federated_pytorch_test_tpu_torch.train.faults import (
        FaultSpec,
        apply_corruption,
    )

    captured, sels, deltas = {}, [], []
    chunked, select = comm.robust_federated_mean_chunked, comm.krum_select

    def corrupting(d, *args, **kw):
        # each exchange's clean wire deltas, before the corruption
        deltas.append(d)
        return apply_corruption(d, *args, **kw)

    def capture(x, w=None, **kw):
        # the first round with an absent client: at the largest block if
        # one of its rounds has one, else at any block
        if w is not None and bool((w == 0).any()):
            key = "largest" if x.shape[1] == LARGEST_BLOCK_N else "any"
            if key not in captured:
                captured[key] = (x.detach().clone(), w.clone())
        return chunked(x, w, **kw)

    def selecting(g, act, m, trim_frac):
        sel = select(g, act, m, trim_frac)
        sels.append((sel, act))
        return sel

    comm.robust_federated_mean_chunked = capture
    comm.krum_select = selecting
    engine.apply_corruption = corrupting
    try:
        gram.LAUNCHES["gram"] = 0
        torch.cuda.reset_peak_memory_stats(dev)
        with recording_comm_rounds() as (_, shells):
            t0 = time.perf_counter()
            trainer, state, history = consensus_multi.main(KRUM_ATTACK_ARGV,
                                                           log=log)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = gram.LAUNCHES["gram"]
    finally:
        comm.robust_federated_mean_chunked = chunked
        comm.krum_select = select
        engine.apply_corruption = apply_corruption
    cfg, K = trainer.cfg, trainer.cfg.K
    log(f"krum under attack: {len(history)} rounds in {wall:.2f} s, gram "
        f"launches {launches}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev)} B")
    for rec in history:
        log(json.dumps({k: rec.get(k) for k in (
            "block", "nadmm", "N", "loss", "dual_residual", "primal_residual",
            "n_active", "fault_dropped", "fault_corrupted", "quarantined",
            "guard_trips", "n_ok", "round_seconds", "train_seconds",
            "comm_seconds", "kernel_launches")}))
    if len(history) != SLICE2_ROUNDS:
        fail(f"expected {SLICE2_ROUNDS} rounds, got {len(history)}")
    # the numpy replay of the participation, fault and quarantine ledgers
    # and of the guard's bound; the guard's verdicts recomputed on the card
    # from the round's own updates
    spec = FaultSpec.parse(cfg.fault_spec)
    q = np.zeros(K, np.int64)
    scale = float("inf")
    call = 0
    kept_out = counted = tripped_late = passed_late = 0
    for rec in history:
        if not all(np.isfinite(rec[k]) for k in
                   ("loss", "dual_residual", "primal_residual")
                   if k in rec):
            fail(f"non-finite loss or residual: {rec}")
        nloop, ci, nadmm = rec["nloop"], rec["block"], rec["nadmm"]
        if nadmm == 0:
            scale = float("inf")
        rng = np.random.default_rng([cfg.seed, 11, nloop, ci, nadmm])
        base = (rng.random(K) < cfg.participation).astype(np.float32)
        if not base.any():
            base[int(rng.integers(K))] = 1.0
        ok = 1.0 - (q > 0)
        drop, _, corrupt = spec.round_faults(K, nloop, ci, nadmm)
        comm_m = base * ok * (1.0 - drop)
        corrupt = corrupt * comm_m
        n_comm, n_cor = int(comm_m.sum()), int(corrupt.sum())
        if (rec["n_active"], rec["fault_corrupted"]) != (n_comm, n_cor):
            fail(f"round {(ci, nadmm)}: n_comm {rec['n_active']} and "
                 f"fault_corrupted {rec['fault_corrupted']}, the replay "
                 f"{n_comm} and {n_cor}")
        if rec["quarantined"] != int((q > 0).sum()):
            fail(f"round {(ci, nadmm)}: quarantined {rec['quarantined']}, "
                 f"the replay {int((q > 0).sum())}")
        q = np.maximum(q - 1, 0)
        if n_comm == 0:
            if rec["kernel_launches"]["gram"] != 0:
                fail(f"gram launched on a round without exchange: {rec}")
            continue
        if rec["kernel_launches"]["gram"] != 2:
            fail(f"gram launched {rec['kernel_launches']['gram']} times, "
                 f"not 2, in round {(ci, nadmm)}")
        shell, d0 = shells[call], deltas[call]
        sel, act = sels[call]
        call += 1
        if not (np.array_equal(shell["active"], comm_m)
                and np.array_equal(shell["corrupt"], corrupt)):
            fail(f"round {(ci, nadmm)}: the engine's masks are not the "
                 "replay's")
        bound = np.float32(np.inf) if not np.isfinite(scale) else \
            np.float32(cfg.guard_norm_mult * scale)
        if shell["gbound"] != bound:
            fail(f"round {(ci, nadmm)}: guard bound {shell['gbound']}, the "
                 f"replay {bound}")
        # the guard's test on the round's own updates: the corrupted
        # deltas as the engine poisons them, finite and within the bound
        z_in = shell["z"]
        c = torch.as_tensor(corrupt, device=z_in.device)
        w = torch.as_tensor(comm_m, device=z_in.device)
        d = (z_in + apply_corruption(d0, c, spec.mode, spec.scale,
                                     w=w, mesh=trainer.mesh)) - z_in
        finite = torch.isfinite(d).all(dim=1)
        nrm = torch.linalg.vector_norm(
            torch.where(finite[:, None], d, torch.zeros_like(d)), dim=1)
        want = (finite & (nrm <= torch.as_tensor(bound, device=d.device))
                ).float().cpu().numpy()
        okf = shell["okf"].cpu().numpy()
        if not np.array_equal(okf, want):
            fail(f"round {(ci, nadmm)}: guard verdicts {okf.tolist()}, the "
                 f"recomputation {want.tolist()}")
        tripped = (comm_m > 0) & (okf < 0.5)
        q[tripped] = cfg.quarantine_rounds
        if rec["n_ok"] > 0:
            nm = rec["guard_norm_mean"]
            scale = nm if not np.isfinite(scale) else 0.5 * scale + 0.5 * nm
        bad = corrupt > 0
        nrm_h = nrm.cpu().numpy()
        log(f"guard: block {ci} round {nadmm}: bound {float(bound):.6e}, "
            f"corrupted norms {nrm_h[bad].tolist()}, honest norms max "
            f"{float(nrm_h[(comm_m > 0) & ~bad].max(initial=0.0)):.6e}, "
            f"tripped {np.nonzero(tripped)[0].tolist()}")
        if nadmm > 0:
            tripped_late += int(tripped[bad].sum())
            passed_late += int((~tripped[bad]).sum())
            continue
        if np.isfinite(bound):
            fail(f"the first round of block {ci} has a finite bound {bound}")
        sel, act = sel.cpu().numpy(), act.cpu().numpy()
        f = int(np.floor(cfg.trim_frac * act.sum()))
        picked = np.nonzero(sel & bad)[0].tolist()
        if n_cor > f:
            log(f"krum under attack: block {ci}'s first round has {n_cor} "
                f"corrupted clients against f = {f}: not counted")
            continue
        counted += 1
        kept_out += n_cor
        if picked:
            fail(f"krum selected corrupted clients {picked} in the first "
                 f"round of block {ci} (f = {f}, {n_cor} corrupted)")
    log(f"krum under attack: replay of {len(history)} rounds equal; "
        f"{counted} first rounds counted, {kept_out} corrupted updates "
        f"kept out by krum; in later rounds {tripped_late} corrupted "
        f"updates tripped the guard and {passed_late} passed its bound")
    if call != len(sels) or call != len(shells) or call != len(deltas):
        fail(f"{call} exchanges replayed, {len(sels)} krum selections")
    key = "largest" if "largest" in captured else "any"
    if key not in captured:
        fail("no round of the run had an absent client")
    stack, w = captured[key]
    masked_gram_check(stack, w, trainer,
                      f"krum under attack, N={stack.shape[1]}")
    return launches


def async_replay(cfg, spec, history) -> list:
    """The numpy replay of the buffered-async schedule with churn (no
    guard, no population): per round the admitted count and the record
    fields it predicts."""
    K = cfg.K
    members = np.ones(K, bool)
    arrival = np.full(K, -1, np.int64)
    birth = np.zeros(K, np.int64)
    out = []
    for rec in history:
        nloop, ci, nadmm = rec["nloop"], rec["block"], rec["nadmm"]
        if nadmm == 0:
            arrival[:] = -1
            birth[:] = 0
        new = spec.round_churn(members, nloop, ci, nadmm)
        joined, left = new & ~members, members & ~new
        arrival[left] = -1
        birth[left] = 0
        members = new
        drop, _, _ = spec.round_faults(K, nloop, ci, nadmm)
        free = arrival < 0
        dispatch = members & (drop == 0) & free
        delays = spec.round_delays(K, nloop, ci, nadmm)
        arrival[dispatch] = nadmm + delays[dispatch]
        birth[dispatch] = nadmm
        arrive = arrival == nadmm
        stale = np.where(arrive, nadmm - birth, 0)
        admit = arrive & (stale <= cfg.max_staleness)
        arrival[arrive] = -1
        out.append((int(admit.sum()), {
            "async_arrived": int(arrive.sum()),
            "admission_rejected": int((arrive & ~admit).sum()),
            "buffer_depth": int((arrival >= 0).sum()),
            "staleness_hist": np.bincount(
                stale[admit], minlength=cfg.max_staleness + 1).tolist(),
            "members_active": int(members.sum()),
            "joined": int(joined.sum()), "left": int(left.sum())}))
    return out


def run_async_churn(dev) -> dict:
    """Phase 23; returns the B1/B2 launches of the run."""
    import math

    import torch

    from federated_pytorch_test_tpu_torch.drivers import federated_multi
    from federated_pytorch_test_tpu_torch.ops import packed_reduce as pr
    from federated_pytorch_test_tpu_torch.ops import quant
    from federated_pytorch_test_tpu_torch.train import engine
    from federated_pytorch_test_tpu_torch.train.faults import FaultSpec

    captured = {}
    make = engine.make_fused_mean

    def capturing(compressor, mesh, K):
        mean_fn = make(compressor, mesh, K)

        def fn(stack, w=None):
            # the first round with a stale (fractional) weight: at the
            # largest block if one of its rounds has one, else at any
            if w is not None and bool(((w > 0) & (w < 1)).any()):
                key = ("largest" if stack.shape[1] == LARGEST_BLOCK_N
                       else "any")
                if key not in captured:
                    captured[key] = (stack.detach().clone(), w.clone())
            return mean_fn(stack, w)

        return fn

    engine.make_fused_mean = capturing
    try:
        for k in quant.LAUNCHES:
            quant.LAUNCHES[k] = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer, state, history = federated_multi.main(ASYNC_ARGV, log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(quant.LAUNCHES)
    finally:
        engine.make_fused_mean = make
    cfg = trainer.cfg
    log(f"async + churn: {len(history)} rounds in {wall:.2f} s, launches "
        f"{launches}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev)} B")
    fields = ("async_arrived", "admission_rejected", "buffer_depth",
              "staleness_hist", "members_active", "joined", "left")
    for rec in history:
        log(json.dumps({k: rec.get(k) for k in (
            "block", "nadmm", "N", "loss", "dual_residual", "n_active",
            *fields, "fault_dropped", "round_seconds", "comm_seconds",
            "kernel_launches")}))
    if len(history) != ASYNC_ROUNDS:
        fail(f"expected {ASYNC_ROUNDS} rounds, got {len(history)}")
    replay = async_replay(cfg, FaultSpec.parse(cfg.fault_spec), history)
    for rec, (n_comm, want) in zip(history, replay):
        got = {k: rec[k] for k in fields}
        if got != want:
            fail(f"round {(rec['block'], rec['nadmm'])}: {got}, the replay "
                 f"{want}")
        if not all(np.isfinite(rec[k]) for k in ("loss", "dual_residual")
                   if k in rec):
            fail(f"non-finite loss or residual: {rec}")
        ran = min(rec["kernel_launches"][k] for k in launches)
        if (n_comm >= 1) != (ran >= 1) or (
                n_comm == 0 and max(rec["kernel_launches"].values())):
            fail(f"round {(rec['block'], rec['nadmm'])} with {n_comm} "
                 f"admitted updates launched {rec['kernel_launches']}")
    log(f"async + churn: the replay of {len(history)} rounds equal; "
        f"{sum(n for n, _ in replay)} updates admitted, "
        f"{sum(w['admission_rejected'] for _, w in replay)} rejected, "
        f"{sum(w['joined'] for _, w in replay)} joins, "
        f"{sum(w['left'] for _, w in replay)} departures")
    key = "largest" if "largest" in captured else "any"
    if key not in captured:
        fail("no round admitted a stale update (no fractional weight)")
    # the fused mean at the captured fractional-weight round: kernels and
    # plain versions bit for bit, within (log2 D + 1) grid steps of the
    # dense weighted mean
    stack, w = captured[key]
    K, n = stack.shape
    bits, chunk = pr.transport_params(trainer.compressor)
    wd = w.double()
    dense = (stack.double() * wd[:, None]).sum(dim=0) / wd.sum()
    pad = -n % chunk
    top = torch.nn.functional.pad(dense.abs(), (0, pad)).reshape(-1, chunk)
    step = (2.0 * top.amax(dim=1) / (2 ** bits - 2)).repeat_interleave(
        chunk)[:n]
    mesh = trainer.mesh
    local, div = pr._weighted_local_sum(stack, w, K, mesh)
    before = dict(quant.LAUNCHES)
    got = pr.packed_fused_mean(local, div, mesh, bits, chunk, quant.KERNELS)
    launched = {k: quant.LAUNCHES[k] - before[k] for k in before}
    plain = pr.packed_fused_mean(local, div, mesh, bits, chunk, quant.PLAIN)
    torch.cuda.synchronize()
    steps = float(((got.double() - dense).abs() / step.clamp(min=1e-30)).max())
    log(f"path data (async fused mean, D={mesh.size}, N={n}, weights "
        f"{[round(float(v), 6) for v in w]}): kernels vs plain bitwise "
        f"{torch.equal(got, plain)}; launches {launched}; vs the dense "
        f"weighted mean {steps:.4f} grid steps (limit "
        f"{math.log2(mesh.size) + 1:.4f})")
    if not torch.equal(got, plain):
        fail("the fused mean through the kernels differs from the plain "
             "versions at the fractional-weight round")
    if min(launched.values()) < 1:
        fail(f"the fused mean launched no kernel: {launched}")
    if not steps <= math.log2(mesh.size) + 1:
        fail(f"the fused mean lies {steps:.3f} grid steps from the dense "
             "weighted mean")
    return launches


def row_digests(comp, K: int) -> list:
    """Per slot, a digest of that slot's rows of every client-stacked leaf
    of the compressor state (bit for bit: the bytes are hashed)."""
    import hashlib

    from federated_pytorch_test_tpu_torch.utils.tree import leaves

    arrays = [t.detach().cpu().numpy() for t in leaves(comp)]
    arrays = [a for a in arrays if a.ndim >= 1 and a.shape[0] == K]
    return [hashlib.blake2b(b"".join(np.ascontiguousarray(a[k]).tobytes()
                                     for a in arrays)).hexdigest()
            for k in range(K)]


def run_population(dev) -> None:
    """Phase 24: population cohorts at full width."""
    import torch

    from federated_pytorch_test_tpu_torch.drivers import federated_multi
    from federated_pytorch_test_tpu_torch.population.sampler import (
        sample_cohort,
    )
    from federated_pytorch_test_tpu_torch.train import engine

    swaps = []
    swap = engine.BlockwiseFederatedTrainer._population_swap_comp

    def recording(self, comp, ci):
        prev = None if self._pop_comp_prev is None else \
            np.array(self._pop_comp_prev)
        before = row_digests(comp, self.cfg.K)
        out = swap(self, comp, ci)
        fresh = row_digests(self._init_comp_state(ci, "cpu"), self.cfg.K)
        swaps.append((ci, prev, np.array(self._cohort), before,
                      row_digests(out, self.cfg.K), fresh))
        return out

    engine.BlockwiseFederatedTrainer._population_swap_comp = recording
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        with recording_comm_rounds() as (_, shells):
            t0 = time.perf_counter()
            trainer, state, history = federated_multi.main(POPULATION_ARGV,
                                                           log=log)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        engine.BlockwiseFederatedTrainer._population_swap_comp = swap
    cfg, K = trainer.cfg, trainer.cfg.K
    log(f"population: {len(history)} rounds in {wall:.2f} s, population "
        f"{cfg.population}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev)} B")
    for rec, shell in zip(history, shells):
        log(json.dumps({**{k: rec.get(k) for k in (
            "block", "nadmm", "N", "loss", "dual_residual", "n_active",
            "round_seconds", "comm_seconds")},
            "cohort": shell["cohort"].tolist()}))
    if len(history) != SLICE2_ROUNDS or len(shells) != SLICE2_ROUNDS:
        fail(f"expected {SLICE2_ROUNDS} rounds, got {len(history)}")
    for rec, shell in zip(history, shells):
        want = sample_cohort(cfg.population, K, seed=cfg.seed,
                             nloop=rec["nloop"], ci=rec["block"],
                             nadmm=rec["nadmm"], method=cfg.cohort_sampling)
        if not np.array_equal(shell["cohort"], want):
            fail(f"round {(rec['block'], rec['nadmm'])}: cohort "
                 f"{shell['cohort'].tolist()}, the replay {want.tolist()}")
        if not all(np.isfinite(rec[k]) for k in ("loss", "dual_residual")):
            fail(f"non-finite loss or residual: {rec}")
    # EF rows follow the registry client: a client sampled again gets the
    # row it left with; a client new to the block its slot's fresh row
    left_with = {}
    resumed = fresh_n = 0
    for ci, prev, cohort, before, after, fresh in swaps:
        if prev is None:
            left_with = {}
        else:
            for k, rid in enumerate(prev.tolist()):
                left_with[rid] = before[k]
        if prev is None and not left_with:
            continue
        for k, rid in enumerate(cohort.tolist()):
            want = left_with.get(rid, fresh[k])
            if after[k] != want:
                fail(f"block {ci}: client {rid} in slot {k} did not get "
                     f"{'its own stashed' if rid in left_with else 'a fresh'}"
                     " error-feedback row")
            if rid in left_with:
                resumed += 1
            else:
                fresh_n += 1
    log(f"population: every cohort equal to sample_cohort's; {resumed} "
        f"slots resumed their client's own EF row bit for bit, {fresh_n} "
        "took a fresh row")
    if resumed < 1:
        fail("no registry client was sampled again within a block")


def preempt_schedule(L: int, nadmm: int, p: float) -> tuple:
    """(seed, global round index) of the first fault seed whose tag-71
    draw fires first inside a block (nadmm > 0) past the first block, so
    that the resumed run has whole blocks left to run."""
    from federated_pytorch_test_tpu_torch.train.faults import FaultSpec

    for seed in range(1000):
        sp = FaultSpec.parse(f"preempt={p},seed={seed}")
        fires = [ci * nadmm + n for ci in range(L) for n in range(nadmm)
                 if sp.round_preempt(0, ci, n)]
        if fires and fires[0] % nadmm > 0 and nadmm <= fires[0] < \
                (L - 1) * nadmm:
            return seed, fires[0]
    fail("no fault seed preempts inside a block")


def child_main(spec_json: str) -> None:
    """Phases 25 and 27's child: one deterministic driver run (cuBLAS
    workspace and ``torch.use_deterministic_algorithms`` set before the
    first handle) of ``spec["driver"]`` (default ``consensus_multi``), its
    history and the InfoNCE launches pickled beside the checkpoints; exit
    3 on the simulated preemption, with the round it hit."""
    import importlib
    import pickle

    spec = json.loads(spec_json)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch

    torch.use_deterministic_algorithms(True)
    sys.path.insert(0, ROOT)
    from federated_pytorch_test_tpu_torch.ops import infonce
    from federated_pytorch_test_tpu_torch.parallel.mesh import (
        CollectiveTimeoutError,
    )

    driver = importlib.import_module("federated_pytorch_test_tpu_torch."
                                     "drivers." + spec.get("driver",
                                                           "consensus_multi"))
    out = os.path.join(spec["dir"], spec["tag"] + ".pkl")
    try:
        _, _, history = driver.main(spec["argv"], log=lambda m: None)
    except CollectiveTimeoutError as e:
        with open(out, "wb") as f:
            pickle.dump({"preempted": e.round_index}, f)
        sys.exit(3)
    with open(out, "wb") as f:
        pickle.dump({"history": history, "launches": dict(infonce.LAUNCHES)},
                    f)


def knobs_child_main(spec_json: str) -> None:
    """Phase 32's child: ``spec["runs"]`` in turn in one deterministic
    process (cuBLAS workspace and ``torch.use_deterministic_algorithms``
    set before the first handle, one intra-op thread), each
    ``drivers.consensus_multi`` with the sweep cut to its first block.
    Pickles, per run, the history, a sha256 of every parameter and
    statistic, the trained block's [K, N] stack and the run's seconds."""
    import pickle

    t_child = time.perf_counter()
    spec = json.loads(spec_json)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch

    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    from federated_pytorch_test_tpu_torch.drivers import common, consensus_multi

    make = common.make_trainer

    def first_block(*a, **kw):
        t = make(*a, **kw)
        t.L = 1
        return t
    common.make_trainer = first_block
    result = {"startup_seconds": time.perf_counter() - t_child}
    for side, argv in spec["runs"].items():
        t0 = time.perf_counter()
        trainer, state, history = consensus_multi.main(argv,
                                                       log=lambda m: None)
        result[side] = {"history": history,
                        "seconds": time.perf_counter() - t0,
                        **knobs_child_result(trainer, state)}
        del trainer, state
    with open(os.path.join(spec["dir"], spec["tag"] + ".pkl"), "wb") as f:
        pickle.dump(result, f)


def knobs_child_result(trainer, state) -> dict:
    """A phase 32 child's end state: a sha256 of every parameter and
    statistic, and the trained block's [K, N] stack as numpy."""
    import hashlib

    from federated_pytorch_test_tpu_torch.utils import codec
    from federated_pytorch_test_tpu_torch.utils.tree import leaves

    h = hashlib.sha256()
    for t in leaves((state.params, state.batch_stats)):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    block = codec.get_trainable_stack(state.params, trainer.order,
                                      trainer.mask_for_block(0))
    return {"digest": h.hexdigest(), "block": block.cpu().numpy()}


class _Killed(Exception):
    """Phase 33 (a)'s kill after round 0's checkpoint."""


def elastic_preempt_seed() -> int:
    """Phase 33 (b): the first fault seed whose preemption draw fires in
    round 1, the stem block's second round (round 0 never fires: nothing
    is checkpointed yet)."""
    from federated_pytorch_test_tpu_torch.train.faults import FaultSpec

    for seed in range(1000):
        if FaultSpec.parse(f"preempt={ELASTIC_PREEMPT_P},seed={seed}"
                           ).round_preempt(0, 0, 1):
            return seed
    fail("no fault seed preempts round 1")


def elastic_child_main(spec_json: str) -> None:
    """Phases 33 and 34's child: every case in turn in one deterministic
    process (cuBLAS workspace and ``torch.use_deterministic_algorithms``
    set before the first handle, one intra-op thread), each driver run
    with the sweep cut to its first block (the CPC to its first round).
    Checks in the process (the states stay on the card) and pickles its
    log lines, the first failure (None when every check held) and the
    kernels' launches over all its runs, every one a run of the main
    path."""
    import hashlib
    import inspect
    import pickle
    import shutil
    import traceback

    t_child = time.perf_counter()
    spec = json.loads(spec_json)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch

    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    from federated_pytorch_test_tpu_torch.analysis.sanitize import (
        SanitizerError,
    )
    from federated_pytorch_test_tpu_torch.control.replay import main as replay
    from federated_pytorch_test_tpu_torch.drivers import (
        common,
        consensus_multi,
        federated_cpc,
    )
    from federated_pytorch_test_tpu_torch.obs.report import read_records
    from federated_pytorch_test_tpu_torch.ops import gram, infonce, quant
    from federated_pytorch_test_tpu_torch.train import cpc_engine, engine
    from federated_pytorch_test_tpu_torch.utils.checkpoint import (
        CheckpointGeometryError,
    )
    from federated_pytorch_test_tpu_torch.utils.tree import leaves

    work = spec["dir"]
    lines = []
    say = lines.append
    tables = (quant.LAUNCHES, gram.LAUNCHES, infonce.LAUNCHES)
    for table in tables:
        for k in table:
            table[k] = 0
    built = []
    make = common.make_trainer

    def first_block(c, *a, **kw):
        t = make(c, *a, **kw)
        t.L = 1
        built.append(c.num_devices)
        return t
    common.make_trainer = first_block
    # the restore's seconds (the slot read and its tensors on the card;
    # the checksum is verified before it)
    restores = []
    restore = engine.BlockwiseFederatedTrainer._restore_midrun

    def timed_restore(self, path):
        t0 = time.perf_counter()
        out = restore(self, path)
        torch.cuda.synchronize()
        restores.append(time.perf_counter() - t0)
        return out
    engine.BlockwiseFederatedTrainer._restore_midrun = timed_restore

    def check(ok, msg):
        if not ok:
            raise AssertionError(msg)

    def run(argv, log=lambda m: None):
        t0 = time.perf_counter()
        trainer, state, history = consensus_multi.main(argv, log=log)
        return trainer, state, history, time.perf_counter() - t0

    def digest(tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()

    def numbers(history):
        return [{k: v for k, v in r.items() if isinstance(v, (int, float))
                 and not k.endswith("_seconds")} for r in history]

    def worst(a, b):
        """max over the tensors of |a - b| - (atol + rtol |b|), and of
        |a - b| (<= 0 in the first: within the elastic band)."""
        over, gap = -1.0, 0.0
        for x, y in zip(a, b):
            d = (x - y).abs()
            gap = max(gap, float(d.max()))
            over = max(over, float((d - ELASTIC_ATOL
                                    - ELASTIC_RTOL * y.abs()).max()))
        return over, gap

    result = {"startup_seconds": time.perf_counter() - t_child}
    try:
        # -- phase 33 (a): kill after round 0 at D=5, resume three ways
        t33 = time.perf_counter()
        base = [*ELASTIC_BASE, "--Nadmm", "2", "--obs-sinks", "none"]
        _, s_full, h_full, sec = run([*base, "--num-devices", "5"])
        full = leaves((s_full.params, s_full.batch_stats))
        say(f"elastic (a): uninterrupted D=5 run, {len(h_full)} rounds in "
            f"{sec:.2f} s")
        ck = os.path.join(work, "a")

        def killer(msg):
            if "round=0/" in msg:
                raise _Killed

        try:
            run([*base, "--num-devices", "5", "--midrun-checkpoint",
                 "--checkpoint-dir", ck], log=killer)
            check(False, "phase 33 (a): the run was not killed")
        except _Killed:
            pass
        for tag in ("55", "52", "52n"):
            shutil.copytree(ck, ck + tag)

        def resume(tag, d, *flag):
            return run([*base, "--num-devices", str(d), "--midrun-checkpoint",
                        "--load-model", "--checkpoint-dir", ck + tag, *flag])

        t55, s55, h55, sec = resume("55", 5, "--elastic-resume")
        same = (t55.D == 5 and numbers(h55) == numbers(h_full)
                and digest(leaves((s55.params, s55.batch_stats)))
                == digest(full))
        say(f"elastic (a): resumed at D=5 with --elastic-resume in "
            f"{sec:.2f} s (restore {restores[-1]:.3f} s): every record and "
            f"tensor bit for bit the uninterrupted run: {same}")
        check(same, "phase 33 (a): the D=5 resume is not bit for bit")
        del s55
        t52, s52, h52, sec = resume("52", 2, "--elastic-resume")
        check(t52.D == 2, f"phase 33 (a): resumed on D={t52.D}, not 2")
        n52, nfull = numbers(h52), numbers(h_full)
        check(len(n52) == len(nfull) == 2
              and all(a.keys() == b.keys() for a, b in zip(n52, nfull)),
              "phase 33 (a): the D=2 resume's records differ in keys")
        rec_over = max(abs(a[k] - b[k]) - ELASTIC_ATOL
                       - ELASTIC_RTOL * abs(b[k])
                       for a, b in zip(n52, nfull) for k in a)
        over, gap = worst(leaves((s52.params, s52.batch_stats)), full)
        say(f"elastic (a): resumed at D=2 with --elastic-resume in "
            f"{sec:.2f} s (restore {restores[-1]:.3f} s): records {[(r['loss'], r['dual_residual']) for r in h52]} "
            f"vs {[(r['loss'], r['dual_residual']) for r in h_full]}; "
            f"parameters max |diff| {gap:.3e}; within rtol {ELASTIC_RTOL}, "
            f"atol {ELASTIC_ATOL}: records {rec_over <= 0}, tensors "
            f"{over <= 0}")
        check(rec_over <= 0 and over <= 0,
              "phase 33 (a): the D=2 resume leaves the elastic band")
        del s52, s_full, full
        try:
            resume("52n", 2)
            check(False, "phase 33 (a): D=2 without --elastic-resume ran")
        except CheckpointGeometryError as e:
            check("--elastic-resume" in str(e),
                  f"phase 33 (a): the geometry error does not name the "
                  f"flag: {e}")
            say(f"elastic (a): D=2 without the flag: "
                f"CheckpointGeometryError: {e}")
        # -- phase 33 (b): the supervised preemption under q8 fused, D=5
        seed = elastic_preempt_seed()
        obs_dir = os.path.join(work, "b", "obs")
        built.clear()
        trainer, _, hist, sec = run([
            *ELASTIC_BASE, "--Nadmm", "2", "--compress", "q8",
            "--fused-collective", "--num-devices", "5", "--fault-spec",
            f"preempt={ELASTIC_PREEMPT_P},seed={seed}", "--elastic-resume",
            "--max-restarts", "2", "--restart-backoff", "0", "--obs-sinks",
            "jsonl", "--obs-dir", obs_dir, "--checkpoint-dir",
            os.path.join(work, "b")])
        path = os.path.join(obs_dir, "consensus_multi.jsonl")
        recs = read_records(path, validate=True)
        reshapes = [(r["from_value"], r["to_value"]) for r in recs
                    if r["event"] == "control"
                    and r["intervention"] == "reshape"]
        meshes = [r["mesh_shape"]["clients"] for r in recs
                  if r["event"] == "run_header"]
        kl = [r["kernel_launches"] for r in hist]
        say(f"elastic (b): preempt={ELASTIC_PREEMPT_P},seed={seed} fires in "
            f"round 1; {len(hist)} rounds in {sec:.2f} s, trainers built on "
            f"{built}, run headers' meshes {meshes}, reshape records "
            f"{reshapes}, launches a round {kl}")
        check(len(hist) == 2 and built == [5, 2] and meshes == [5, 2]
              and trainer.D == 2 and reshapes == [(5, 2)],
              "phase 33 (b): the run did not reshape 5 -> 2 once")
        check(all(k["quantize_chunks"] >= 1 and k["dequant_add"] >= 1
                  for k in kl),
              "phase 33 (b): B1/B2 not launched in both segments")
        raw = open(path).read().splitlines()
        tampered, dropped = path + ".tampered", path + ".dropped"
        with open(tampered, "w") as f:
            for line in raw:
                r = json.loads(line)
                if r.get("intervention") == "reshape":
                    r["to_value"] = 3
                f.write(json.dumps(r) + "\n")
        with open(dropped, "w") as f:
            for line in raw:
                if json.loads(line).get("intervention") != "reshape":
                    f.write(line + "\n")
        codes = [replay([p]) for p in (path, tampered, dropped)]
        say(f"elastic (b): control.replay exits {codes} on the stream, the "
            "reshape record tampered and dropped")
        check(codes == [0, 1, 1], "phase 33 (b): replay exits wrong")
        result["seconds_33"] = time.perf_counter() - t33
        # -- phase 34 (a)/(b): chunked krum at D=2, sanitized and not
        t34 = time.perf_counter()
        krum = [*ELASTIC_BASE, *SANITIZE_ARGV]
        _, s_off, h_off, sec_off = run(krum)
        _, s_on, h_on, sec_on = run([*krum, "--sanitize"])
        same = (numbers(h_on) == numbers(h_off)
                and digest(leaves((s_on.params, s_on.batch_stats)))
                == digest(leaves((s_off.params, s_off.batch_stats))))
        say(f"sanitize (a): chunked krum at D=2, one round: run {sec_off:.2f}"
            f" s off, {sec_on:.2f} s on; round_seconds "
            f"{h_off[0]['round_seconds']:.3f} off, "
            f"{h_on[0]['round_seconds']:.3f} on (the sanitizer's cost); "
            f"gram launches {h_on[0]['kernel_launches']['gram']} on; "
            f"bit for bit: {same}")
        check(same, "phase 34 (a): the sanitized run is not bit for bit")
        check(h_on[0]["kernel_launches"]["gram"] >= 1,
              "phase 34 (a): B3 not launched under the sanitizer")
        del s_on, s_off
        try:
            run([*krum, *SANITIZE_NAN, "--sanitize"])
            check(False, "phase 34 (b): the NaN attack did not raise")
        except SanitizerError as e:
            say(f"sanitize (b): SanitizerError: {e}")
            check(str(e).startswith("comm step (block 0, round 0): nan"),
                  f"phase 34 (b): raised elsewhere: {e}")
        _, _, h_nan, _ = run([*krum, *SANITIZE_NAN])
        say(f"sanitize (b): without --sanitize the run goes on: "
            f"{len(h_nan)} round, loss {h_nan[0]['loss']}")
        check(len(h_nan) == 1, "phase 34 (b): the unsanitized run stopped")
        # -- phase 34 (c): one CPC round, sanitized and not
        step = cpc_engine.CPCTrainer._step_round
        got = {}

        class OneRound(Exception):
            pass

        def one_round(self, *a):
            step(self, *a)
            args = inspect.signature(step).bind(self, *a).arguments
            state, z, _ = args["box"]
            got["digest"] = digest(leaves(state) + [z])
            got["record"] = args["history"][-1]
            raise OneRound

        cpc_engine.CPCTrainer._step_round = one_round
        cpc = []
        try:
            # off, on, off: the first run also warms the CPC's kernels up
            for on in (False, True, False):
                before = dict(infonce.LAUNCHES)
                try:
                    federated_cpc.main(
                        [*SANITIZE_CPC_ARGV, *(["--sanitize"] if on else [])],
                        log=lambda m: None)
                    check(False, "phase 34 (c): the round did not end")
                except OneRound:
                    pass
                cpc.append(dict(got, launches={
                    k: infonce.LAUNCHES[k] - before[k] for k in before}))
        finally:
            cpc_engine.CPCTrainer._step_round = step
        off, on, off2 = cpc
        same = all(r["digest"] == on["digest"]
                   and numbers([r["record"]]) == numbers([on["record"]])
                   for r in (off, off2))
        say(f"sanitize (c): one CPC round ({on['record']['model']} block "
            f"{on['record']['block']}): round_seconds off "
            f"{off['record']['round_seconds']:.3f}, on "
            f"{on['record']['round_seconds']:.3f}, off again "
            f"{off2['record']['round_seconds']:.3f} (the sanitizer's cost); "
            f"launches on {on['launches']}; bit for bit: {same}")
        check(same, "phase 34 (c): the sanitized CPC round is not bit for "
                    "bit")
        check(min(on["launches"].values()) >= 1,
              "phase 34 (c): B4/B5 not launched under the sanitizer")
        result["seconds_34"] = time.perf_counter() - t34
        result["error"] = None
    except Exception as e:          # the parent prints it and fails
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()
    result["lines"] = lines
    result["launches"] = {k: v for table in tables for k, v in table.items()}
    with open(os.path.join(work, "elastic.pkl"), "wb") as f:
        pickle.dump(result, f)


def start_elastic():
    """Phases 33-34's start: one deterministic child (phase 32's
    mechanism), started after phase 11 so that it runs beside phases
    12-32 and not beside the kernels' timing; :func:`finish_elastic`
    collects it."""
    import tempfile

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="elastic-",
                            dir=os.path.join(ROOT, "build"))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase33-child",
         json.dumps({"dir": work})],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, work, time.perf_counter()


def finish_elastic(started) -> dict:
    """Phases 33 and 34 (the child of :func:`start_elastic`): its lines
    printed, its first failure failing the script.  Returns the launches
    of every kernel in the child's runs."""
    import pickle
    import shutil

    proc, work, t0 = started
    t_wait = time.perf_counter()
    try:
        out, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            log(out[-4000:])
            log(err[-4000:])
            fail(f"phases 33-34's child exited {proc.returncode}")
        with open(os.path.join(work, "elastic.pkl"), "rb") as f:
            res = pickle.load(f)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    for line in res["lines"]:
        log(line)
    if res["error"] is not None:
        log(res["traceback"][-4000:])
        fail(f"phases 33-34: {res['error']}")
    log(f"phases 33-34: child start-up {res['startup_seconds']:.2f} s, "
        f"phase 33 {res['seconds_33']:.2f} s, phase 34 "
        f"{res['seconds_34']:.2f} s; {time.perf_counter() - t0:.2f} s from "
        f"its start, {time.perf_counter() - t_wait:.2f} s of it after phase "
        f"32; launches {res['launches']}")
    return res["launches"]


def run_preempt_resume() -> None:
    """Phase 25: preemption and resume in child processes, bit for bit."""
    import pickle
    import shutil
    import tempfile

    import torch

    from federated_pytorch_test_tpu_torch.utils import checkpoint as ckpt

    L = 5                                     # Net's blocks
    seed, at = preempt_schedule(L, PREEMPT_NADMM, PREEMPT_P)
    log(f"preempt: seed {seed}, p {PREEMPT_P}: the preemption fires at "
        f"round {at} (block {at // PREEMPT_NADMM}, nadmm "
        f"{at % PREEMPT_NADMM})")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="preempt-", dir=os.path.join(ROOT, "build"))
    timing = {"round_seconds", "stage_seconds", "train_seconds",
              "comm_seconds", "ckpt_write_seconds"}

    def start(tag, spec, extra=()):
        d = os.path.join(work, spec)
        faults = "drop=0.1" + (f",preempt={PREEMPT_P}" if spec != "ref"
                               else "")
        argv = [*PREEMPT_ARGV, "--checkpoint-dir", d, "--fault-spec",
                f"{faults},seed={seed}", *extra]
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phase25-child",
             json.dumps({"argv": argv, "dir": work, "tag": tag})],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        return tag, proc, time.perf_counter()

    def finish(started):
        tag, proc, t0 = started
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
        log(f"preempt: child {tag} exit {proc.returncode} in "
            f"{time.perf_counter() - t0:.2f} s")
        if proc.returncode not in (0, 3):
            log(out[-4000:])
            log(err[-4000:])
            fail(f"phase 25's child {tag} failed")
        with open(os.path.join(work, tag + ".pkl"), "rb") as f:
            return proc.returncode, pickle.load(f)

    def child(tag, spec, extra=()):
        return finish(start(tag, spec, extra))

    def strip(h):
        out = []
        for r in h:
            r = {k: v for k, v in r.items() if k not in timing}
            r["accuracy"] = r["accuracy"].tolist()
            out.append(r)
        return out

    def final(spec):
        tree, meta = ckpt.load_checkpoint(
            os.path.join(work, spec, "consensus_multi"))
        return tree, meta

    reference = None
    try:
        # the reference runs beside the preempted child and its resume
        reference = start("reference", "ref")
        rc, got = child("preempted", "run")
        if rc != 3 or got.get("preempted") != at:
            fail(f"child 1 ended {rc} {got}, not preempted at round {at}")
        slots = ckpt.checkpoint_slots(os.path.join(work, "run",
                                                   "consensus_multi_midrun"))
        log(f"preempt: child 1 preempted at round {at}; slots {slots}")
        rc, resumed = child("resumed", "run", ["--load-model"])
        _, ref = finish(reference)
        hr, h1 = strip(ref["history"]), strip(resumed["history"])
        tr, mr = final("ref")
        t1, m1 = final("run")
        same = (hr == h1 and mr == m1 and tr.keys() == t1.keys()
                and all(torch.equal(tr[k], t1[k]) for k in tr))
        log(f"preempt: resumed run vs reference: {len(h1)} and {len(hr)} "
            f"records, {len(t1)} and {len(tr)} tensors, bit for bit {same}")
        if not same:
            fail("the resumed run is not bit for bit the reference run")
        # damage the newest mid-run slot: resume falls back to the older
        # one, re-runs the last round and still ends equal
        newest = ckpt.checkpoint_slots(os.path.join(
            work, "run", "consensus_multi_midrun"))[0]
        with open(os.path.join(newest, ckpt.CHECKSUM_FILE), "w") as f:
            f.write("0" * 64 + "\n")
        rc, fallback = child("fallback", "run", ["--load-model"])
        t2, m2 = final("run")
        hf = strip(fallback["history"])
        same = (hf == hr and m2 == mr
                and all(torch.equal(tr[k], t2[k]) for k in tr))
        log(f"preempt: after damaging {os.path.basename(newest)}'s checksum "
            f"the resume from the older slot ends bit for bit equal: {same}")
        if not same:
            fail("the fallback resume is not bit for bit the reference run")
    finally:
        if reference is not None and reference[1].poll() is None:
            reference[1].kill()
            reference[1].wait()
        shutil.rmtree(work, ignore_errors=True)


def start_knobs():
    """Phase 32's start: one deterministic child that runs the six runs
    of ``KNOBS_CASES`` in turn (processes on one card time-slice it, so
    more children only add start-ups and warm-ups).  Started before phase
    30, so that its start-up runs beside phase 30 and its runs beside
    phase 31's host-only readers; :func:`finish_knobs` collects it."""
    import tempfile

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="knobs-", dir=os.path.join(ROOT, "build"))
    runs = {}
    for case, (both, off, on) in KNOBS_CASES.items():
        runs[f"{case}-off"] = [*KNOBS_BASE, *both, *off]
        runs[f"{case}-on"] = [*KNOBS_BASE, *both, *on]
    spec = {"runs": runs, "dir": work, "tag": "knobs"}
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase32-child",
         json.dumps(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, work, time.perf_counter()


def finish_knobs(started) -> dict:
    """Phase 32: the throughput knobs at full width (the child of
    :func:`start_knobs`), checked.  Returns the launches of B1, B2 and B3
    in the child's runs (every one a run of the main path)."""
    import pickle
    import shutil

    proc, work, t0 = started
    t_wait = time.perf_counter()
    try:
        out, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            log(out[-4000:])
            log(err[-4000:])
            fail(f"phase 32's child exited {proc.returncode}")
        with open(os.path.join(work, "knobs.pkl"), "rb") as f:
            runs = pickle.load(f)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    log(f"knobs child: start-up {runs.pop('startup_seconds'):.2f} s, runs "
        + ", ".join(f"{tag} {r['seconds']:.2f} s" for tag, r in runs.items()))
    wall, waited = time.perf_counter() - t0, time.perf_counter() - t_wait
    launches = {"quantize_chunks": 0, "dequant_add": 0, "gram": 0}
    for tag, r in runs.items():
        h = r["history"]
        for rec in h:
            for k in launches:
                launches[k] += rec["kernel_launches"][k]
        log(f"knobs {tag}: N={h[0]['N']} round_seconds "
            f"{[round(x['round_seconds'], 3) for x in h]} host_dispatches "
            f"{[x['host_dispatches'] for x in h]} launches "
            f"{[x['kernel_launches'] for x in h]}")

    def values(tag):
        return [(x["loss"], x.get("dual_residual"), x.get("primal_residual"))
                for x in runs[tag]["history"]]

    for case in ("fused", "overlap"):
        off, on = runs[case + "-off"], runs[case + "-on"]
        same = (off["digest"] == on["digest"]
                and values(case + "-off") == values(case + "-on"))
        log(f"knobs {case}: knobs on vs off, parameters and every loss and "
            f"residual bit for bit: {same}")
        if not same:
            fail(f"phase 32 ({case}): the knobs change the numbers")
    hd = [[x["host_dispatches"] for x in runs["fused-" + s]["history"]]
          for s in ("off", "on")]
    if hd != [[2, 2], [1, 1]]:
        fail(f"phase 32 (fused): host_dispatches off/on {hd}, not "
             "[2, 2] and [1, 1]")
    for s in ("off", "on"):
        for x in runs["fused-" + s]["history"]:
            kl = x["kernel_launches"]
            if kl["quantize_chunks"] < 1 or kl["dequant_add"] < 1:
                fail(f"phase 32 (fused-{s}): B1/B2 not launched in a round "
                     f"({kl})")
        for x in runs["overlap-" + s]["history"]:
            if x["kernel_launches"]["gram"] < 1:
                fail(f"phase 32 (overlap-{s}): B3 not launched in a round")
    od = [x["overlap_dispatch_seconds"]
          for x in runs["overlap-on"]["history"]]
    if not (od[0] > 0 and od[-1] == 0.0):
        fail(f"phase 32 (overlap): overlap_dispatch_seconds {od}, not > 0 "
             "on the block's first round and 0.0 on its last")
    import torch

    a, b = runs["sharded-off"]["block"], runs["sharded-on"]["block"]
    err, ok = within(torch.from_numpy(b), torch.from_numpy(a), SHARDED_RTOL,
                     SHARDED_ATOL)
    bitwise = runs["sharded-off"]["digest"] == runs["sharded-on"]["digest"]
    log(f"knobs sharded: the trained block [{a.shape[0]}, {a.shape[1]}] "
        f"with --sharded-update (the replicated mean serves it on one "
        f"card) vs without: max |diff| {err:.3e} "
        f"(rtol {SHARDED_RTOL}, atol {SHARDED_ATOL}: within {ok}); every "
        f"parameter bit for bit: {bitwise}")
    if not ok:
        fail("phase 32 (sharded): the sharded update leaves the band")
    log(f"phase 32: {wall:.2f} s from its start (phases 30 and 31 ran "
        f"meanwhile), {waited:.2f} s of it after phase 31, launches "
        f"{launches}")
    return launches


def cpc_flat_blocks(trainer) -> dict:
    """{sub-model: flat index of its first block} over the CPC rotation,
    the coordinate the seeded draws key on."""
    from federated_pytorch_test_tpu_torch.train.cpc_engine import SUBMODELS

    out, n = {}, 0
    for m in SUBMODELS:
        out[m] = n
        n += len(trainer.models[m].train_order_block_ids())
    return out


def keep_stream(name: str, path: str) -> None:
    """Copy a phase's record stream out of its temporary directory for
    phase 31's readers (:data:`STREAMS_DIR`)."""
    import shutil

    os.makedirs(STREAMS_DIR, exist_ok=True)
    KEPT_STREAMS[name] = shutil.copyfile(
        path, os.path.join(STREAMS_DIR, f"{name}.jsonl"))


def read_stream(path: str) -> list:
    """The records of a JSONL stream, each checked with the port's
    ``validate_record``."""
    from federated_pytorch_test_tpu_torch.obs.report import read_records

    return read_records(path)


def run_cpc_attack(dev) -> dict:
    """Phase 26; returns the launches of B3, B4 and B5 in the run."""
    import shutil
    import tempfile

    import torch

    from federated_pytorch_test_tpu_torch.drivers import federated_cpc
    from federated_pytorch_test_tpu_torch.ops import gram, infonce
    from federated_pytorch_test_tpu_torch.parallel import comm
    from federated_pytorch_test_tpu_torch.train.faults import FaultSpec

    captured = {}
    chunked = comm.robust_federated_mean_chunked

    def capture(x, w=None, **kw):
        # the first exchange's shard slabs
        if "first" not in captured:
            captured["first"] = (x.detach().clone(), w.clone())
        return chunked(x, w, **kw)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="cpc-attack-",
                            dir=os.path.join(ROOT, "build"))
    comm.robust_federated_mean_chunked = capture
    try:
        gram.LAUNCHES["gram"] = 0
        for k in infonce.LAUNCHES:
            infonce.LAUNCHES[k] = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer, _, history = federated_cpc.main(
            [*CPC_ATTACK_ARGV, "--obs-dir", work], log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**infonce.LAUNCHES, **gram.LAUNCHES}
        records = read_stream(trainer.obs_recorder.jsonl_path)
    finally:
        comm.robust_federated_mean_chunked = chunked
        shutil.rmtree(work, ignore_errors=True)
    cfg, K = trainer.cfg, trainer.K
    log(f"cpc attack: {len(history)} rounds in {wall:.2f} s, launches "
        f"{launches}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev)} B")
    for rec in history:
        log(json.dumps({k: rec.get(k) for k in (
            "model", "block", "nadmm", "N", "loss", "dual_residual",
            "n_active", "fault_corrupted", "quarantined", "guard_trips",
            "n_ok", "round_seconds", "compute_seconds", "kernel_launches")}))
    if len(history) != CPC_ROUNDS:
        fail(f"expected {CPC_ROUNDS} rounds, got {len(history)}")
    # the stream: one round and one client record a round, in file order
    kinds = [(r["event"], r["round_index"]) for r in records
             if r["event"] in ("round", "client")]
    want = [(e, i) for i in range(len(history)) for e in ("round", "client")]
    if kinds != want:
        fail(f"the stream's round and client records are {kinds}")
    clients = [r for r in records if r["event"] == "client"]
    log(f"cpc attack: {len(records)} records, every one valid")
    # the numpy replay of the participation (tag 11), fault (tag 47) and
    # quarantine ledgers, keyed on the flat block index; the guard's
    # verdicts read from the client records
    spec = FaultSpec.parse(cfg.fault_spec)
    first = cpc_flat_blocks(trainer)
    q = np.zeros(K, np.int64)
    for rec, crec in zip(history, clients):
        if not (np.isfinite(rec["loss"]) and np.isfinite(rec["dual_residual"])):
            fail(f"non-finite loss or dual residual: {rec}")
        nloop, nadmm = rec["nloop"], rec["nadmm"]
        ci = first[rec["model"]] + rec["block"]
        rng = np.random.default_rng([cfg.seed, 11, nloop, ci, nadmm])
        base = (rng.random(K) < cfg.participation).astype(np.float32)
        if not base.any():
            base[int(rng.integers(K))] = 1.0
        drop, straggle, corrupt = spec.round_faults(K, nloop, ci, nadmm)
        comm_m = base * (1.0 - (q > 0)) * (1.0 - drop)
        corrupt = corrupt * comm_m
        n_comm, trains = int(comm_m.sum()), bool((comm_m * (1 - straggle)).any())
        got = (rec["n_active"], rec["fault_corrupted"], rec["quarantined"])
        if got != (n_comm, int(corrupt.sum()), int((q > 0).sum())):
            fail(f"round {crec['round_index']}: (n_active, fault_corrupted, "
                 f"quarantined) {got}, the replay ({n_comm}, "
                 f"{int(corrupt.sum())}, {int((q > 0).sum())})")
        kl = rec["kernel_launches"]
        if (kl["infonce_fwd"] > 0) != trains or \
                (kl["infonce_bwd"] > 0) != trains:
            fail(f"round {crec['round_index']}: InfoNCE launches {kl} with "
                 f"a client training: {trains}")
        if kl["gram"] != (2 if n_comm else 0):
            fail(f"round {crec['round_index']}: gram launched {kl['gram']} "
                 f"times with {n_comm} clients in the exchange")
        q = np.maximum(q - 1, 0)
        if n_comm:
            ok = np.asarray(crec["guard_ok"], np.float32)
            q[(comm_m > 0) & (ok < 0.5)] = cfg.quarantine_rounds
    log(f"cpc attack: the replay of {len(history)} rounds is equal")
    if "first" not in captured:
        fail("no exchange was captured")
    stack, w = captured["first"]
    masked_gram_check(stack, w, trainer,
                      f"cpc attack, N={stack.shape[1]}", need_masked=False)
    return launches


def profile_cpc_round(dev) -> None:
    """Phase 26's first round once more under ``--profile-dir``: the Chrome
    trace holds the round's ``record_function`` span; its device-busy
    share is printed, not checked."""
    import shutil
    import tempfile

    import torch

    from federated_pytorch_test_tpu_torch.drivers import federated_cpc
    from federated_pytorch_test_tpu_torch.train import cpc_engine
    from federated_pytorch_test_tpu_torch.utils.profiling import TRACE_FILE

    class OneRound(Exception):
        pass

    step = cpc_engine.CPCTrainer._step_round

    def one_round(self, *a, **kw):
        step(self, *a, **kw)
        raise OneRound

    work = tempfile.mkdtemp(prefix="cpc-profile-",
                            dir=os.path.join(ROOT, "build"))
    cpc_engine.CPCTrainer._step_round = one_round
    try:
        t0 = time.perf_counter()
        try:
            federated_cpc.main([*CPC_ATTACK_ARGV, "--obs-sinks", "none",
                                "--profile-dir", work], log=lambda m: None)
        except OneRound:
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        path = os.path.join(work, TRACE_FILE)
        if not os.path.isfile(path):
            fail(f"--profile-dir wrote no {TRACE_FILE}")
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        cpc_engine.CPCTrainer._step_round = step
        shutil.rmtree(work, ignore_errors=True)
    spans = [e for e in events if e.get("name") == "comm_round#0"
             and e.get("ph") == "X"]
    if not spans:
        fail("the trace holds no comm_round#0 span")
    s0 = min(float(e["ts"]) for e in spans)
    s1 = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    busy = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
            if b > s0 and a < s1:
                busy.append((max(a, s0), min(b, s1)))
    busy.sort()
    total, end = 0.0, -1e300
    for a, b in busy:
        if b > end:
            total += b - max(a, end)
            end = b
    log(f"profile: one round of phase 26 under --profile-dir in "
        f"{wall:.2f} s, trace {size} B, {len(events)} events; the round's "
        f"span {(s1 - s0) / 1e3:.3f} ms, {len(busy)} kernels, device busy "
        f"{total / 1e3:.3f} ms ({100 * total / max(s1 - s0, 1e-9):.1f}%)")


def run_cpc_preempt() -> dict:
    """Phase 27: supervised CPC preemption in deterministic child
    processes; returns the InfoNCE launches of the children."""
    import pickle
    import shutil
    import tempfile

    import torch

    from federated_pytorch_test_tpu_torch.control.replay import main as replay
    from federated_pytorch_test_tpu_torch.control.supervisor import (
        restart_backoff_seconds,
    )
    from federated_pytorch_test_tpu_torch.utils import checkpoint as ckpt

    seed, at = preempt_schedule(CPC_BLOCKS, CPC_NADMM, CPC_PREEMPT_P)
    log(f"cpc preempt: seed {seed}, p {CPC_PREEMPT_P}: the preemption "
        f"fires at round {at} (flat block {at // CPC_NADMM}, nadmm "
        f"{at % CPC_NADMM})")
    work = tempfile.mkdtemp(prefix="cpc-preempt-",
                            dir=os.path.join(ROOT, "build"))
    timing = lambda k: k.endswith("_seconds")
    procs = {}
    try:
        for tag, pre in (("preempted", f",preempt={CPC_PREEMPT_P}"),
                         ("reference", "")):
            argv = [*CPC_PREEMPT_ARGV, "--checkpoint-dir",
                    os.path.join(work, tag), "--fault-spec",
                    f"{CPC_PREEMPT_FAULTS}{pre},seed={seed}"]
            procs[tag] = (subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--phase25-child",
                 json.dumps({"argv": argv, "dir": work, "tag": tag,
                             "driver": "federated_cpc"})],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
                time.perf_counter())
        out = {}
        for tag, (proc, t0) in procs.items():
            try:
                so, se = proc.communicate(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
            log(f"cpc preempt: child {tag} exit {proc.returncode} in "
                f"{time.perf_counter() - t0:.2f} s")
            if proc.returncode != 0:
                log(so[-4000:])
                log(se[-4000:])
                fail(f"phase 27's child {tag} failed")
            with open(os.path.join(work, tag + ".pkl"), "rb") as f:
                out[tag] = pickle.load(f)
        strip = lambda h: [{k: v for k, v in r.items() if not timing(k)}
                           for r in h]
        ha, hb = strip(out["preempted"]["history"]), \
            strip(out["reference"]["history"])
        ta, ma = ckpt.load_checkpoint(os.path.join(work, "preempted",
                                                   "federated_cpc"))
        tb, mb = ckpt.load_checkpoint(os.path.join(work, "reference",
                                                   "federated_cpc"))
        same = (ha == hb and ma == mb and ta.keys() == tb.keys()
                and all(torch.equal(ta[k], tb[k]) for k in ta))
        log(f"cpc preempt: supervised run vs reference: {len(ha)} and "
            f"{len(hb)} records, {len(ta)} and {len(tb)} tensors, bit for "
            f"bit {same}")
        if not same or len(ha) != CPC_BLOCKS * CPC_NADMM:
            fail("the supervised CPC run is not bit for bit the reference")
        path = os.path.join(work, "preempted", "obs", "federated_cpc.jsonl")
        ctl = [r for r in read_stream(path) if r["event"] == "control"]
        log(f"cpc preempt: control records "
            f"{[(r['intervention'], r.get('attempt'), r.get('backoff_seconds')) for r in ctl]}")
        want = restart_backoff_seconds(0.5, CPC_SEED, 1)
        if ([(r["intervention"], r.get("attempt")) for r in ctl]
                != [("restart", 1)] or ctl[0]["backoff_seconds"] != want
                or not 0.25 <= want <= 0.75
                or ctl[0]["round_index"] != at):
            fail(f"the preempted stream's control records are {ctl}, not "
                 f"one restart (attempt 1, backoff {want}) at round {at}")
        if replay([path]) != 0:
            fail("the port's control.replay rejects the supervised stream")
        launches = {k: out["preempted"]["launches"][k]
                    + out["reference"]["launches"][k]
                    for k in out["reference"]["launches"]}
        log(f"cpc preempt: children's InfoNCE launches {launches}")
        return launches
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)


def run_chaos(dev) -> dict:
    """Phase 28: classifier chaos with the shield rung; returns the B1 and
    B2 launches of the run."""
    import shutil
    import tempfile

    import torch

    from federated_pytorch_test_tpu_torch.control.replay import main as replay
    from federated_pytorch_test_tpu_torch.drivers import common, consensus_multi
    from federated_pytorch_test_tpu_torch.ops import quant
    from federated_pytorch_test_tpu_torch.utils.tree import leaves

    from federated_pytorch_test_tpu_torch.train.rounds import RoundKernel

    built, synced = [], []
    make, obs_sync = common.make_trainer, RoundKernel._obs_sync

    def recording(cfg, *a, **kw):
        built.append((cfg.compress, cfg.update_guard, cfg.quarantine_rounds))
        return make(cfg, *a, **kw)

    def timed_sync(self, obs):
        # the host seconds the recorder's phase syncs wait
        t0 = time.perf_counter()
        obs_sync(self, obs)
        synced.append(time.perf_counter() - t0)

    work = tempfile.mkdtemp(prefix="chaos-", dir=os.path.join(ROOT, "build"))
    common.make_trainer = recording
    RoundKernel._obs_sync = timed_sync
    try:
        for k in quant.LAUNCHES:
            quant.LAUNCHES[k] = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer, state, history = consensus_multi.main(
            [*CHAOS_ARGV, "--checkpoint-dir", work], log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(quant.LAUNCHES)
        path = os.path.join(work, "obs", "consensus_multi.jsonl")
        records = read_stream(path)
        keep_stream("chaos", path)
        ok = replay([path])
        # one restart's backoff forged: the replay must refuse it
        forged = os.path.join(work, "forged.jsonl")
        with open(path) as f, open(forged, "w") as g:
            done = False
            for line in f:
                r = json.loads(line)
                if (not done and r["event"] == "control"
                        and r["intervention"] == "restart"):
                    r["backoff_seconds"] = 99.0
                    line, done = json.dumps(r) + "\n", True
                g.write(line)
        bad = replay([forged])
    finally:
        common.make_trainer = make
        RoundKernel._obs_sync = obs_sync
        shutil.rmtree(work, ignore_errors=True)
    n_run = sum(1 for r in records if r["event"] == "round")
    log(f"chaos: obs phase syncs waited {sum(synced):.4f} s over {n_run} "
        f"recorded rounds ({sum(synced) / max(n_run, 1) * 1e3:.3f} ms a "
        f"round, {len(synced)} syncs)")
    log(f"chaos: {len(history)} rounds in {wall:.2f} s over "
        f"{len(built)} trainers {built}, launches {launches}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated(dev)} B")
    for r in records:
        if r["event"] in ("alert", "control", "run_header"):
            log(json.dumps({k: r.get(k) for k in (
                "event", "rule", "intervention", "round_index", "attempt",
                "param", "to_value", "backoff_seconds", "ladder_stage",
                "rounds_prior")}))
    for rec in history:
        log(json.dumps({k: rec.get(k) for k in (
            "block", "nadmm", "N", "loss", "primal_residual", "dual_residual",
            "n_active", "fault_corrupted", "guard_trips", "quarantined",
            "round_seconds", "kernel_launches")}))
    if len(history) != SLICE2_ROUNDS:
        fail(f"expected {SLICE2_ROUNDS} rounds, got {len(history)}")
    if not all(bool(torch.isfinite(t).all()) for t in leaves(state.params)):
        fail("the chaos run's final parameters are not finite")
    if built != [("q8", False, 1), ("q8", False, 1), ("q4", True, 2)]:
        fail(f"the attempts ran {built}, not q8, q8, then q4 with the guard")
    ctl = [r for r in records if r["event"] == "control"]
    sup = [r for r in ctl if r["source"] == "supervisor"]
    restarts = [r["attempt"] for r in sup if r["intervention"] == "restart"]
    ladder = {(r["param"], r["to_value"], r["ladder_stage"]) for r in sup
              if r["intervention"] == "ladder_override"}
    if restarts != [1, 2]:
        fail(f"restart attempts {restarts}, not [1, 2]")
    if ladder != {("compress", "q4", 1), ("update_guard", True, 1),
                  ("quarantine_rounds", 2, 1)}:
        fail(f"ladder overrides {ladder}")
    if any("time_unix" in r for r in ctl):
        fail("a control record carries time_unix")
    log(f"chaos: replay {ok} on the stream, {bad} with a forged backoff")
    if (ok, bad) != (0, 1):
        fail("the port's control.replay does not accept the honest stream "
             "and refuse the forged one")
    for rec in history:
        kl = rec["kernel_launches"]
        if rec.get("n_active", 0) > 0 and not (
                kl["quantize_chunks"] > 0 and kl["dequant_add"] > 0):
            fail(f"B1/B2 not launched in exchanging round (block "
                 f"{rec['block']}, nadmm {rec['nadmm']}): {kl}")
    return launches


# ---------------------------------------------------------------------------
# slice 8: the serving plane and the soak campaigns (phases 29-30)
# ---------------------------------------------------------------------------
def run_serving(dev) -> int:
    """Phase 29; returns the Gram launches of the run."""
    import math
    import shutil
    import tempfile

    import torch

    from federated_pytorch_test_tpu_torch.control.replay import main as replay
    from federated_pytorch_test_tpu_torch.drivers import consensus_multi
    from federated_pytorch_test_tpu_torch.ops import gram
    from federated_pytorch_test_tpu_torch.serve import (
        SERVE_FIELDS,
        ServeSchedule,
    )
    from federated_pytorch_test_tpu_torch.train.engine import _normalize_u8
    from federated_pytorch_test_tpu_torch.utils.tree import tree_map

    work = tempfile.mkdtemp(prefix="serve-", dir=os.path.join(ROOT, "build"))
    try:
        gram.LAUNCHES["gram"] = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer, state, history = consensus_multi.main(
            [*SERVE_ARGV, "--checkpoint-dir", work], log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = gram.LAUNCHES["gram"]
        path = os.path.join(work, "obs", "consensus_multi.jsonl")
        records = read_stream(path)
        keep_stream("serving", path)
        ok = replay([path])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    sched = ServeSchedule.parse(SERVE_SPEC)
    plane = trainer._serve_plane
    serves = [r for r in records if r["event"] == "serve"]
    log(f"serving: {len(history)} rounds in {wall:.2f} s, gram launches "
        f"{launches}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev)} B")
    for r in serves:
        log(json.dumps({k: r.get(k) for k in (
            "round_index", "weights_version", "requests", "batches",
            "padded_slots", "swap", "drift_injected", "serve_accuracy",
            "drift_score", "serve_p50_ms", "serve_p99_ms", "serve_qps",
            "swap_gap_seconds", "forced_refresh")}))
    for r in records:
        if r["event"] in ("alert", "control"):
            log(json.dumps({k: r.get(k) for k in (
                "event", "rule", "intervention", "param", "round_index",
                "observed", "threshold")}))
    lat = {k: [r[k] for r in serves] for k in (
        "serve_p50_ms", "serve_p99_ms", "serve_qps")}
    gaps = [r["swap_gap_seconds"] for r in serves if "swap_gap_seconds" in r]
    log(f"serving on the card: serve_p50_ms median "
        f"{statistics.median(lat['serve_p50_ms'])}, serve_p99_ms median "
        f"{statistics.median(lat['serve_p99_ms'])} (max "
        f"{max(lat['serve_p99_ms'])}), serve_qps median "
        f"{statistics.median(lat['serve_qps'])}, swap_gap_seconds "
        f"{gaps}; predictor dispatches {plane['pred'].dispatches}, shapes "
        f"{sorted(plane['pred'].shapes_seen)}")
    if len(history) != SERVE_ROUNDS or len(serves) != SERVE_ROUNDS:
        fail(f"expected {SERVE_ROUNDS} rounds and serve records, got "
             f"{len(history)} and {len(serves)}")
    for i, r in enumerate(serves):
        got = {k: r[k] for k in SERVE_FIELDS}
        if got != sched.record_fields(i):
            fail(f"serve record {i}: {got}, the schedule "
                 f"{sched.record_fields(i)}")
    log(f"serving: control.replay {ok} on the stream")
    if ok != 0:
        fail("the port's control.replay refuses the serving stream")
    forced = [r["round_index"] for r in serves if r.get("forced_refresh")]
    published = [r["round_index"] for r in serves
                 if "swap_gap_seconds" in r]
    want = sorted({i for i in range(SERVE_ROUNDS) if sched.swap(i)}
                  | set(forced))
    n_swap = math.ceil(SERVE_ROUNDS / sched.swap_every)
    if (published != want or plane["buffer"].swaps != len(want)
            or len(want) != n_swap + sum(not sched.swap(i) for i in forced)):
        fail(f"publishes at rounds {published} ({plane['buffer'].swaps} "
             f"swaps), expected {want}")
    if plane["buffer"].version != sched.weights_version(SERVE_ROUNDS - 1):
        fail(f"the last published version {plane['buffer'].version}")
    alerts = [r["round_index"] for r in records if r["event"] == "alert"
              and r["rule"] == "serve_drift"]
    swaps = [r["round_index"] for r in records if r["event"] == "control"
             and r.get("param") == "serve_swap"]
    log(f"serving: serve_drift alerts {alerts}, serve_swap controls "
        f"{swaps}, forced refreshes {forced}")
    if not (alerts and swaps and forced and min(alerts) >= sched.drift_at
            and swaps[0] == alerts[0] and forced[0] == swaps[0] + 1):
        fail("the drift chain (serve_drift alert, serve_swap control, "
             "forced refresh on the next round) did not run through")
    buckets = {(b, 32, 32, 3) for b in sched.buckets}
    if not plane["pred"].shapes_seen <= buckets:
        fail(f"served shapes {plane['pred'].shapes_seen} outside the "
             "buckets")
    for rec in history:
        if rec["kernel_launches"]["gram"] < 1:
            fail(f"the Gram kernel was not launched in round {rec}")
    # the card's consensus against a float32 CPU forward of the same weights
    _, weights = plane["buffer"].acquire()
    cpu_w = [tree_map(lambda t: t.detach().cpu(), w) for w in weights]
    norm = torch.from_numpy(np.asarray(
        trainer._client_norm_host.mean(axis=0), np.float32))
    for b in sched.buckets:
        x = plane["pool_x"][:b]
        card = plane["pred"](weights, x)
        with torch.inference_mode():
            cpu = trainer.model.apply(
                *cpu_w, _normalize_u8(torch.from_numpy(x), norm),
                train=False)[0].numpy()
        err = float(np.abs(card - cpu).max() / np.abs(cpu).max())
        log(f"serving: bucket {b}, served logits vs the CPU forward: max "
            f"|diff| / max |cpu| {err:.3e} (limit {SERVE_LOGIT_RTOL})")
        if not err <= SERVE_LOGIT_RTOL:
            fail(f"bucket {b}: the served logits differ from the CPU "
                 f"forward by {err:.3e}")
    return launches


def campaign_replay(cfg, sched, history, verdicts) -> list:
    """The numpy replay of the campaign's draws under the guard (no
    participation, population or async): per round, the count fields the
    round record must carry.  ``verdicts``: round index -> the guard's [K]
    verdicts of the stream's client record."""
    K = cfg.K
    members = np.ones(K, bool)
    quarantine = np.zeros(K, np.int64)
    out = []
    for r, rec in enumerate(history):
        nloop, ci, nadmm = rec["nloop"], rec["block"], rec["nadmm"]
        spec = sched.spec_for(sched.window(r))
        new = spec.round_churn(members, nloop, ci, nadmm)
        joined, left = new & ~members, members & ~new
        quarantine[left] = 0
        members = new
        base = members.astype(np.float32)
        ok = (quarantine == 0).astype(np.float32)
        drop, straggle, corrupt = spec.round_faults(K, nloop, ci, nadmm)
        comm = base * ok * (1.0 - drop)
        out.append({
            "n_active": float(comm.sum()),
            "fault_dropped": int(np.sum(base * ok * drop)),
            "fault_straggled": int(np.sum(comm * straggle)),
            "fault_corrupted": int(np.sum(corrupt * comm)),
            "members_active": int(members.sum()),
            "joined": int(joined.sum()), "left": int(left.sum())})
        okf = np.asarray(verdicts.get(r, np.ones(K)), np.float32)
        quarantine = np.maximum(quarantine - 1, 0)
        quarantine[(comm > 0) & (okf < 0.5)] = cfg.quarantine_rounds
    return out


def run_soak_campaign(dev) -> dict:
    """Phase 30; returns the B1/B2 launches of the run."""
    import shutil
    import tempfile

    import torch

    from federated_pytorch_test_tpu_torch.campaign.schedule import (
        CampaignSchedule,
    )
    from federated_pytorch_test_tpu_torch.control.replay import replay
    from federated_pytorch_test_tpu_torch.control.supervisor import (
        restart_backoff_seconds,
    )
    from federated_pytorch_test_tpu_torch.drivers import common, federated_multi
    from federated_pytorch_test_tpu_torch.ops import quant
    from federated_pytorch_test_tpu_torch.utils.tree import leaves

    sched = CampaignSchedule.parse(SOAK_SPEC)
    windows = [sched.window(r) for r in range(SOAK_ROUNDS)]
    for w in windows:
        log(json.dumps({k: getattr(w, k) for k in (
            "round_index", "hour", "phase", "arrival_frac", "drop_p",
            "straggle_p", "corrupt_p", "join_p", "leave_p", "storm",
            "burst", "preempt_now")}))
    if not (any(w.storm for w in windows) and any(w.burst for w in windows)):
        fail("the campaign's run holds no storm or no burst")
    soak, clocks = common.run_soak, []

    def capturing(*args, **kw):
        result, clock = soak(*args, **kw)
        clocks.append(clock)
        return result, clock

    work = tempfile.mkdtemp(prefix="soak-", dir=os.path.join(ROOT, "build"))
    common.run_soak = capturing
    try:
        for k in quant.LAUNCHES:
            quant.LAUNCHES[k] = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer, state, history = federated_multi.main(
            [*SOAK_ARGV, "--checkpoint-dir", work], log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(quant.LAUNCHES)
        path = os.path.join(work, "obs", "federated_multi.jsonl")
        records = read_stream(path)
        keep_stream("soak", path)
    finally:
        common.run_soak = soak
        shutil.rmtree(work, ignore_errors=True)
    cfg = trainer.cfg
    fields = ("n_active", "fault_dropped", "fault_straggled",
              "fault_corrupted", "members_active", "joined", "left")
    log(f"soak: {len(history)} rounds in {wall:.2f} s, launches {launches}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated(dev)} B, "
        f"{clocks[0]!r}" if clocks else "soak: no clock")
    for rec in history:
        log(json.dumps({k: rec.get(k) for k in (
            "block", "N", "loss", *fields, "guard_trips", "quarantined",
            "round_seconds", "ckpt_write_seconds", "kernel_launches")}))
    if len(history) != SOAK_ROUNDS:
        fail(f"expected {SOAK_ROUNDS} rounds, got {len(history)}")
    if not all(bool(torch.isfinite(t).all()) for t in leaves(state.params)):
        fail("the soak run's final parameters are not finite")
    if not all(np.isfinite(rec["loss"]) for rec in history):
        fail("a soak round's loss is not finite")
    sup = [r for r in records if r["event"] == "control"
           and r["source"] == "supervisor"]
    restarts = [(r["round_index"], r["attempt"], r["backoff_seconds"])
                for r in sup if r["intervention"] == "restart"]
    log(f"soak: supervisor records {[r['intervention'] for r in sup]}, "
        f"restarts {restarts}")
    want_backoff = restart_backoff_seconds(cfg.restart_backoff, cfg.seed, 1)
    if restarts != [(SOAK_PREEMPT_ROUND, 1, want_backoff)]:
        fail(f"restarts {restarts}, not one at round {SOAK_PREEMPT_ROUND} "
             f"with backoff {want_backoff}")
    errors, stats = replay(records)
    log(f"soak: replay {stats}, errors {errors}")
    if errors or not stats["campaign_records"] or stats["segments"] != 2:
        fail("the port's control.replay does not accept the campaign stream")
    verdicts = {r["round_index"]: r["guard_ok"] for r in records
                if r["event"] == "client" and "guard_ok" in r}
    for r, (rec, want) in enumerate(zip(history, campaign_replay(
            cfg, sched, history, verdicts))):
        got = {k: rec.get(k) for k in fields}
        if got != want:
            fail(f"round {r}: {got}, the replay {want}")
    clock = clocks[0]
    if not (clock.accel == SOAK_ACCEL and clock.virtual_slept == want_backoff
            and clock.wall_slept == want_backoff / SOAK_ACCEL):
        fail(f"the virtual clock {clock!r} does not divide the recorded "
             f"backoff {want_backoff} by {SOAK_ACCEL}")
    for rec in history:
        kl = rec["kernel_launches"]
        if rec["n_active"] > 0 and not (
                kl["quantize_chunks"] > 0 and kl["dequant_add"] > 0):
            fail(f"B1/B2 not launched in exchanging round {rec['block']}: "
                 f"{kl}")
    if min(launches.values()) < 1:
        fail(f"B1/B2 not launched over the soak: {launches}")
    return launches



def reader(module: str, *args: str) -> str:
    """``python -m <module> <args>`` from the checkout, as a user runs a
    reader; its standard output.  Fails the script unless it exits 0."""
    p = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    if p.returncode != 0:
        fail(f"{module} {' '.join(args)} exited {p.returncode}: "
             f"{p.stderr[-2000:]}")
    return p.stdout


def check_stream_reads(name: str, path: str, outs: dict) -> None:
    """Phase 31's checks on one stream, from the outputs of report,
    trace, clients and profile."""
    from federated_pytorch_test_tpu_torch.obs.trace import (
        validate_chrome_trace,
    )

    records = read_stream(path)
    rounds = [r for r in records if r["event"] == "round"]
    wire = [r["bytes_on_wire"] for r in rounds
            if isinstance(r.get("bytes_on_wire"), (int, float))]
    K = next(r["config"]["K"] for r in records
             if r["event"] == "run_header")
    s = json.loads(outs["report"])
    with open(trace_path(name)) as f:
        trace = json.load(f)
    validate_chrome_trace(trace)
    spans = sum(1 for e in trace["traceEvents"] if e["ph"] == "X")
    led = json.loads(outs["clients"])
    prof = json.loads(outs["profile"])
    log(f"readers {name}: {len(records)} records; report rounds "
        f"{s['rounds']} (stream {len(rounds)}), bytes_on_wire_total "
        f"{s['bytes_on_wire_total']} (stream {sum(wire) if wire else None}),"
        f" segments {s['segments']}, status {s['status']}; trace {spans} "
        f"spans; ledger {len(led['ranking'])} clients, top offender "
        f"{led['summary'].get('top_offender')}; profile rounds "
        f"{prof['rounds']}, compile events {prof['compile_events']}, "
        f"attribution coverage {prof['attribution']['coverage']}")
    if s["rounds"] != len(rounds) or s["bytes_on_wire_total"] != (
            sum(wire) if wire else None):
        fail(f"{name}: the report's rounds or bytes on the wire differ "
             "from the stream's own")
    if spans == 0 or len(led["ranking"]) != K or \
            led["summary"].get("clients_observed") != K:
        fail(f"{name}: {spans} trace spans, a ledger of "
             f"{len(led['ranking'])} clients (K = {K})")
    if prof["rounds"] != len(rounds) or prof["compile_events"]:
        fail(f"{name}: the profile reads {prof['rounds']} rounds and "
             f"{prof['compile_events']} compile events")


def trace_path(name: str) -> str:
    return os.path.join(STREAMS_DIR, f"{name}.trace.json")


def run_readers() -> None:
    """Phase 31's readers: each of phase 28-30's streams through the
    port's report, trace, clients and profile CLIs, phase 29's stream
    compared with itself, and the chained report selftest on the card in
    a process that imports no JAX; all the processes in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    if sorted(KEPT_STREAMS) != ["chaos", "serving", "soak"]:
        fail(f"phase 31 got the streams {sorted(KEPT_STREAMS)}")
    t0 = time.perf_counter()
    obs = "federated_pytorch_test_tpu_torch.obs."
    selftest = ("import sys; from federated_pytorch_test_tpu_torch.obs "
                "import report; rc = report.main(['--selftest', "
                "'--device', 'cuda']); print('jax loaded:', 'jax' in "
                "sys.modules); sys.exit(rc)")
    serving = KEPT_STREAMS["serving"]
    with ThreadPoolExecutor(16) as pool:
        st = pool.submit(subprocess.run, [sys.executable, "-c", selftest],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
        cmp = pool.submit(reader, obs + "compare", serving, "--baseline",
                          serving, "--json")
        reads = {name: {
            "report": pool.submit(reader, obs + "report", "--json", path),
            "trace": pool.submit(reader, obs + "trace", path, "-o",
                                 trace_path(name)),
            "clients": pool.submit(reader, obs + "clients", "--json", path),
            "profile": pool.submit(reader, obs + "profile", "--json", path),
        } for name, path in sorted(KEPT_STREAMS.items())}
        for name, futures in reads.items():
            check_stream_reads(name, KEPT_STREAMS[name],
                               {k: f.result() for k, f in futures.items()})
        res = json.loads(cmp.result())
        st = st.result()
    verdicts = {}
    for row in res["rows"]:
        for c in row["cells"]:
            verdicts[c["verdict"]] = verdicts.get(c["verdict"], 0) + 1
    log(f"readers: compare of the serving stream with itself: "
        f"{res['regressions']} regressions, verdicts {verdicts}")
    if res["regressions"] or set(verdicts) - {"ok(noise)", "info"}:
        fail("the serving stream compared with itself gives a verdict "
             "other than ok(noise) (info rows carry none)")
    log("readers: report --selftest on the card: "
        + " | ".join(st.stdout.strip().splitlines()[-4:]))
    if st.returncode != 0 or not st.stdout.strip().endswith(
            "jax loaded: False"):
        fail(f"report --selftest exited {st.returncode}: {st.stderr[-2000:]}")
    log(f"readers: phase 31's readers in {time.perf_counter() - t0:.2f} s")


def run_lbfgs_full(dev) -> None:
    """Phase 31's full-batch L-BFGS: one step of the cubic strong-Wolfe
    search on a stiff quadratic of LBFGS_FULL_N float32 on the card,
    and the same call on the CPU."""
    import torch

    from federated_pytorch_test_tpu_torch.optim.lbfgs import LBFGSNew

    gen = torch.Generator().manual_seed(31)
    h = torch.logspace(-2, 2, LBFGS_FULL_N)
    x0 = torch.randn(LBFGS_FULL_N, generator=gen)
    opt = LBFGSNew(history_size=7, max_iter=LBFGS_FULL_ITERS,
                   line_search_fn=True, batch_mode=False)

    def one_step(device):
        hd = h.to(device)
        f = lambda x: 0.5 * torch.sum(hd * x * x)
        x = x0.to(device)
        t0 = time.perf_counter()
        x1, st, loss0 = opt.step(f, x, opt.init(x))
        loss1 = float(f(x1))
        return x1.cpu(), st, float(loss0), loss1, time.perf_counter() - t0

    gx, gst, g0, g1, gs = one_step(dev)
    cx, cst, c0, c1, cs = one_step(torch.device("cpu"))
    err = float((gx - cx).abs().max() / cx.abs().max())
    log(f"lbfgs full batch: n {LBFGS_FULL_N}, max_iter {LBFGS_FULL_ITERS}; "
        f"card loss {g0:.6e} -> {g1:.6e}, {gst.func_evals} closure "
        f"evaluations, t {float(gst.t):.6e}, {gs:.3f} s; CPU loss "
        f"{c0:.6e} -> {c1:.6e}, {cst.func_evals} evaluations, {cs:.3f} s; "
        f"max |x_card - x_cpu| / max |x_cpu| {err:.3e} (limit "
        f"{LBFGS_FULL_RTOL})")
    if not (np.isfinite(g1) and g1 < g0 and bool(torch.isfinite(gx).all())):
        fail(f"the full-batch L-BFGS did not lower the loss: {g0} -> {g1}")
    if gst.func_evals != cst.func_evals or not err <= LBFGS_FULL_RTOL:
        fail("the full-batch L-BFGS on the card differs from the CPU")

def main() -> None:
    import torch

    from concurrent.futures import ThreadPoolExecutor

    t_start = time.perf_counter()
    card, dev = check_device()
    sys.path.insert(0, ROOT)
    # phases 15-21 launch no hand-written kernel: they run while the three
    # compilers of phase 2 do
    with ThreadPoolExecutor(1) as pool:
        building = pool.submit(build)
        captured4, trainer4 = run_slice4(dev)
        check_topk_path_data(captured4, trainer4)
        del captured4, trainer4
        run_no_consensus(dev)
        run_fedprox(dev)
        run_lbfgs(dev)
        run_accuracy_comparison()
        run_vae("federated_vae", dev)
        run_vae("federated_vae_cl", dev)
        building.result()
    log(f"phases 2 and 15-21 in {time.perf_counter() - t_start:.1f} s")
    path_err, timing, device, extra = check_kernels(dev, card)
    gram_err, gram_timing, gram_device, extra["gram"] = check_gram(dev, card)
    trainer, launches = run_slice(dev)
    check_path_data(trainer)
    profile_steps(trainer)
    del trainer
    gram_launches, stack, trainer2, state2 = run_slice2(dev)
    raw_krum = check_gram_path_data(stack, trainer2)
    profile_slice2(trainer2, state2)
    del trainer2, state2, stack
    quant_err, quant_timing, quant_device, quant_extra = check_quant(dev, card)
    extra.update(quant_extra)
    # phases 33-34's child needs the kernels; it starts after the kernels'
    # timing (phases 3, 4, 11) and runs beside phases 12-32
    elastic_child = start_elastic()
    quant_launches, stack3, trainer3, state3 = run_slice3(dev)
    check_fused_path_data(stack3, trainer3)
    profile_comm_step(trainer3, state3)
    del trainer3, state3, stack3
    gram_launches += run_krum_attack(dev)
    for k, v in run_async_churn(dev).items():
        quant_launches[k] += v
    run_population(dev)
    run_preempt_resume()
    cpc = run_cpc_attack(dev)
    profile_cpc_round(dev)
    children = run_cpc_preempt()
    for k in launches:
        launches[k] += cpc[k] + children[k]
    gram_launches += cpc["gram"]
    for k, v in run_chaos(dev).items():
        quant_launches[k] += v
    gram_launches += run_serving(dev)
    # phase 32's child starts up (imports, data) beside phase 30, and runs
    # on the card beside phase 31's host-only readers
    knobs_child = start_knobs()
    for k, v in run_soak_campaign(dev).items():
        quant_launches[k] += v
    t31 = time.perf_counter()
    run_readers()
    run_lbfgs_full(dev)
    log(f"phase 31: {time.perf_counter() - t31:.2f} s")
    knobs = finish_knobs(knobs_child)
    gram_launches += knobs.pop("gram")
    for k, v in knobs.items():
        quant_launches[k] += v
    elastic = finish_elastic(elastic_child)
    for k in launches:
        launches[k] += elastic[k]
    gram_launches += elastic["gram"]
    for k in quant_launches:
        quant_launches[k] += elastic[k]
    log(f"summary: krum's selection on the raw y + rho*x stack, kernel vs "
        f"gram_plain: {raw_krum}")

    replaces = {"infonce_fwd": "federated_pytorch_test_tpu/ops/infonce.py:135",
                "infonce_bwd": "federated_pytorch_test_tpu/ops/infonce.py:262"}
    kernels = []
    for name, (k_ms, p_ms, (b_ms, b_by)) in timing.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "federated_pytorch_test_tpu_torch/csrc/infonce.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": path_err[name], "ms": k_ms,
            "device_ms": device[name], "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            **extra[name]})
    k_ms, p_ms, l_ms, (b_ms, b_by) = gram_timing
    kernels.append({
        "name": "gram", "route": "cuda",
        "source": "federated_pytorch_test_tpu_torch/csrc/gram.cu",
        "replaces": "federated_pytorch_test_tpu/ops/comm_kernels.py:250",
        "launches": gram_launches, "max_abs_err": gram_err, "ms": k_ms,
        "device_ms": gram_device, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": l_ms, **extra["gram"]})
    for name, (k_ms, p_ms, l_ms, (b_ms, b_by)) in quant_timing.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "federated_pytorch_test_tpu_torch/csrc/quant.cu",
            "replaces": {"quantize_chunks": QUANTIZE_SITE,
                         "dequant_add": DEQUANT_SITE}[name],
            "launches": quant_launches[name], "max_abs_err": quant_err[name],
            "ms": k_ms, "device_ms": quant_device[name], "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
            **extra[name]})
    log(f"chip_smoke: phases 1-34 in {time.perf_counter() - t_start:.1f} s")
    log(card)                        # again here, where an output tail keeps it
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase25-child"]:      # phases 25 and 27
        child_main(sys.argv[2])
    elif sys.argv[1:2] == ["--phase32-child"]:
        knobs_child_main(sys.argv[2])
    elif sys.argv[1:2] == ["--phase33-child"]:
        elastic_child_main(sys.argv[2])
    else:
        main()
