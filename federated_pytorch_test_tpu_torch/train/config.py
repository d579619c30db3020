"""Run configuration of the port's trainers.

The subset of ``federated_pytorch_test_tpu/train/config.py``'s
``FederatedConfig`` that the ported paths read (the CPC trainer and the
classifier drivers: FedAvg, FedProx, ADMM consensus and the no-consensus
baseline, with the robust or compressed exchange and Adam or L-BFGS, the
robustness shell of a round and its checkpoints, the record stream, the
health watchdog, the control plane, the restart supervisor, the soak
campaigns, the serving plane, the engine's throughput knobs, the elastic
resume and the sanitizer), with
the JAX package's defaults, plus the device the run uses.  A knob of the
JAX package that is missing here is not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FederatedConfig:
    K: int = 10                    # number of clients
    default_batch: int = 128       # minibatch size
    Nloop: int = 12                # loops over the whole network
    Nepoch: int = 1                # local epochs per round
    Nadmm: int = 3                 # communication rounds per block
    seed: int = 69                 # data-draw seed
    init_seed: int = 0             # common-init seed

    lambda1: float = 1e-4          # L1 on the fc blocks (reference quirk)
    lambda2: float = 1e-4          # L2
    admm_rho0: float = 1.0         # FedProx rho / ADMM penalty (0.1 consensus)

    init_model: bool = True        # Xavier kernels, 0.01 biases
    check_results: bool = True     # per-client test accuracy every round
    biased_input: bool = False     # per-client biased normalisation
    be_verbose: bool = False       # print every epoch's per-client losses
    use_resnet: bool = False       # model "auto" -> resnet18 instead of net
    model: str = "auto"            # auto|net|net1|net2|resnet9|resnet18
    norm: str = "batch"            # ResNet norm: batch | group
    bf16: bool = False             # bfloat16 convs/dense (params stay f32)

    robust_agg: str = "none"       # none|trim|median|clip|krum|geomed
    trim_frac: float = 0.1         # trim fraction; krum's attacker fraction
    clip_mult: float = 3.0         # clip at this x the median client norm
    robust_chunked: bool = False   # segment-owned robust aggregation
    num_devices: Optional[int] = None  # client-mesh shards (None: one)

    compress: str = "none"         # none|q8|q4|topk
    topk_frac: float = 0.01
    quant_chunk: int = 256         # values per quantization scale
    error_feedback: bool = False   # carry the compression residual
    fused_collective: bool = False  # keep the payloads packed on the wire

    bb_update: bool = False        # Barzilai-Borwein adaptive rho
    bb_period_T: int = 2
    bb_alphacorrmin: float = 0.2
    bb_epsilon: float = 1e-3
    bb_rhomax: float = 0.1

    optimizer: str = "adam"        # local optimizer: adam | lbfgs
    lr: float = 1e-3
    lbfgs_history_size: int = 10
    lbfgs_max_iter: int = 4

    # the robustness shell of a round (train/rounds.py)
    participation: float = 1.0     # per-round client sampling probability
    population: int = 0            # registered clients (0: off; >= K)
    cohort_sampling: str = "uniform"  # uniform|weighted|stratified
    cohort_frac: float = 1.0       # share of the K cohort slots active
    fault_spec: str = "none"       # train/faults.py grammar
    # soak campaigns (campaign/): a trace-driven schedule compiled per
    # round into the seeded fault and churn families, recorded as
    # `campaign` records that control.replay re-derives; "none" is off.
    # Mutually exclusive with fault_spec (the campaign owns the families'
    # probabilities per round).  Grammar:
    #   hours=H,round_minutes=M,diurnal=A,drop=P,straggle=P,corrupt=P,
    #   mode=M,scale=X,join=P,leave=P,storm=P,storm_len=N,
    #   storm_straggle=P,burst=P,burst_len=N,burst_corrupt=P,
    #   preempt_at=h1+h2,seed=N,accel=X,health_window_hours=H
    campaign_spec: str = "none"
    # virtual-clock acceleration of the soak harness (virtual seconds per
    # wall second); 0: the spec's accel= (else real time).  It scales
    # only the supervisor's sleeps, never a recorded value
    campaign_accel: float = 0.0
    # serving plane (serve/): the consensus hot-swapped into a bucketed
    # predictor at every round boundary, seeded traffic (tag 83) through
    # the micro-batcher, the answers scored as an eval stream feeding the
    # serve_drift rule and the control plane's refresh_serving rung; one
    # `serve` record a round, whose planning fields are pure in (seed,
    # round index).  "none" is off.  Grammar:
    #   qps=N,round_minutes=M,diurnal=A,buckets=8+32+128,swap_every=N,
    #   drift_at=R,seed=N
    serve_spec: str = "none"
    update_guard: bool = False     # finite + norm-bound check of updates
    guard_norm_mult: float = 10.0  # bound: this x the running accepted norm
    quarantine_rounds: int = 1     # rounds a rejected client sits out
    async_rounds: bool = False     # buffered asynchronous rounds
    max_staleness: int = 4         # admission cutoff, in comm rounds
    staleness_alpha: float = 0.5   # weight (1 + staleness)^-alpha

    # checkpoints (utils/checkpoint.py; drivers/common.py)
    checkpoint_dir: str = "./checkpoints"
    midrun_checkpoint: bool = False  # save after every comm round
    async_checkpoint: bool = False   # ... on a writer thread
    load_model: bool = False       # resume the mid-run slot / end-of-run params
    save_model: bool = True        # end-of-run checkpoint

    # the record stream (obs/), the watchdog (obs/health.py), the control
    # plane and the restart supervisor (control/); the JAX defaults
    profile_dir: Optional[str] = None  # torch.profiler Chrome trace here
    obs_dir: Optional[str] = None  # JSONL directory (drivers: <ckpt>/obs)
    obs_sinks: str = "auto"        # auto|none|jsonl|csv|stdout|memory,...
    health_action: str = "warn"    # off|warn|abort|checkpoint-abort
    health_streak: int = 3         # consecutive bad rounds before an alert
    health_window: int = 8         # EMA warm-up / rolling-median window
    health_loss_mult: float = 10.0  # divergence envelope multiplier
    health_tput_frac: float = 0.25  # collapse floor vs rolling median
    health_residual: bool = False  # trip on NaN/inf residuals too
    control: str = "off"           # off|observe|act
    control_policy: str = "default"  # hysteresis preset
    max_restarts: int = 0          # supervised restarts (0: unsupervised)
    restart_backoff: float = 1.0   # backoff base, seconds
    client_ledger: bool = True     # one `client` record a round

    data_dir: Optional[str] = None  # CIFAR-10 pickle batches (else synthetic)
    drop_last_sample: bool = True  # reference off-by-one parity
    prefetch: bool = True          # build epoch n+1's host batches ahead

    # the engine's throughput knobs (train/engine.py); each gives the same
    # numbers on and off, bit for bit
    # device-resident training data: the uint8 shards go to the device
    # once and every epoch is a gather there by the [K, steps*B] row
    # indices the host path draws (the same rows).  None = auto: on when
    # the shards fit FEDTPU_DEVICE_DATA_MB (default 2048); off, and True
    # raises, under population sampling
    device_data: Optional[bool] = None
    # one host call a round: the Nepoch local epochs on device-resident
    # data and the communication update, no host read or sync between its
    # first launch and the round's reads (the L-BFGS line search
    # excepted); falls back with a warning without device data, under
    # be_verbose or population
    fused_rounds: bool = False
    # stage the next epoch (H2D from pinned memory on a side stream)
    # between the comm step's launch and the host's first read of it
    overlap_staging: bool = False
    # launch round N+1's first local epoch before the host blocks on round
    # N's diagnostics; falls back with a warning under fused_rounds, the
    # update guard, async rounds, faults or churn, a campaign, population
    overlap_round: bool = False
    # the consensus mean as a reduce-scatter of the shard sums, a divide
    # on the owned segment and an all-gather (each coordinate the same
    # ordered sum and division as the replicated mean's).  Incompatible
    # with --robust-agg, and the fused collective wins when both are on
    sharded_update: bool = False

    # elastic federation (mesh-reshaping resume): a checkpoint written on a
    # D-shard client mesh restores onto a D'-shard one (K % D' must still
    # be 0); the supervisor's reshape rung rebuilds over the surviving
    # shard count after a CollectiveTimeoutError.  Off: a wrong-D resume
    # fails with a typed CheckpointGeometryError.  Bit for bit when
    # D' == D; when D' != D the mesh's summation order moves, so allclose
    elastic_resume: bool = False

    # preemption-tolerant collectives (parallel/mesh.py bounded_wait):
    # bound every multi-process barrier and fetch by this many seconds, so
    # a peer process lost to preemption surfaces as a typed
    # CollectiveTimeoutError (which the restart supervisor's reshape rung
    # acts on) instead of a hang.  0 = off (the literal unwrapped call,
    # no thread).  Also settable through FEDTPU_BARRIER_TIMEOUT
    barrier_timeout: float = 0.0
    # the runtime sanitizer (analysis/sanitize.py): every train, comm and
    # fused step (and the CPC round) runs under a dispatch mode that flags
    # the first NaN an op makes, a zero divisor and an out-of-range index,
    # and raises SanitizerError on the host after the step (one sync a
    # step: a debugging mode).  Off: no mode is entered
    sanitize: bool = False

    device: str = "cuda"           # "cuda" or "cpu" (the CPU only on request)
