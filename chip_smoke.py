"""On-card smoke of the PyTorch port (torchft_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --drills N # the build, then phases 6-17 (16b too), 20 and 20a N times

Any failure of a phase exits non-zero and prints no result line. The
schedule: phases 1-5 and then the bench (18) run alone, since they time the
card, and 18a (the host's ledger and gate over the bench's round) after
them; then phases 6-17, 20 and 20a run as ``drill_phases``: five lanes
of drills side by side (6, 16, 16a; 7, 8 and 12's drill; 15, 9 and 11;
16b's cnn drills; 16b's device-wire drills) beside 13's and 14's drills and
then the in-process phases (10, 12's and 14's checks, 17, 20, 20a) on the
main thread, watched by the host watch;
then 19 alone (it sets this process's environment, which any process
started meanwhile would inherit), 19a, and 21 alone (its wall has a
budget). Each phase's wall prints before the
kernels line. The phases:

1. The card's name and power limit (nvidia-smi); build every CUDA kernel of
   the training path from ``torchft_tpu_torch/ops/csrc`` with nvcc, one
   nvcc per source, all started together with the C++ control plane's
   build; then ``cuobjdump -sass`` of the
   flash library must show HGMMA (wgmma) instructions in the bf16 forward,
   dq and dk/dv bodies at every head_dim, and that of the quantization
   library no conversion or rounding instruction (I2F, I2FP, F2I, F2IP,
   FRND) and no spill in any instantiation of the reduce kernel (counts by
   opcode and ptxas' registers and spills in ``sass_check.json``).
1a. The engine library's C++ runtime: an engine library that links the C++
   runtime statically (the Makefile's flags and ``-static-libstdc++``) is
   planted in a scratch build directory under ``chiprun_out/``, and a fresh
   process points ``coordination._BIN_DIR`` at it and calls
   ``_native._load``. It must rebuild the library (its ``DT_NEEDED`` then
   lists ``libstdc++.so.6``), load it, run one two-rank engine allreduce
   and one ``fr_snapshot``, and exit 0. Prints both ``DT_NEEDED`` lists.
   It runs beside phase 1's build and SASS check (CPU work only).
2. Flash kernels: each kernel against its plain PyTorch version on the card,
   element by element (``TOL``), at the training path's shapes
   (llama_small: B=8, S=1024, Hq=12, Hkv=4, D=64, bf16) and at further
   shapes (fp32 D=64 and D=128, non-causal, a ragged length, and phase
   21's tp 2 shape, Hq=6, Hkv=2, in bf16 and fp32); timed with
   CUDA events beside its plain version, the one-call PyTorch equivalent
   (``F.scaled_dot_product_attention``, a yardstick the port never calls)
   and the least time the card could take. Also the model with flash
   attention against the model with dense attention on the same weights.
3. Block flash kernels (ring attention's fold): each against its plain
   version element by element (``TOL``; out only on rows that see a key) at
   the ring path's shapes (B=8, Sq=Skv=1024, llama_small's heads, bf16) and
   offsets (0,0), (1024,0), (1024,512), (0,1024) (all masked: out 0, lse
   <= -1e29, zero gradients), one fp32 case, one ragged case and phase
   21's sp 2 shards (Sq=Skv=512 at offsets (512,0), bf16 and fp32); timed
   at (0,0) and (1024,0). Then ``make_ring_attention`` at sp=4 on a mesh that
   repeats the card (B=2, S=4096): out, dq, dk, dv against the plain
   full-sequence versions within the ring limit derived beside
   ``RING_SLACK``, 16 launches of each block kernel.
4. Quantize kernels: the quantize and dequantize kernels, int8 and int4,
   against their plain versions on the card AND against the host quantizer
   that defines the wire (``collectives.quantize_blockwise`` /
   ``dequantize_blockwise``), bit for bit: 0 differing payload bytes, scale
   bits and dequantized bits, at the quantized paths' bucket sizes (the
   chunked embedding and lm_head buckets of llama_small, and ResNet-50's)
   and on special values.
   Timed at a 32 MiB bucket beside the plain versions and their bound.
5. Fused reduce kernel and the kernel harness: the int8 reduce against its
   plain version on the card AND against the host's reduce (each rank's
   payload dequantized and summed in rank order, divided by R if averaging,
   requantized by ``collectives.quantize_blockwise``), bit for bit, for
   R = 2, 3, 4 with and without averaging, on 1, 5 and 4096 rows, on
   special rows, on tie-heavy rows (exact half-integer quotients) and on
   quotient-boundary rows (quotients within a few ulps of the
   half-integers and around the kernel's guard band, scales from subnormal
   to near 2^121); timed at a 32 MiB bucket with R = 2, R = 4, R = 2
   averaging and R = 2 averaging on tie-heavy rows, beside its plain
   version and its bound. Then ``python -m
   torchft_tpu_torch.ops.bench_kernels`` in a process of its own: exit 0,
   ``ok`` true and every kernel of ``ops`` launched in it (the harness is
   the one path that runs the reduce: the training path reduces on the
   host).
6. Path: the C++ lighthouse and two replica groups of
   ``python -m torchft_tpu_torch.train_hsdp --model small --attn flash
   --batch 8 --seq 1024 --steps 8`` on the card, each group's one rank
   launched as torchrun launches it (``drill.kill_heal_drill``: a torch
   world of one NCCL rank with its own file store, the state born sharded
   by FSDP2 over it, as in every drill below); group 1 is SIGKILLed after
   step 3 and restarted, heals from group 0 by HTTP, and both must end at
   step 8 with bitwise-equal parameters, finite losses, and every flash
   kernel launched in both groups. The parameters must be the mesh-free
   trainer's (``MESH_FREE_FLASH_SHA``, PRs 10-13: FSDP2 at one rank moves
   no bit), and the relaunched group's journal must hold one HTTP
   ``heal_xfer`` receive of exactly the state's bytes, worked out from
   llama_small (params, exp_avg and exp_avg_sq in fp32 and a float32 step
   per parameter tensor; each DTensor's local shard is the whole tensor at
   one rank). The drill runs under ``TORCHFT_PERF=1``: each group process
   counts one grad step's FLOPs before its loop (``perf.record_step_cost``,
   which must leave the state as it found it: the sha above proves it),
   its journal must hold a ``perf_model`` event within 10% of
   ``perf.flops_per_step`` for its rows, and every committed step line a
   ``perf[`` suffix with an mfu in (0, 100%).
7. Quantized path: the same drill with ``--quantize`` (int8); both
   quantize kernels must launch in both groups too, and the final
   parameters must differ from the unquantized drill's.
8. Ring path: the same drill with ``--attn ring`` (sp=1 on one card: one
   block per layer); the three block kernels must launch in both groups,
   the whole-sequence flash kernels never, and it must end in the flash drill's
   parameters (at sp=1 the block kernels compute the whole-sequence
   kernels' bits: one body serves both).
9. DiLoCo path: two replica groups of ``python -m
   torchft_tpu_torch.train_diloco`` (llama_debug, dense attention at
   S=64, the arguments of the JAX package's DiLoCo kill/heal test:
   ``--outer-steps 10 --sync-every 4 --n-fragments 2 --fragment-sync-delay
   0 --quantize --quantize-bits 4 --error-feedback --batch-size 4
   --seq-len 64``) on the card; group 1 is SIGKILLed after outer step 2
   and restarted, heals the global state from group 0, and both must end
   at outer step 10 with equal ``global_sha``, finite losses and device
   ``cuda:0``. Its pseudogradients are quantized on the host, as in the
   JAX package, so no kernel of ``ops`` may launch. Prints the drill's
   wall time and each group's median inner-step and sync times.
10. LocalSGD: two ``LocalSGD`` replicas in threads of this process, each
   with its own Manager, against an in-process lighthouse, over
   llama_debug parameters on the card (different seeds); one
   ``sync_every=2`` round with the int8 quantized average. Both must
   commit and end with parameters equal to each other and to the host
   quantizer's int8 average of the same payloads, bit for bit, and the
   quantize and dequantize kernels must have launched for both replicas
   (the counts are set to 0 just before).
11. DDP path: two replica groups of ``python -m torchft_tpu_torch.train_ddp
   --model resnet50 --image-size 224 --num-classes 1000 --batch-size 32
   --steps 6 --quantize`` on the card (ResNet-50 at its published ImageNet
   widths, 25.56M parameters; int8 without error feedback, so the
   gradients take the device quantize path); group 1 is SIGKILLed after
   step 3 and restarted, heals params, Adam state and BatchNorm statistics
   from group 0, and both must end at step 6 with equal ``param_sha256``,
   finite losses and device ``cuda:0``; the BatchNorm statistics the
   relaunched group's first committed step started from must equal group
   0's at that step, bit for bit; the quantize and dequantize kernels must
   launch in both groups and no flash kernel in either. Prints each
   group's median step, images/s and phase split, and the drill's wall
   time.
12. Ulysses: ``make_ulysses_attention`` at sp=4 on a mesh that repeats the
   card (B=2, S=4096, llama_small's heads: 3 q heads and 1 kv head a rank)
   against the plain full-sequence versions within the ring limit, one
   launch of each flash kernel a rank; then the llama_small drill with
   ``--attn ulysses`` (sp=1: each layer one whole-sequence attention): the
   flash kernels must launch in both groups, the block kernels never, and
   it must end in the flash drill's parameters (the same kernels on the
   same inputs).
13. MoE path: the drill with ``--model moe --batch 8 --seq 64 --steps 6
   --quantize --quantize-bits 4`` (llama_moe_debug, 4 experts, top-2, the
   router's aux loss; the JAX package's model-heal drill's int4 wire): both
   must end at step 6 with equal parameters, both quantize kernels launched
   in both groups and no attention kernel, and a nonzero router gradient.
14. GPipe: the pipeline loss and gradients at pp=2 on a mesh that repeats
   the card against pp=1 on the same weights and batch (llama_debug with 4
   layers, fp32, 2 microbatches) within ``PIPELINE_TOL``; then the drill
   with ``--model pipeline`` and phase 13's other arguments, held as
   phase 13's.
15. pg-sharded heal: the flash drill with ``--ckpt-transport pg-sharded``
   (params and AdamW state stay DTensors on the card; the sender pulls one
   local shard at a time over the process group, the receiver builds each
   on its own device: the DTensor branch of the sharded walk): it must end
   in the flash drill's parameters (the transport moves no bit), and the
   relaunched group's journal must hold one sharded ``heal_xfer`` receive
   of exactly the state's bytes, as phase 6's HTTP one; both heals'
   seconds (elapsed, wire, serialization) and GB/s print side by side.
16. Full-job preemption (``drill.preempt_all_drill``): the flash drill's
   groups with ``--durable-every 3 --durable-dir`` are both SIGTERMed
   after group 1's step 3 and drain with a durable snapshot (at step 4 or
   5, off the cadence, so the drain writes a snapshot of its own); the job
   relaunches against a fresh lighthouse, each group must resume from its
   drain-time snapshot, and both must end at step 8 in the flash drill's
   parameters (the batch of step k is seeded by k). Prints the drill's wall
   time and each snapshot's copy and write seconds; the snapshots
   (~1.50 GB each, up to 3 a group) are deleted after the phase.
16a. The live fleet plane (``drill.fleet_plane_drill`` on ``cuda``, the
   twin of the JAX package's ``tools/obs_fleet_smoke.py``): two port demo
   trainers (40 steps of 0.25 s) against a lighthouse with a 30 s
   heartbeat timeout, group 1's manager stalling each heartbeat 1.5 s,
   and the port's exporter serving beside them. Group 1 must be flagged a
   straggler with ``hb_jitter`` while it runs, ``python -m
   torchft_tpu_torch.obs_top --once --check`` exit 0, a live ``/metrics``
   body show the exporter up, one straggler and group 1's ``hb_jitter``
   gauge, and the exporter exit 0 on SIGINT with ``hb_jitter`` anomalies
   and every scrape seen in its journal. Planted faults: ``check_frame`` on
   the frame without group 1's ``STRAGGLER`` tag, and the gauge check on
   ``render_fleet_prometheus`` of the live fleet without group 1's
   ``hb_jitter`` flag, must both fail. Prints the seconds to the flag, its
   flags, the anomalies, the scrapes and the drill's wall.
16b. Departures (``python -m torchft_tpu_torch.drills``, the twin of the
   JAX package's ``tools/drills.py``, called as ``drills.run`` with its
   directory under ``OUT/departures``): every drill's report must pass
   ``drills.check_report`` (the JAX drill's verdicts) and its planted fault
   (``drills.planted``: a diverged group, a joiner that never healed
   mid-run, a 30 s drain stall, a resume step other than the drain step, a
   storm kill in the wrong phase, a "healing from" line in the promoted
   spare's post-kill log) be refused. At ResNet-50's published ImageNet
   widths on the int4 wire without error feedback (``DEPARTURE_RESNET``,
   phase 11's workload): ``spare-failover`` (three groups at a fixed world
   size of 2: an active group SIGKILLed, the spare promoted with no heal,
   all three bitwise equal; the spare's zeros go through kernels 7 and 8)
   and ``heal-storm`` (kills on "reconfiguring pg" and "healing from", the
   survivor never restarted). At the JAX drills' own configuration (cnn,
   int4 with error feedback where the JAX drill has it): ``drain`` (SIGTERM
   and SIGKILL legs, each survivor stall under 3.5 s), ``elastic-up`` (a
   mid-run join), ``elastic-down`` (3->2), ``preempt-all --via operator``
   (one ``drain_all``; the relaunch resumes from the drain-time snapshots)
   and ``soak`` (2 kills); and ``model-heal --model ulysses`` (int4,
   pg-sharded heal; moe and pipeline run on the same wire in 13 and 14).
   ``DEPARTURES`` lists each drill's steps and cuts. In two lanes:
   elastic-down, preempt-all, soak and elastic-up; then drain, model-heal
   and the ResNet-50 drills, each of those once the card's memory in use
   is at most ``DEPARTURE_CARD_GIB`` (``wait_for_card_memory``, at most
   ``DEPARTURE_WAIT_S``). Kernels 7 and 8 must launch in every group of the
   device-wire drills, and their launches join rows 7-8 of the kernels
   line. Prints each drill's wall, restarts, heal receives' bytes, each
   group's kernel 7 / 8 launches and the card's memory in use at most
   meanwhile (the host watch's readings), again after the drills, and
   keeps them in ``OUT/departures/<drill>.json``.
17. Train step: ``make_train_step`` at llama_small's widths (B=8, S=1024,
   flash, one NCCL rank) at ``accum_steps`` 1 and 2 from the same seed's
   ``init_train_state``, each held to the mesh-free model (``grad_step`` +
   AdamW on ``torch.manual_seed(0)``'s model) doing the same arithmetic:
   accum 1 on the whole batch, accum 2 on the rows 0::2 and 1::2, their
   gradients added and halved; loss, every gradient and every updated
   parameter bit for bit (``ACCUM_LIMIT``). Two planted faults (microbatch
   1 left out, the 1/2 dropped) must each fail that check. 12 and 24
   launches of each flash kernel. Then seven warm grad steps + AdamW of the
   sharded state and of the mesh-free model, in turns, and one of each
   under torch.profiler: FSDP2's cost at one rank, split into its own host
   time, AdamW's and the device's busy time.
18. Bench: ``python -m torchft_tpu_torch.bench`` in a process of its own
   (llama_small's full widths, flash, B=8, S=1024; depth cut by
   ``BENCH_ENV``: 10 raw steps, 4 DDP steps, ``sync_every`` 32, 2
   fragments, 3 measured fires): exit 0 and one JSON line with a finite
   ``tokens_per_sec``, ``mfu_est`` and ``mfu_est_interleaved`` in (0, 1]
   against the card's peak, the
   card's name as ``device_kind``, the DiLoCo headline, a DDP leg, the
   long-context point, ``heal_bench`` and ``quorum_bench`` without
   ``error``, ``flops_counted`` within 10% of ``flops_per_step``, and
   kernels 1-3, 7 and 8 launched in that process.
18a. Ledger and gate, on the host: phase 18's bench appends its round to
   ``OUT/ledger/BENCH_LEDGER_torch.jsonl`` (``TORCHFT_PERF_LEDGER``;
   removed before the bench). ``python -m torchft_tpu_torch.perf_ledger
   --ledger <it> --check`` must exit 0, every record carry the ``gpu.``
   prefix, family ``gpu`` and an ``env`` with this card's name and power
   limit, and ``gpu.ddp.ms_per_step`` be the bench's DDP ms/step; ``python
   -m torchft_tpu_torch.perf_gate --pin --check`` into
   ``OUT/ledger/PERF_BASELINES_torch.json`` must exit 0 at the head.
   Planted regression: a ``gpu.ddp.ms_per_step`` record at twice the
   head's value, after which ``perf_gate --check`` must exit 1 naming it.
   Prints the records' count and metrics, the gate's summary and the card.
19. Orchestration over the native engine: the flash drill's groups
   rendered by ``orchestration.render_topology`` with ``TORCHFT_PG=native``
   (the C++ engine of ``torchft_tpu/_cpp/collectives.cc`` carries their
   replica-axis allreduce) and kept alive by
   ``orchestration.ReplicaGroupRunner`` (``drill.runner_kill_heal_drill``).
   After group 1's step 3 its manager is killed through the lighthouse
   (``kill_via_lighthouse``); the manager server is a process of its own,
   so the trainer outlives it, and the runner SIGKILLs the trainer after a
   2 s grace (the line says which ended it). The runner must relaunch
   group 1 once (restarts ``{0: 0, 1: 1}``), its journal must hold one
   ``proc_death`` (group 1's), and both groups must end at step 8 in
   ``MESH_FREE_FLASH_SHA`` (the engine's fp32 ring gives the socket
   ring's bits) with every flash kernel launched in both; the groups'
   journals must hold ``pg_collective`` allreduce rows of backend
   ``torchft-native`` only, and ``drill.kill_episode`` must find the kill
   one recovery episode (``telemetry.detect_episodes``), group 1 its
   primary, its phases tiling its time to recover. Prints the wall time,
   the seconds from kill to relaunch, the restart log's path, the time to
   recover and its phases, and each group's median step and allreduce
   beside phase 6's (the socket ring, run beside two other drills, while
   phase 19 runs alone). Both groups also run with
   ``drill.FAULT_PLANES_ENV``: four stripes a peer link
   (``TORCHFT_LINKS=*=local,streams=4``, no int8 wire), a seeded
   ``TORCHFT_CHAOS`` reset of every stripe-1 leg in step 7 (after the
   heal), and a digest at every gate. ``drill.fault_planes`` must find a
   ``stripe_failover`` handoff journaled by both groups in a step both
   committed, each group's goodput ledger (``goodput_window`` events,
   ``telemetry.audit_goodput``) tiling its accounted wall within 1e-6 s
   with every kind in ``BADPUT_KINDS`` and group 1 with two incarnations
   and ``down`` and ``heal`` above 0, and a digest of each group with a
   step rate above 0 in the lighthouse's fleet view (read during the
   drill). Before the drill, a planted fault (every stripe of a 4 MiB
   allreduce of two engine ranks of this process reset) must abort and
   latch and be refused by the failover check. The port's exporter serves
   beside the drill (``exporter``): it must exit 0 on SIGINT after at
   least 10 scrapes, its journaled quorum id never fall, and its last
   sample count a leave and a join (the kill, the relaunch's fresh id);
   ``obs_top --once --check`` must exit 0 with a row for each group whose
   ``BWmin`` is a number; the live ``/metrics`` must show the exporter up,
   two replicas and each group's step rate; and ``obs_export --once
   --journal`` over the groups' journal must print each group's per-peer
   GiB/s in both directions, equal to the last ``native_counters`` event's
   bytes over busy seconds divided by its four streams. Planted fault:
   ``check_frame`` on the frame without group 1's row must report it.
   Each group's digest step rate at the lighthouse and each replica's
   ``/metrics`` step rate must lie within 0.5x-2x of the committed steps
   over the gate-to-gate seconds of the gates it covers, read off that
   incarnation's journal (``digest_rate_reading``); planted fault: the
   reference formula's value for each group's first window (one gate,
   pushed 0.38 ms after it) must fall outside that band.
   Prints one line each and the phase's wall.
19a. Journal reports, no drill of its own: ``python -m
   torchft_tpu_torch.perf_report <journal> --check --json --emit ...`` and
   ``python -m torchft_tpu_torch.recovery_report <journal> --check
   --min-episodes 1 --json``, each a process of its own, over the journals
   of phase 6 (the socket ring under ``TORCHFT_PERF=1``), phase 15 and
   phase 19 (the engine). Every call must exit 0 with its ``check OK``
   line and each report's ``exposed_allreduce_frac`` lie in (0, 1]; phase
   6's report must give an mfu in (0, 1) from a ``perf_model`` of this
   card, phase 19's lane rows from the engine's flight records, and phase
   19's recovery report ``drill.kill_episode``'s episode (same id, root
   cause and time to recover, the same five phase seconds for group 1)
   with a goodput attribution from the ledger. Planted faults:
   ``--expect-exposed-allreduce`` at phase 6's share (``--tol 0.02``) must
   exit 0 and at a share 0.5 away, folded back into [0, 1], exit 1;
   ``--min-episodes`` one above phase 19's episodes must exit 1. Prints
   each drill's run-level quorum, heal, compute, exposed-allreduce and
   commit seconds, ``exposed_allreduce_frac`` and ``overlap_frac``, each
   group's dominant phase and steady steps' fingerprints, phase 6's
   whole-step mfu beside phase 18's bare-step ``mfu_est``, phase 19's
   per-(peer, stripe, dir) sole-runner seconds, each drill's episodes
   with their phases, and the phase's wall. Over the same journals it also
   runs ``obs_report --json`` (each), ``goodput_report --check --json``
   (each journal with ``goodput_window`` events), ``detect_report --check
   --json --min-injections 1`` (phase 19: the engine journals each seeded
   stripe reset as a ``chaos_inject``) and ``obs_trace --check -o
   OUT/reports/<name>.trace.json`` (each). Each obs_report's comm
   attribution must be its perf_report's (the same rows, ``overlap_frac``
   to 4 places); phase 6's largest quorum wait must be group 0's at the
   kill's step, the default stall detector (95th percentile, 0.5 s) must
   flag that step or have it as its threshold, and ``--stall-pct 50`` must
   flag it; phase 19's must name a bounding lane for both groups. Phase
   19's goodput accounts must be ``drill.fault_planes``' (group 1 with two
   incarnations and ``down`` above 0, a ``process_loss`` fault cost).
   Each trace must validate, and phase 19's must have ``native engine``
   spans and a ``recovery`` track for ``drill.kill_episode``'s episode.
   Planted faults: ``--stall-min-s`` above the largest wait flags nothing;
   ``--min-windows`` and ``--min-injections`` one above the counts found
   exit 1; the port's ``validate_trace`` refuses a copy of a trace with one
   span's ``dur`` removed, and ``obs_trace --check`` over a journal of one
   engine record without an ``op`` exits 2. These print each drill's
   slowest replica and dominant phase per step, its stalls with their
   threshold, each replica's bounding lane and GiB/s, the goodput rollup,
   the ledger's goodput, retention and fault cost by kind, the injections
   with their phases and each trace's event and span counts. Then phase
   19's bandwidth three ways: each group's ``obs_top`` ``BWmin``, the
   exporter's per-peer GiB/s and the bounding lane, with their
   normalisations.
20. Baby group: two Managers in threads of this process against an
   in-process lighthouse, each over ``ProcessGroupBabySocket``, on buffers
   of llama_small's parameter shapes on the card (a seed a replica): the
   fp32 allreduce must commit and equal the same allreduce through
   ``ProcessGroupSocket`` bit for bit; the int8 one must equal the host
   quantizer's int8 average bit for bit and launch the quantize and
   dequantize kernels for both replicas; a child wedged with
   ``_inject_stall`` fails its step at the wait's deadline, the next
   quorum respawns it (a new ``child_pid``) and the next allreduce commits
   the fp32 bytes. Then a third pair over ``ProcessGroupNative``: its fp32
   allreduce must equal the socket group's bytes, and a planted fault
   (replica 1's input changed after the socket reference) must fail that
   check; and a fourth pair over the engine's int8 wire: both replicas
   decode the same bytes, within 0.1 of the fp32 mean, under half the
   fp32 engine's wire bytes. Prints each allreduce's seconds with every
   group, the spawn and respawn seconds and ``df /dev/shm``, and every
   ``hb_lapse`` record of its lighthouses beside the host watch's reading
   at that moment (``hb_lapses``).
20a. The Manager's fault scenarios on the card's tensors
   (``manager_scenarios_phase``): Managers in threads of this process
   over ``ProcessGroupSocket``, each replica's state on the card at
   llama_small's parameter shapes, gradients seeded by (replica, step) on
   the card, SGD there. Crash and HTTP heal (both end equal, the heal
   delivers exactly the parameters' bytes, a planted element fails the
   equality); three replicas with an upscale and a crash; an operator
   drain (``request_drain``, ``drain_requested``, then ``drain_all``); the
   lighthouse process SIGKILLed mid-run and restarted at the same address
   (the round without it fails to commit, no trainer raises, commits
   resume, states equal); the int4 device-quantized allreduce of three
   replicas on one odd-length leaf (kernels 7-8 once per transfer chunk
   per replica, the host quantizer's int4 average bit for bit, an int8
   reference differs). One line with each scenario's wall, commits, failed
   commits and heal bytes; its wall must stay under ``SCENARIO_BUDGET_S``.

The host watch (``HostWatch``) runs over ``drill_phases``: every 100 ms it
records how late its own sleep woke, with the phases then running, and
reads the host's load, pressure (where ``/proc/pressure`` exists) and
memory, this process's CPU and memory and the card's memory once a
second; it prints its five latest wake-ups before the kernels line
(``host_watch.json``).
21. Tensor, expert, sequence and pipeline parallelism: two ranks on the
   card in a ``cpu:gloo,cuda:gloo`` world (NCCL refuses two ranks on one
   device; ``init_group`` returns at once for it), each first checking the
   sums of ``all_reduce``, ``all_gather_into_tensor`` and
   ``reduce_scatter_tensor`` on the card's tensors: llama_small at its
   full width at ``make_mesh(tp=2)`` (6 q / 2 kv heads a rank, flash,
   B=8, S=1024), llama_moe_debug at ``make_mesh(ep=2)`` (B=8, S=64),
   llama_small at ``make_mesh(sp=2)`` (B=8, S=1024: 512 tokens a rank)
   with the default flash attention (k and v gathered, kernels 4-6),
   ring (kernels 4-6) and Ulysses (kernels 1-3 on 6 q / 2 kv heads a
   rank), and llama_small at ``make_mesh(pp=2)`` (6 layers a stage, 2
   microbatches, flash), each in fp32 and bf16: ``init_train_state`` and
   two steps (``make_train_step``; the pipeline's grad step and AdamW),
   held on rank 0 to the same two steps on one rank (the mesh-free model;
   the pipeline's one-rank schedule): fp32 to the CPU bars (``TP_FP32``),
   bf16 to bars set from readings (``TP_BF16``), the pipeline bit for bit
   (``PP_BARS``), every parameter after the first AdamW step to
   ``adamw_excess``'s bound; each family's planted fault
   (``PLANTED_FAULTS``: wo's tp shards swapped, RoPE offset 0 on rank 1,
   a ring hop that skips a block, a stage that drops its microbatch) must
   fail the case's bars (the tp fault both); the MoE router's gradient
   nonzero;
   each case's kernels launched in both ranks (phases 2 and 3 hold them to
   their plain versions at these shapes); both ranks must exit 0. Beside
   them a throwaway pair of processes, in a world of its own, asks gloo
   once for ``all_to_all_single`` and ``send``/``recv`` of the card's
   tensors, and the answers print (the port calls ``all_to_all_single`` as
   it is and stages point-to-point through the host where gloo carries
   the card's tensors, chosen by the group's backend, never by the answer;
   the send aborts its process, which is why the cases' ranks never make
   it). Beside both, a world of eight such ranks runs llama_moe_debug at
   the JAX trainer's MoE mesh for eight devices, fsdp 2 x ep 2 x tp 2
   (``MOE_EP_TP_MESH``: the experts over ep, each expert's FFN over tp
   and fsdp, the attention over tp; B=8, S=64), two steps in fp32 and
   bf16 against one rank's, to ``TP_FP32`` / ``TP_BF16`` and
   ``adamw_excess``; its planted fault (each rank takes its first expert
   from its tp rank, not its ep rank) must fail both bars. Prints both
   worlds' walls and the phase's, under ``TP_EP_BUDGET_S``.
22. The ``{"kernels": [...]}`` line (the flash rows count the Ulysses,
   pg-sharded, preemption and orchestration drills', phase 17's, the
   bench's and phase 21's launches too, the block rows phase 21's, the
   quantize rows the DDP, MoE, GPipe drills', the bench's, the Baby
   group's, phase 20a's and phase 16b's device-wire drills'), the card line, and the last line: ``{"ok": true, "device":
   {...}}``.

Logs and details go to ``chiprun_out/chip_smoke/``. Imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT = REPO / "chiprun_out" / "chip_smoke"

# The card's published dense peaks (NVIDIA data sheet), read from
# torchft_tpu_torch/perf.py's tables once the package is importable
# (set_peaks, in main): bf16 on the tensor cores, fp32 outside them, and
# the HBM bandwidth, in FLOP/s and B/s.
PEAK_FLOPS: dict = {}
PEAK_BYTES = 0.0


def set_peaks(kind: str) -> None:
    global PEAK_BYTES
    from torchft_tpu_torch import perf

    bf16, fp32 = perf.peak_tflops(kind), perf.peak_fp32_tflops(kind)
    hbm = perf.peak_hbm_gbps(kind)
    if None in (bf16, fp32, hbm):
        fail(f"torchft_tpu_torch/perf.py has no published peak for {kind!r}")
    PEAK_FLOPS.update(bfloat16=bf16 * 1e12, float32=fp32 * 1e12)
    PEAK_BYTES = hbm * 1e9


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------

SOURCES = ("flash_attention.cu", "quantization.cu")


def build_kernels() -> None:
    """Builds the CUDA sources and, beside them, the C++ control plane that
    every drill's lighthouse and manager servers run (otherwise built by
    the first drill, alone)."""
    from concurrent.futures import ThreadPoolExecutor

    from torchft_tpu_torch.coordination import _ensure_built
    from torchft_tpu_torch.ops import _cuda_build

    def build(source: str) -> float:
        t0 = time.monotonic()
        _cuda_build.build(source)
        return time.monotonic() - t0

    def build_native() -> float:
        t0 = time.monotonic()
        _ensure_built()
        return time.monotonic() - t0

    with ThreadPoolExecutor(len(SOURCES) + 1) as pool:
        native = pool.submit(build_native)
        seconds = list(pool.map(build, SOURCES))
        print(f"build: C++ control plane {native.result():.1f}s", flush=True)
    for source, secs in zip(SOURCES, seconds):
        ptxas = _cuda_build.BUILD_DIR / f"{Path(source).stem}.ptxas.txt"
        if ptxas.exists():
            (OUT / ptxas.name).write_text(ptxas.read_text())
        print(f"build: {source} {secs:.1f}s", flush=True)


# ---------------------------------------------------------------------------
# Phase 1a: the engine library's C++ runtime
# ---------------------------------------------------------------------------

# A fresh process that loads the engine from ``sys.argv[2]`` (a build
# directory holding a static-runtime library), then runs one two-rank
# allreduce and one flight-recorder snapshot on it.
ENGINE_LOAD_CHECK = r"""
import json, sys, threading, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import numpy as np
from torchft_tpu_torch import _native, coordination
from torchft_tpu_torch.process_group import ProcessGroupNative, ReduceOp
from torchft_tpu_torch.store import TCPStoreServer

coordination._BIN_DIR = Path(sys.argv[2])
coordination._BUILT_THIS_PROCESS = True
lib = coordination._BIN_DIR / coordination.ENGINE_LIBRARY
before = _native.needed_libraries(lib)
t0 = time.monotonic()
_native._load()
load_s = time.monotonic() - t0
after = _native.needed_libraries(lib)
store = TCPStoreServer()
groups = [ProcessGroupNative(timeout=60.0) for _ in range(2)]
arrs = [np.full(1 << 20, r + 1.0, np.float32) for r in range(2)]
def run(r):
    groups[r].configure(f"{store.address()}/runtime", r, 2)
    groups[r].allreduce(arrs[r], ReduceOp.SUM).wait(timeout=60)
threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
[t.start() for t in threads]
[t.join(120) for t in threads]
ok = all(bool((a == 3.0).all()) for a in arrs)
ops = [r["op"] for r in groups[0]._engine.fr_snapshot(0)["records"]]
for g in groups:
    g.shutdown()
store.shutdown()
print(json.dumps({"before": before, "after": after, "load_s": load_s,
                  "allreduce_ok": ok, "fr_ops": ops}))
"""


def plant_static_runtime_engine(bin_dir: Path) -> tuple:
    """Builds ``libtftcollectives.so`` into ``bin_dir`` with the Makefile's
    flags and ``-static-libstdc++``: by Python's compiler, or else by the
    image's ``CXX``. Returns (compiler, seconds)."""
    import shlex
    import shutil
    import sysconfig

    from torchft_tpu_torch import _native, coordination

    flags = next(
        line.split("=", 1)[1].strip()
        for line in (coordination._CPP_DIR / "Makefile").read_text().splitlines()
        if line.startswith("CXXFLAGS ?=")
    )
    lib = bin_dir / coordination.ENGINE_LIBRARY
    tried = []
    for cxx in (sysconfig.get_config_var("CXX"), os.environ.get("CXX")):
        if not cxx or shutil.which(shlex.split(cxx)[0]) is None:
            continue
        shutil.rmtree(bin_dir, ignore_errors=True)
        t0 = time.monotonic()
        proc = subprocess.run(
            ["make", "-j8", f"CXX={cxx}", f"BIN={bin_dir}",
             f"CXXFLAGS={flags} -static-libstdc++", str(lib)],
            cwd=coordination._CPP_DIR, capture_output=True, text=True, timeout=300,
        )
        if proc.returncode == 0 and "libstdc++.so.6" not in _native.needed_libraries(lib):
            return cxx, time.monotonic() - t0
        tried.append(f"{cxx}: rc {proc.returncode} {proc.stderr[-400:]}")
    raise AssertionError("phase 1a: no compiler here links the C++ runtime "
                         f"statically: {tried}")


def engine_runtime_phase() -> dict:
    """Phase 1a (module docstring). Returns the fresh process's report."""
    import shutil

    bin_dir = OUT / "static_runtime_bin"
    cxx, plant_s = plant_static_runtime_engine(bin_dir)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-c", ENGINE_LOAD_CHECK, str(REPO), str(bin_dir)],
        capture_output=True, text=True, timeout=400,
    )
    wall = time.monotonic() - t0
    (OUT / "engine_runtime.log").write_text(proc.stdout + proc.stderr)
    shutil.rmtree(bin_dir, ignore_errors=True)  # ~20 MB of objects
    if proc.returncode != 0:
        raise AssertionError(f"phase 1a: the loading process exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if ("libstdc++.so.6" in out["before"] or "libstdc++.so.6" not in out["after"]
            or not out["allreduce_ok"] or "allreduce" not in out["fr_ops"]):
        raise AssertionError(f"phase 1a: {out}")
    print(f"engine runtime: planted by {cxx} in {plant_s:.1f}s, DT_NEEDED before "
          f"{out['before']} after {out['after']}, _load (rebuild) {out['load_s']:.1f}s, "
          f"allreduce ok, fr_snapshot ops {out['fr_ops']}, process wall {wall:.1f}s",
          flush=True)
    return out


# The bf16 bodies that must run on the tensor cores, built at every head_dim.
TENSOR_CORE_KERNELS = (
    "flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
    "flash_bwd_dkv_wgmma_kernel",
)
HEAD_DIMS = (16, 32, 64, 128)


def ptxas_report(text: str) -> dict:
    """{mangled name: {registers, stack, spill_stores, spill_loads}} from
    ``nvcc -Xptxas -v`` output, and ptxas' warnings and performance notices
    (a wgmma it had to serialize)."""
    import re

    report, warnings, name = {}, [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            report[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            report[name].update(stack=int(m[1]), spill_stores=int(m[2]),
                                spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name]["registers"] = int(m[1])
        if "warning" in line.lower() or "Performance Loss" in line:
            warnings.append(line.strip())
    return {"functions": report, "warnings": warnings}


def sass_opcodes(source: str, name: str = "") -> dict:
    """{mangled kernel name: {opcode: count}} from ``cuobjdump -sass`` of
    the built library of ``source``, for the kernels whose name holds
    ``name``. Opcodes are counted without modifiers: ``I2F.S8`` counts as
    ``I2F``."""
    import re

    from torchft_tpu_torch.ops import _cuda_build

    lib = _cuda_build.library_path(source)
    cuobjdump = Path(_cuda_build._nvcc()).parent / "cuobjdump"
    proc = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"cuobjdump -sass failed: {proc.stderr[-2000:]}")
    # An instruction: its address comment, an optional predicate, then the
    # opcode, whose modifiers follow after dots.
    op_re = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[0-9T]+\s+)?([A-Z][A-Z0-9_]*)")
    counts, current = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = counts.setdefault(m[1], {}) if name in m[1] else None
            continue
        m = op_re.match(line)
        if m and current is not None:
            current[m[1]] = current.get(m[1], 0) + 1
    return counts


# Conversion and rounding instructions the reduce kernel must not hold: its
# decode, requantize and cast run on the fp32 and integer pipes.
REDUCE_BANNED_OPS = ("I2F", "I2FP", "F2I", "F2IP", "FRND")
# The opcodes printed for each reduce instantiation (all land in the JSON).
REDUCE_SHOWN_OPS = (
    "I2F", "I2FP", "F2I", "F2IP", "FRND", "MUFU", "FCHK", "CALL", "FADD",
    "FMUL", "FFMA", "FMNMX", "PRMT", "LDG", "STG",
)


def sass_check() -> dict:
    """``cuobjdump -sass`` of the built libraries: raises unless the bf16
    forward, dq and dk/dv bodies of the flash library hold HGMMA (wgmma)
    instructions at every head_dim, and unless no instantiation of the
    reduce kernel (``reduce_rows_int8_kernel<R>``) holds a conversion or
    rounding instruction (``REDUCE_BANNED_OPS``) or spills. Writes each
    flash instantiation's HGMMA and HMMA counts and each reduce
    instantiation's opcode counts, with ptxas' registers, stack and spill
    bytes, to ``sass_check.json`` and prints them."""
    import re

    from torchft_tpu_torch.ops import _cuda_build

    def ptxas(source: str) -> dict:
        stem = Path(source).stem
        return ptxas_report(
            (_cuda_build.BUILD_DIR / f"{stem}.ptxas.txt").read_text()
        )

    flash_ptxas = ptxas("flash_attention.cu")
    table = {}
    for mangled, ops in sass_opcodes("flash_attention.cu").items():
        m = re.search(r"(flash_[a-z_]+_kernel)ILi(\d+)EE", mangled)
        if not m:
            continue
        # The tensor-core bodies take bf16 only, the FMA bodies fp32 only.
        dtype = "bf16" if "_wgmma_" in m[1] else "fp32"
        table[f"{m[1]}<{dtype}, D={m[2]}>"] = {
            "HGMMA": ops.get("HGMMA", 0), "HMMA": ops.get("HMMA", 0),
            **flash_ptxas["functions"].get(mangled, {}),
        }
    missing = [
        f"{k}<bf16, D={d}>" for k in TENSOR_CORE_KERNELS for d in HEAD_DIMS
        if table.get(f"{k}<bf16, D={d}>", {}).get("HGMMA", 0) <= 0
    ]

    quant_ptxas = ptxas("quantization.cu")
    reduce = {}
    for mangled, ops in sass_opcodes(
        "quantization.cu", "reduce_rows_int8_kernel"
    ).items():
        m = re.search(r"reduce_rows_int8_kernelILi(\d+)EE", mangled)
        ranks = m[1] if m and m[1] != "0" else "run time"
        reduce[f"reduce_rows_int8_kernel<R={ranks}>"] = {
            "ops": dict(sorted(ops.items())),
            **quant_ptxas["functions"].get(mangled, {}),
        }
    bad_reduce = {}
    for key, rec in reduce.items():
        found = {op: rec["ops"][op] for op in REDUCE_BANNED_OPS if rec["ops"].get(op)}
        spilled = rec.get("spill_stores", 0) + rec.get("spill_loads", 0)
        if spilled:
            found["spill bytes"] = spilled
        if found:
            bad_reduce[key] = found

    result = {
        "kernels": table, "reduce": reduce,
        "ptxas_warnings": flash_ptxas["warnings"] + quant_ptxas["warnings"],
    }
    (OUT / "sass_check.json").write_text(json.dumps(result, indent=1))
    for key, rec in sorted(table.items()):
        print(f"sass: {key}: " + ", ".join(f"{k} {v}" for k, v in rec.items()),
              flush=True)
    for key, rec in sorted(reduce.items()):
        print(f"sass: {key}: " + ", ".join(
            f"{op} {rec['ops'].get(op, 0)}" for op in REDUCE_SHOWN_OPS
        ) + ", " + ", ".join(f"{k} {v}" for k, v in rec.items() if k != "ops"),
              flush=True)
    for w in result["ptxas_warnings"]:
        print(f"ptxas: {w}", flush=True)
    if missing:
        raise AssertionError(f"no HGMMA in the SASS of {missing}")
    if len(reduce) != 9 or bad_reduce:
        raise AssertionError(
            f"reduce kernel SASS: want 9 instantiations (R = 1..8 and run "
            f"time) free of {REDUCE_BANNED_OPS} and spills, got "
            f"{sorted(reduce)}, offending {bad_reduce}"
        )
    return result


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def causal_pairs(S: int, causal: bool) -> int:
    return S * (S + 1) // 2 if causal else S * S


def bounds(B, S, Hq, Hkv, D, dtype_name, causal, Skv=None, pairs=None,
           names=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), rows_in=2):
    """Least time (ms) and its binding resource per kernel: the larger of
    the operations this call needs over the peak rate for its dtype and
    the bytes it must move (each input read once, each output written
    once) over the HBM rate. Matrix-product flops per (q row, kv column)
    pair the mask keeps: forward QK^T + PV = 4D; dq: QK^T, dO.V^T,
    dS.K = 6D; dk/dv: QK^T, dO.V^T, P^T.dO, dS^T.Q = 8D. ``pairs``: the
    visible pairs per (batch, head) where the mask is not causal at zero
    offsets; ``rows_in``: the fp32 rows the backward reads (lse and delta;
    3 with dlse); ``names``: the forward, dq and dk/dv kernels' names."""
    e = 2 if dtype_name == "bfloat16" else 4
    Skv = S if Skv is None else Skv
    pairs = B * Hq * (causal_pairs(S, causal) if pairs is None else pairs)
    q_bytes = B * S * Hq * D * e
    kv_bytes = B * Skv * Hkv * D * e
    row_bytes = B * Hq * S * 4
    fwd, dq, dkv = names
    work = {
        fwd: (4 * D * pairs, q_bytes + 2 * kv_bytes + q_bytes + row_bytes),
        dq: (
            6 * D * pairs,
            2 * q_bytes + 2 * kv_bytes + rows_in * row_bytes + q_bytes,
        ),
        dkv: (
            8 * D * pairs,
            2 * q_bytes + 2 * kv_bytes + rows_in * row_bytes + 2 * kv_bytes,
        ),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        out[name] = (
            max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
        )
    return out


# Element-wise limit: |kernel - plain| <= tol * (|plain| + T) + 1e-5 *
# rms(plain), T the element's sum of |product terms|
# (flash_attention_term_sums; 1 for lse, a log). In bf16 the two sides
# round P or dS at different points (the kernel the online softmax's
# unnormalised P) and each rounds its output once, each rounding off by up
# to 2^-8 of its value, so they may differ by 2^-7 * (|plain| + T): tol is
# 1.28 * 2^-7. Where terms cancel, T is far larger than the element. fp32
# outputs and every lse (fp32 on both sides) differ by summation order and
# __expf only. The rms floor covers elements whose plain value and T are
# exactly 0. dq and dk add ``dp_rounding``: T holds dS's terms after
# dP - delta cancelled, not the fp32 rounding of dP before it.
TOL = {"bfloat16": 1e-2, "float32": 1e-5}
RMS_FLOOR = 1e-5
# dS = P * (dP - delta [+ dlse]) takes dP = dO.V^T, a D-term fp32 sum on
# each side, before it cancels against delta: the plain side's sum is off
# by up to D * 2^-24 of its terms' magnitudes A = |dO|.|V|^T, the tensor
# cores' by up to 2 D * 2^-24 (their fp32 accumulation need not round to
# nearest), so the two sides' dS may differ by 3 D 2^-24 P A beside
# ``TOL``'s roundings. In row 0 (key 0 alone: P = 1, dP = delta) that is
# all of dS, and there the plain value and T are rounding noise or 0.
DP_ROUNDING = 3 * 2.0**-24


def dp_rounding(q, k, v, dout, lse, causal: bool, q_off: int = 0,
                k_off: int = 0) -> dict:
    """dq's and dk's share of the fp32 rounding of dP, in their layouts:
    ``DP_ROUNDING`` * D * (P A).|K| * scale and (P A)^T.|Q| * scale, the GQA
    group summed."""
    import math

    import torch

    from torchft_tpu_torch.ops import flash_attention as fa

    Hq, Hkv, D = q.shape[2], k.shape[2], q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    qf, kf = fa._heads_first(q), fa._heads_first(k, Hq // Hkv)
    vf, dof = fa._heads_first(v, Hq // Hkv), fa._heads_first(dout)
    keep = fa._keep(q, k, causal, q_off, k_off)
    e = fa._probs(fa._scores(qf, kf, keep, scale), lse, keep)
    e *= torch.matmul(dof.abs(), vf.abs().transpose(-1, -2))
    c = DP_ROUNDING * D * scale
    return {
        "dq": (torch.matmul(e, kf.abs()) * c).permute(0, 2, 1, 3),
        "dk": fa._kv_heads(torch.matmul(e.transpose(-1, -2), qf.abs()) * c, Hkv),
    }


def compare(a, b, terms, tol: float, floor=0.0) -> dict:
    """max abs error, rms of the plain output, and the worst share of its
    allowed error (``TOL``'s, plus ``floor``) any element uses (> 1
    fails)."""
    import torch

    a, b = a.float(), b.float()
    if not torch.isfinite(a).all():
        raise AssertionError("kernel output not finite")
    diff = (a - b).abs()
    rms = float(b.square().mean().sqrt())
    allowed = tol * (b.abs() + terms) + RMS_FLOOR * rms + floor
    # An exact match is share 0, also where everything is 0 (all masked).
    share = torch.where(diff == 0, 0.0, diff / allowed)
    return {
        "max_abs_err": float(diff.max()),
        "ref_rms": rms,
        "share": float(share.max()),
    }


def check_case(B, S, Hq, Hkv, D, dtype, causal, timed: bool, seed: int):
    """Runs the three kernels and their plain versions on one input set;
    returns {kernel: record}. Raises where any element of any output lies
    outside its limit (``TOL``; lse always at the fp32 one)."""
    import torch
    import torch.nn.functional as F

    from torchft_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *shape: torch.randn(  # noqa: E731
        *shape, generator=g, device=dev, dtype=torch.float32
    ).to(dtype)
    q, k, v = mk(B, S, Hq, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D)
    dout = mk(B, S, Hq, D)

    out, lse = fa.flash_fwd(q, k, v, causal)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, dout, lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, causal)
    torch.cuda.synchronize()
    out_r, lse_r = fa.flash_attention_fwd_reference(q, k, v, causal)
    dq_r = fa.flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal)
    dk_r, dv_r = fa.flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal)

    terms = fa.flash_attention_term_sums(q, k, v, dout, lse, delta, causal)
    dp = dp_rounding(q, k, v, dout, lse, causal)
    dtype_name = str(dtype)[6:]
    tol, tol32 = TOL[dtype_name], TOL["float32"]
    outputs = {
        "flash_fwd": {
            "out": (out, out_r, terms["out"], tol),
            "lse": (lse, lse_r, 1.0, tol32),
        },
        "flash_bwd_dq": {"dq": (dq, dq_r, terms["dq"], tol, dp["dq"])},
        "flash_bwd_dkv": {
            "dk": (dk, dk_r, terms["dk"], tol, dp["dk"]),
            "dv": (dv, dv_r, terms["dv"], tol),
        },
    }
    case = f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} {dtype_name} causal={causal}"
    records = {}
    readings = []
    for name, outs in outputs.items():
        got = {o: compare(*args) for o, args in outs.items()}
        for o, r in got.items():
            readings.append(
                f"{o} err {r['max_abs_err']:.3g} rms {r['ref_rms']:.3g} "
                f"share {r['share']:.3g}"
            )
            if not r["share"] <= 1.0:
                raise AssertionError(
                    f"{name} disagrees with its plain version at {case}: "
                    f"{o} |kernel - plain| reaches {r['share']:.3g}x of "
                    f"{outs[o][3]} * (|plain| + T) + {RMS_FLOOR} * rms(plain)"
                    + (" + dp_rounding" if len(outs[o]) > 4 else "")
                    + f" (max abs err {r['max_abs_err']}, rms {r['ref_rms']})"
                )
        records[name] = {
            "max_abs_err": max(r["max_abs_err"] for r in got.values()),
            "tol_share": max(r["share"] for r in got.values()),
        }
    print(f"kernels ok at {case}: " + ", ".join(readings), flush=True)
    if not timed:
        return records

    iters = 20
    plain_iters = 3
    records["flash_fwd"]["ms"] = time_ms(lambda: fa.flash_fwd(q, k, v, causal), iters)
    records["flash_bwd_dq"]["ms"] = time_ms(
        lambda: fa.flash_bwd_dq(q, k, v, dout, lse, delta, causal), iters
    )
    records["flash_bwd_dkv"]["ms"] = time_ms(
        lambda: fa.flash_bwd_dkv(q, k, v, dout, lse, delta, causal), iters
    )
    records["flash_fwd"]["plain_ms"] = time_ms(
        lambda: fa.flash_attention_fwd_reference(q, k, v, causal), plain_iters, 1
    )
    records["flash_bwd_dq"]["plain_ms"] = time_ms(
        lambda: fa.flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal),
        plain_iters, 1,
    )
    records["flash_bwd_dkv"]["plain_ms"] = time_ms(
        lambda: fa.flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal),
        plain_iters, 1,
    )
    # Yardstick only: PyTorch's fused attention on the same inputs
    # ([B,H,S,D] copies made outside the timing). Forward for the forward
    # kernel; its backward (dq, dk and dv in one call) for both backward
    # kernels.
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    dot = dout.transpose(1, 2).contiguous()
    sdpa = lambda a, b, c: F.scaled_dot_product_attention(  # noqa: E731
        a, b, c, is_causal=causal, enable_gqa=True
    )
    records["flash_fwd"]["library_ms"] = time_ms(lambda: sdpa(qt, kt, vt), iters)
    records["flash_fwd"]["library_call"] = "F.scaled_dot_product_attention forward"
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    o = sdpa(qg, kg, vg)
    bwd_ms = time_ms(
        lambda: torch.autograd.grad(o, (qg, kg, vg), dot, retain_graph=True),
        iters,
    )
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        records[name]["library_ms"] = bwd_ms
        records[name]["library_call"] = (
            "F.scaled_dot_product_attention backward (dq, dk, dv together)"
        )
    for name, (b_ms, b_by) in bounds(
        B, S, Hq, Hkv, D, str(dtype)[6:], causal
    ).items():
        records[name]["bound_ms"] = b_ms
        records[name]["bound_by"] = b_by
    return records


def model_check() -> None:
    """The model with flash attention against the same weights with dense
    attention, on the card, at llama_small's widths cut to 2 layers."""
    import dataclasses

    import torch

    from torchft_tpu_torch.models import Transformer, llama_small

    dev = torch.device("cuda")
    cfg = llama_small(num_layers=2, remat=False)
    torch.manual_seed(0)
    dense = Transformer(cfg).to(dev)
    flash = Transformer(
        dataclasses.replace(cfg, attn_impl="flash", flash_min_seq=1024)
    ).to(dev)
    flash.load_state_dict(dense.state_dict())
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 1024), generator=g, device=dev)
    with torch.no_grad():
        a, b = dense(tokens), flash(tokens)
    if a.shape != (2, 1024, cfg.vocab_size) or not torch.isfinite(b).all():
        raise AssertionError(f"flash model logits bad: {b.shape}")
    err = float((a - b).abs().max())
    scale = float(a.abs().max())
    # bf16 activations: the two attention paths round at different places.
    if not err <= 5e-2 * scale:
        raise AssertionError(
            f"flash model logits differ from dense: {err} vs max {scale}"
        )
    print(f"model ok: flash vs dense logits max abs err {err:.3g} "
          f"(max |logit| {scale:.3g})", flush=True)


def kernel_phase() -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, fp32 = torch.bfloat16, torch.float32
    # The training path's shape, timed.
    main = check_case(8, 1024, 12, 4, 64, bf16, True, timed=True, seed=0)
    # Further shapes: the path's head_dim in fp32, fp32 at D=128,
    # non-causal, a ragged length, D=16/32.
    check_case(2, 1024, 12, 4, 64, fp32, True, timed=False, seed=5)
    check_case(2, 1024, 8, 2, 128, fp32, True, timed=False, seed=1)
    check_case(2, 512, 4, 4, 64, bf16, False, timed=False, seed=2)
    check_case(1, 200, 4, 2, 32, fp32, True, timed=False, seed=3)
    check_case(2, 128, 4, 2, 16, bf16, True, timed=False, seed=4)
    # Phase 21's shape: a rank's 6 q / 2 kv heads of llama_small at tp 2,
    # in both of its dtypes.
    check_case(8, 1024, 6, 2, 64, bf16, True, timed=False, seed=6)
    check_case(8, 1024, 6, 2, 64, fp32, True, timed=False, seed=7)
    model_check()
    return main


# ---------------------------------------------------------------------------
# Phase 3: the block kernels and the ring
# ---------------------------------------------------------------------------

BLOCK_KERNELS = ("flash_block_fwd", "flash_block_bwd_dq", "flash_block_bwd_dkv")
BLOCK_OFFSETS = ((0, 0), (1024, 0), (1024, 512), (0, 1024))


def check_block_case(B, Sq, Skv, Hq, Hkv, D, dtype, q_off, k_off, timed: bool,
                     seed: int, device: str = "cuda"):
    """The three block kernels against their plain versions on one input
    set, with a random lse cotangent; returns {kernel: record}. Every
    element of dq, dk, dv and lse is held to ``TOL``; out on the rows that
    see at least one key (a row that sees none is out 0 and lse <= -1e29;
    where no row sees a key, every gradient is 0)."""
    import torch
    import torch.nn.functional as F

    from torchft_tpu_torch.ops import flash_attention as fa

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *shape: torch.randn(  # noqa: E731
        *shape, generator=g, device=dev, dtype=torch.float32
    ).to(dtype)
    q, k, v = mk(B, Sq, Hq, D), mk(B, Skv, Hkv, D), mk(B, Skv, Hkv, D)
    dout = mk(B, Sq, Hq, D)
    dlse = torch.randn(B, Hq, Sq, generator=g, device=dev)
    offs = (q_off, k_off)

    out, lse = fa.flash_block_fwd(q, k, v, *offs)
    delta = fa._delta(dout, out)
    args = (q, k, v, dout, lse, delta, dlse, *offs)
    dq = fa.flash_block_bwd_dq(*args)
    dk, dv = fa.flash_block_bwd_dkv(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out_r, lse_r = fa.flash_block_fwd_reference(q, k, v, *offs)
    dq_r = fa.flash_block_bwd_dq_reference(*args)
    dk_r, dv_r = fa.flash_block_bwd_dkv_reference(*args)
    terms = fa.flash_attention_term_sums(
        q, k, v, dout, lse, delta, True, q_off, k_off, dlse
    )
    dp = dp_rounding(q, k, v, dout, lse, True, q_off, k_off)
    # Rows that see at least one key see key 0.
    seen = torch.arange(Sq, device=dev) + q_off >= k_off
    case = (f"B={B} Sq={Sq} Skv={Skv} Hq={Hq} Hkv={Hkv} D={D} "
            f"{str(dtype)[6:]} offsets {offs}")
    blind = ~seen
    if blind.any():
        if out[:, blind].abs().max() != 0 or not (
            torch.isfinite(lse[..., blind]).all()
            and (lse[..., blind] <= -1e29).all()
        ):
            raise AssertionError(f"rows that see no key are not out 0, lse <= -1e29 at {case}")
    if not seen.any() and any(x.abs().max() != 0 for x in (dq, dk, dv)):
        raise AssertionError(f"gradients not 0 where every key is masked at {case}")
    tol, tol32 = TOL[str(dtype)[6:]], TOL["float32"]
    outputs = {
        "flash_block_fwd": {
            "out": (out[:, seen], out_r[:, seen], terms["out"][:, seen], tol),
            "lse": (lse, lse_r, 1.0, tol32),
        },
        "flash_block_bwd_dq": {"dq": (dq, dq_r, terms["dq"], tol, dp["dq"])},
        "flash_block_bwd_dkv": {
            "dk": (dk, dk_r, terms["dk"], tol, dp["dk"]),
            "dv": (dv, dv_r, terms["dv"], tol),
        },
    }
    records, readings = {}, []
    for name, outs in outputs.items():
        got = {o: compare(*a) for o, a in outs.items() if a[0].numel()}
        for o, r in got.items():
            readings.append(f"{o} err {r['max_abs_err']:.3g} share {r['share']:.3g}")
            if not r["share"] <= 1.0:
                raise AssertionError(
                    f"{name} disagrees with its plain version at {case}: {o} "
                    f"reaches {r['share']:.3g}x of its limit (max abs err "
                    f"{r['max_abs_err']}, rms {r['ref_rms']})"
                )
        records[name] = {
            "max_abs_err": max(r["max_abs_err"] for r in got.values()),
            "tol_share": max(r["share"] for r in got.values()),
        }
    print(f"block kernels ok at {case}: " + ", ".join(readings), flush=True)
    if not timed:
        return records

    iters, plain_iters = 20, 3
    for name, kernel, plain in (
        ("flash_block_fwd", lambda: fa.flash_block_fwd(q, k, v, *offs),
         lambda: fa.flash_block_fwd_reference(q, k, v, *offs)),
        ("flash_block_bwd_dq", lambda: fa.flash_block_bwd_dq(*args),
         lambda: fa.flash_block_bwd_dq_reference(*args)),
        ("flash_block_bwd_dkv", lambda: fa.flash_block_bwd_dkv(*args),
         lambda: fa.flash_block_bwd_dkv_reference(*args)),
    ):
        records[name]["ms"] = time_ms(kernel, iters)
        records[name]["plain_ms"] = time_ms(plain, plain_iters, 1)
    # Yardstick for out only: SDPA has no lse cotangent, so no backward
    # call computes the block kernels' gradients. At (0,0) the block is
    # causal, at (1024,0) every key is visible.
    causal = q_off < k_off + Skv - 1
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    records["flash_block_fwd"]["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True
        ), iters,
    )
    records["flash_block_fwd"]["library_call"] = (
        f"F.scaled_dot_product_attention forward, is_causal={causal}"
    )
    for name in BLOCK_KERNELS[1:]:
        records[name]["library_ms"] = None
        records[name]["library_call"] = (
            "none: no PyTorch call takes the lse cotangent"
        )
    visible = int(fa._keep(q, k, True, q_off, k_off).sum())
    for name, (b_ms, b_by) in bounds(
        B, Sq, Hq, Hkv, D, str(dtype)[6:], True, Skv=Skv, pairs=visible,
        names=BLOCK_KERNELS, rows_in=3,
    ).items():
        records[name]["bound_ms"] = b_ms
        records[name]["bound_by"] = b_by
    print(f"timing block kernels at offsets {offs}: " + ", ".join(
        f"{n} {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, bound "
        f"{r['bound_ms']:.4f} {r['bound_by']})" for n, r in records.items()
    ) + f", SDPA fwd {records['flash_block_fwd']['library_ms']:.4f} ms", flush=True)
    return records


# Ring limit, |ring - plain| <= 1.28 * 2^-8 * (c_T * T + c_x * |plain|)
# + 1e-5 * rms(plain), element by element, against the full-sequence plain
# version in bf16. Beside the roundings that both sides make (P or dS and
# the output, each up to 2^-8 of its terms, as in ``TOL``), the ring rounds
# once more per block: each block's out is rounded to bf16 before the fp32
# merge (2^-8 of sum_b w_b |o_b| <= T), and in the backward the cotangent
# that reaches each block's out is rounded to bf16 (2^-8 of each dO term),
# and each shard's sp block gradients are summed in bf16 (sp - 1 roundings
# of up to 2^-8 of sum_b |grad_b| <= T). So out: c_T = 3, c_x = 2; dq, dk,
# dv: c_T = sp + 3, c_x = 1, with T for dq and dk taken over the terms of dS
# itself (``ring_term_sums``): the rounded cotangent enters dS through dP,
# delta and dlse before they cancel. 1.28 is ``TOL``'s slack.
RING_SLACK = 1.28


def ring_term_sums(q, k, v, dout, lse, delta, sp: int) -> dict:
    """``flash_attention_term_sums`` of the full sequence, with dq's and
    dk's |dS| replaced by P * (A + Abar): A = |dO|.|V|^T, the terms of dP,
    and Abar the P-weighted mean of A over the keys of each ring block,
    which bounds the terms of that block's delta and dlse."""
    import math

    import torch

    from torchft_tpu_torch.ops import flash_attention as fa

    Hq, Hkv = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    terms = fa.flash_attention_term_sums(q, k, v, dout, lse, delta)
    qf, kf = fa._heads_first(q), fa._heads_first(k, Hq // Hkv)
    vf, dof = fa._heads_first(v, Hq // Hkv), fa._heads_first(dout)
    keep = fa._keep(q, k, True)
    p = fa._probs(fa._scores(qf, kf, keep, scale), lse, keep)
    a = torch.matmul(dof.abs(), vf.abs().transpose(-1, -2))
    n = k.shape[1] // sp
    for b in range(sp):
        blk = slice(b * n, (b + 1) * n)
        pb = p[..., blk]
        mean = (pb * a[..., blk]).sum(-1, keepdim=True) / pb.sum(
            -1, keepdim=True
        ).clamp_min(1e-30)
        a[..., blk] += mean
    e = p * a
    terms["dq"] = (torch.matmul(e, kf.abs()) * scale).permute(0, 2, 1, 3)
    terms["dk"] = fa._kv_heads(
        torch.matmul(e.transpose(-1, -2), qf.abs()) * scale, Hkv
    )
    return terms


def check_sequence_parallel(make_attn, B, S, Hq, Hkv, D, sp, device, seed):
    """The context-parallel attention ``make_attn(mesh)`` builds
    (``make_ring_attention`` or ``make_ulysses_attention``) over an ``sp``
    mesh of ``device`` repeated, bf16: out, dq, dk and dv against the plain
    full-sequence versions, each output's reading against the ring limit,
    and the kernel launches of its forward and backward."""
    import torch

    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel import make_mesh

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *shape: torch.randn(  # noqa: E731
        *shape, generator=g, device=dev
    ).to(torch.bfloat16)
    q, k, v, dout = mk(B, S, Hq, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D), mk(B, S, Hq, D)
    attn = make_attn(make_mesh(sp=sp, devices=[dev] * sp))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    out = attn(qg, kg, vg)
    out.backward(dout)
    launches = dict(fa.LAUNCHES)
    out_r, lse_r = fa.flash_attention_fwd_reference(q, k, v)
    delta_r = fa._delta(dout, out_r)
    ref = (out_r, *fa.flash_attention_bwd_reference(q, k, v, dout, lse_r, delta_r))
    terms = ring_term_sums(q, k, v, dout, lse_r, delta_r, sp)
    outputs = {}
    for name, got, plain in zip(("out", "dq", "dk", "dv"),
                                (out.detach(), qg.grad, kg.grad, vg.grad), ref):
        c_t, c_x = (3, 2) if name == "out" else (sp + 3, 1)
        # compare()'s limit is tol * (|plain| + T'): tol carries c_x.
        outputs[name] = compare(
            got, plain, c_t * terms[name] / c_x, RING_SLACK * 2.0**-8 * c_x
        )
    return {"launches": launches, "outputs": outputs}


def block_phase() -> dict:
    import torch

    bf16, fp32 = torch.bfloat16, torch.float32
    main = {}
    for i, offs in enumerate(BLOCK_OFFSETS):
        rec = check_block_case(8, 1024, 1024, 12, 4, 64, bf16, *offs,
                               timed=offs in ((0, 0), (1024, 0)), seed=10 + i)
        if offs == (0, 0):
            main = rec
        elif offs == (1024, 0):
            (OUT / "block_timing_1024_0.json").write_text(json.dumps(rec, indent=1))
    check_block_case(2, 1024, 1024, 12, 4, 64, fp32, 1024, 512, timed=False, seed=20)
    check_block_case(1, 200, 328, 4, 2, 32, fp32, 300, 100, timed=False, seed=21)
    # Phase 21's sp 2 shards: B=8, 512 tokens a rank, the second block at
    # its offset, in both dtypes.
    for i, dtype in enumerate((bf16, fp32)):
        check_block_case(8, 512, 512, 12, 4, 64, dtype, 512, 0, timed=False, seed=25 + i)

    sp = 4
    from torchft_tpu_torch.parallel import make_ring_attention

    ring = check_sequence_parallel(
        make_ring_attention, 2, 4096, 12, 4, 64, sp, "cuda", seed=22
    )
    for name in BLOCK_KERNELS:
        if ring["launches"][name] != sp * sp:
            raise AssertionError(
                f"ring: {name} launched {ring['launches'][name]} times, "
                f"want {sp * sp}: {ring['launches']}"
            )
    for name, r in ring["outputs"].items():
        if not r["share"] <= 1.0:
            raise AssertionError(
                f"ring sp={sp} {name} reaches {r['share']:.3g}x of the ring "
                f"limit (max abs err {r['max_abs_err']}, rms {r['ref_rms']})"
            )
    print(f"ring ok: sp={sp} B=2 S=4096 bf16, launches "
          f"{ {n: ring['launches'][n] for n in BLOCK_KERNELS} }, " + ", ".join(
              f"{n} err {r['max_abs_err']:.3g} share {r['share']:.3g}"
              for n, r in ring["outputs"].items()
          ), flush=True)
    return main


def ulysses_check() -> dict:
    """Phase 12's kernel check: ``make_ulysses_attention`` at sp=4 on a mesh
    that repeats the card (B=2, S=4096, llama_small's heads: 3 q heads and
    1 kv head a rank), against the plain full-sequence versions within the
    ring limit, one launch of each flash kernel a rank."""
    sp = 4
    from torchft_tpu_torch.parallel import make_ulysses_attention

    rec = check_sequence_parallel(
        make_ulysses_attention, 2, 4096, 12, 4, 64, sp, "cuda", seed=23
    )
    for name in FLASH_KERNELS:
        if rec["launches"][name] != sp:
            raise AssertionError(
                f"ulysses: {name} launched {rec['launches'][name]} times, "
                f"want {sp}: {rec['launches']}"
            )
    for name in BLOCK_KERNELS:
        if rec["launches"][name]:
            raise AssertionError(f"ulysses: launched {name}: {rec['launches']}")
    for name, r in rec["outputs"].items():
        if not r["share"] <= 1.0:
            raise AssertionError(
                f"ulysses sp={sp} {name} reaches {r['share']:.3g}x of the ring "
                f"limit (max abs err {r['max_abs_err']}, rms {r['ref_rms']})"
            )
    print(f"ulysses ok: sp={sp} B=2 S=4096 bf16, launches "
          f"{ {n: rec['launches'][n] for n in FLASH_KERNELS} }, " + ", ".join(
              f"{n} err {r['max_abs_err']:.3g} share {r['share']:.3g}"
              for n, r in rec["outputs"].items()
          ), flush=True)
    return rec


# ---------------------------------------------------------------------------
# Phase 4: the quantize kernels against their plain versions and the wire
# ---------------------------------------------------------------------------

QMAX = {8: 127.0, 4: 7.0}
# The quantized path's bucket sizes on llama_small: embed.weight and
# lm_head.weight each fill a bucket alone (24,576,000 values: one 16M-value
# transfer chunk and a 7,798,784-value tail), a layer bucket, and a whole
# 32 MiB bucket plus a ragged tail. ResNet-50's gradients (the DDP drill)
# fill four buckets, the first of 8,361,000 values (a ragged last block)
# and the last of 1,048,576. The MoE and GPipe drills' int4 wire sends
# each model's gradients in one bucket, each with a ragged last block:
# 254,784 values (llama_moe_debug) and 180,800 (llama_debug, 4 layers).
QUANT_SIZES = {
    "embed/lm_head bucket, chunked": 24_576_000,
    "layer bucket": 7_867_392,
    "32 MiB + 333": 8_388_608 + 333,
    "ResNet-50 first bucket": 8_361_000,
    "ResNet-50 last bucket": 1_048_576,
    "MoE bucket (llama_moe_debug)": 254_784,
    "GPipe bucket (llama_debug, 4 layers)": 180_800,
}
TIMED_N = 8_388_608  # one 32 MiB fp32 bucket


def seeded_values(n: int, seed: int):
    """Normal values whose per-512-block magnitude spans 1e-8 to 1e3."""
    import numpy as np

    rng = np.random.default_rng(seed)
    blocks = -(-n // 512)
    mags = np.repeat(10.0 ** rng.uniform(-8, 3, size=blocks), 512)[:n]
    return (rng.standard_normal(n, dtype=np.float32) * mags).astype(np.float32)


def special_values(bits: int):
    """One block per case: zeros, exact half-steps (scale 2^-3), +-0,
    subnormals, an absmax whose scale underflows, the +-qmax edges, a block
    holding a NaN and one holding +-inf."""
    import numpy as np

    qmax = QMAX[bits]
    rng = np.random.default_rng(bits)
    half = (np.arange(512) % (2 * qmax) - qmax + 0.5) * 0.125
    half[0] = qmax * 0.125
    signed_zero = np.zeros(512)
    signed_zero[1::2] = -0.0
    edges = rng.uniform(-1.0, 1.0, 512) * 3.0
    edges[:4] = [3.0, -3.0, 3.0 * (1 - 2**-24), -3.0 * (1 - 2**-24)]
    nan = rng.standard_normal(512)
    nan[7] = np.nan
    inf = rng.standard_normal(512)
    inf[3], inf[9] = np.inf, -np.inf
    return np.concatenate([
        np.zeros(512), half, signed_zero, rng.standard_normal(512) * 1e-39,
        np.full(512, 1e-45), edges, nan, inf,
    ]).astype(np.float32)


def mismatches(a, b) -> int:
    """Elements whose bits differ; any NaN equals any NaN (a NaN's payload
    bits are the platform's: the card writes the canonical NaN)."""
    import numpy as np

    a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    if a.dtype.kind != "f":
        return int(np.count_nonzero(a != b))
    differ = a.view(np.uint32) != b.view(np.uint32)
    return int(np.count_nonzero(differ & ~(np.isnan(a) & np.isnan(b))))


def quantize_case(name: str, x_host, bits: int) -> float:
    """The kernels on ``x_host`` through the transfer functions the path
    calls, against their plain versions on the card and the host quantizer;
    raises unless every count is 0. Returns the largest |kernel - plain|
    over payload levels, finite scales and finite dequantized values."""
    import warnings

    import numpy as np
    import torch

    from torchft_tpu_torch import collectives as C
    from torchft_tpu_torch.ops import quantization as Q

    dev = torch.device("cuda")
    n = x_host.size
    blocks = -(-n // 512)
    x = torch.from_numpy(x_host).to(dev)
    q_k, s_k, n_k = Q.quantize_for_transfer(x, bits)
    padded = torch.zeros(blocks * 512, device=dev)
    padded[:n] = x
    q_p, s_p = Q.quantize_rows_reference(padded.view(blocks, 512), QMAX[bits])
    q_p_levels = q_p.cpu().numpy().reshape(-1)
    if bits == 4:
        q_p = Q._pack_nibbles(q_p)
    q_p, s_p = q_p.cpu().numpy().reshape(-1), s_p.cpu().numpy()
    with warnings.catch_warnings():  # numpy warns on non-finite blocks
        warnings.simplefilter("ignore", RuntimeWarning)
        q_h, s_h = C.quantize_blockwise(x_host, bits)
        d_h = C.dequantize_blockwise(q_h, s_h, n, bits)
    d_k = Q.dequantize_from_transfer(q_h, s_h, n, bits, dev)
    q_h_dev = torch.from_numpy(q_h).to(dev)
    if bits == 4:
        q_h_dev = Q._unpack_nibbles(q_h_dev.view(-1, 256))
    d_p = Q.dequantize_rows_reference(
        q_h_dev.view(-1, 512), torch.from_numpy(s_h).to(dev)
    ).view(-1)[:n]
    torch.cuda.synchronize()
    d_k, d_p = d_k.cpu().numpy(), d_p.cpu().numpy()
    counts = {
        "payload vs plain": mismatches(q_k, q_p),
        "scales vs plain": mismatches(s_k, s_p),
        "payload vs numpy": mismatches(q_k, q_h),
        "scales vs numpy": mismatches(s_k, s_h),
        "dequantized vs plain": mismatches(d_k, d_p),
        "dequantized vs numpy": mismatches(d_k, d_h),
    }
    if n_k != n:
        raise AssertionError(f"{name}: pulled n {n_k} != {n}")
    q_k_levels = q_k if bits == 8 else C.unpack_nibbles(q_k, blocks * 512)
    finite = np.isfinite(s_p)
    err = max(
        float(np.abs(q_k_levels.astype(np.int32) - q_p_levels).max(initial=0)),
        float(np.abs(s_k[finite] - s_p[finite]).max(initial=0.0)),
        float(np.abs(d_k - d_p)[np.isfinite(d_p)].max(initial=0.0)),
    )
    print(f"quantize ok: {name} int{bits} n={n}: "
          + ", ".join(f"{k} {v}" for k, v in counts.items()), flush=True)
    if any(counts.values()):
        raise AssertionError(f"{name} int{bits} n={n}: mismatches {counts}")
    return err


def time_cold(fn, inputs, iters: int) -> tuple:
    """(device ms, host ms) per call of fn(inputs[i % len(inputs)]): CUDA
    events around the calls, and the host's clock around issuing them. The
    fp32 inputs together exceed the 50 MB L2, so each call reads its input
    from HBM, as the path does a bucket the backward wrote earlier. Where
    the host ms reaches the device ms, the device waited for the host and
    the device ms measures the issue rate, not the kernel."""
    import torch

    for a in inputs:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def quantize_timing() -> dict:
    """Each kernel at one 32 MiB bucket (int8): launched straight through
    its C entry point on preallocated buffers (``ms``; the issue costs the
    host a few microseconds), and through its wrapper as the path calls it
    (``wrapper_ms``: output allocation, checks and the launch; int4 adds
    the torch nibble packing). Beside them the plain version and, for
    dequantize, the one PyTorch call that computes the same function."""
    import torch

    from torchft_tpu_torch.ops import quantization as Q

    dev = torch.device("cuda")
    n = TIMED_N
    blocks = n // 512
    xs = [(torch.from_numpy(seeded_values(n, 20 + i)).to(dev),) for i in range(4)]
    qs = [Q.fused_quantize(x, 8)[:2] for (x,) in xs]
    q4s = [Q.fused_quantize(x, 4)[:2] for (x,) in xs]
    lib = Q._library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    q_out = torch.empty((blocks, 512), dtype=torch.int8, device=dev)
    s_out = torch.empty(blocks, device=dev)
    d_out = torch.empty(n, device=dev)
    raw_q = [(x.data_ptr(), n, q_out.data_ptr(), s_out.data_ptr(), 127.0, stream)
             for (x,) in xs]
    raw_d = [(q.data_ptr(), s.data_ptr(), n, d_out.data_ptr(), stream)
             for q, s in qs]
    rcs = []
    iters, plain_iters = 50, 10
    quantize, dequantize = {}, {}
    for rec, key, fn, args, it in (
        (quantize, "ms", lambda *a: rcs.append(lib.tft_quantize_rows(*a)),
         raw_q, iters),
        (quantize, "wrapper_ms", lambda x: Q._quantize_rows(x, 127.0), xs, iters),
        (quantize, "int4_wrapper_ms", lambda x: Q.fused_quantize(x, 4), xs, iters),
        (quantize, "plain_ms",
         lambda x: Q.quantize_rows_reference(x.view(blocks, 512), 127.0),
         xs, plain_iters),
        (dequantize, "ms", lambda *a: rcs.append(lib.tft_dequantize_rows(*a)),
         raw_d, iters),
        (dequantize, "wrapper_ms",
         lambda q, s: Q.fused_dequantize(q, s, n, 8), qs, iters),
        (dequantize, "int4_wrapper_ms",
         lambda q, s: Q.fused_dequantize(q, s, n, 4), q4s, iters),
        (dequantize, "plain_ms", Q.dequantize_rows_reference, qs, plain_iters),
        (dequantize, "library_ms", lambda q, s: torch.mul(q, s[:, None]), qs, iters),
    ):
        rec[key], rec[key.replace("ms", "host_ms")] = time_cold(fn, args, it)
    if any(rcs):
        raise AssertionError(f"a timed launch failed: CUDA errors {set(rcs)}")
    quantize["library_ms"] = None
    quantize["library_call"] = "none: no single PyTorch call computes it"
    dequantize["library_call"] = "torch.mul(q.view(-1, 512), scales[:, None])"
    # Bytes each must move (inputs read once, outputs written once) over
    # HBM, against its fp32 operations (quantize: |x|, max, divide, rint, two
    # compares per value; dequantize: one multiply) over the fp32 rate.
    moved = 4 * n + n + 4 * blocks
    for rec, ops in ((quantize, 6 * n), (dequantize, n)):
        t_bytes = moved / PEAK_BYTES * 1e3
        t_ops = ops / PEAK_FLOPS["float32"] * 1e3
        rec["bound_ms"] = max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    for name, rec in (("quantize", quantize), ("dequantize", dequantize)):
        print(f"timing {name} n={n}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in rec.items() if isinstance(v, float)
        ) + f" ({rec['bound_by']} bound)", flush=True)
    return {"quantize": quantize, "dequantize": dequantize}


def quantize_phase() -> dict:
    err = 0.0
    seed = 0
    for bits in (8, 4):
        for name, n in QUANT_SIZES.items():
            seed += 1
            err = max(err, quantize_case(name, seeded_values(n, seed), bits))
        err = max(err, quantize_case("special values", special_values(bits), bits))
    records = quantize_timing()
    for rec in records.values():
        rec["max_abs_err"] = err
    return records


# ---------------------------------------------------------------------------
# Phase 5: the fused reduce kernel, and the kernel harness
# ---------------------------------------------------------------------------

REDUCE_RANKS = (2, 3, 4)
REDUCE_ROWS = (1, 5, 4096)
TIMED_RANKS = (2, 4)  # the drills' two groups, and the harness's four


def reduce_inputs(ranks: int, rows: int, seed: int) -> tuple:
    """Each rank's wire payload for ``rows`` rows of seeded values (the
    host quantizer's bytes): int8 q [ranks, rows, 512], fp32 scales
    [ranks, rows]."""
    import numpy as np

    from torchft_tpu_torch import collectives as C

    qs, ss = zip(*(
        C.quantize_blockwise(seeded_values(rows * 512, seed * 16 + r))
        for r in range(ranks)
    ))
    return np.stack([q.reshape(rows, 512) for q in qs]), np.stack(ss)


def reduce_special_inputs(ranks: int) -> tuple:
    """Five rows of every rank's payload: a NaN scale in rank 0 (what the
    wire carries for a block that held a NaN), a row that is zero in every
    rank (scale 1.0, as the host writes it), subnormal scales, a row at
    +-127 in every rank, and a row of seeded values."""
    import numpy as np

    q, s = reduce_inputs(ranks, 5, seed=99)
    rng = np.random.default_rng(ranks)
    s[0, 0] = np.nan
    q[:, 1], s[:, 1] = 0, 1.0
    s[:, 2] = rng.uniform(1e-41, 1e-40, ranks).astype(np.float32)
    q[:, 3] = np.where(np.arange(512) % 3 == 0, -127, 127).astype(np.int8)
    return q, s


def reduce_tie_inputs(ranks: int, rows: int, seed: int) -> tuple:
    """Tie-heavy payloads: per row one power-of-two scale shared by every
    rank, and column 0 at +127 in every rank. Every product, sum and
    average by a power of two is then exact, the requantize scale is the
    rank scale times R (1 with averaging), and each quotient is sum(q) / R
    exactly: an exact tie wherever sum(q) is odd at R = 2 (half the values)
    and 2 mod 4 at R = 4 (a quarter). The reduce's reciprocal multiply
    cannot decide a tie: a lane holding one takes the correctly rounded
    divide."""
    import numpy as np

    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, size=(ranks, rows, 512), dtype=np.int8)
    q[:, :, 0] = 127
    s = (2.0 ** rng.integers(-60, 61, size=rows)).astype(np.float32)
    return q, np.repeat(s[None], ranks, axis=0)


# Exponents of the quotient-boundary rows' scales: subnormal, near 2^-128
# (where the requantize scale's reciprocal overflows), normal, and near
# 2^121 (where the sum may overflow to inf).
BOUNDARY_EXPONENTS = (
    -146, -140, -134, -130, -129, -128, -127, -126, -125, -100, -60, -20,
    -1, 0, 1, 20, 60, 100, 118, 119, 120, 121,
)


def reduce_boundary_inputs(ranks: int, seed: int) -> tuple:
    """Quotient-boundary payloads: per row a scale with a full random
    mantissa at each of ``BOUNDARY_EXPONENTS`` (eight rows each), each
    rank's scale that one times 1 + d_r with |d_r| < 2^-11 (d_0 = 0, and 0
    for every rank on half the rows), and column 0 at +127 in every rank.
    The quotients then cluster around the half-integers: on half the rows
    within a few ulps of them, on either side; on the others spread over
    the reduce's guard band around them and just outside it."""
    import numpy as np

    rng = np.random.default_rng(seed)
    exps = np.repeat(np.array(BOUNDARY_EXPONENTS), 8)
    rows = exps.size
    q = rng.integers(-127, 128, size=(ranks, rows, 512), dtype=np.int8)
    q[:, :, 0] = 127
    base = rng.uniform(1.0, 2.0, rows) * 2.0 ** exps.astype(np.float64)
    d = rng.uniform(-2.0**-11, 2.0**-11, (ranks, rows))
    d[0] = 0.0
    d[:, ::2] = 0.0
    s = (base[None] * (1.0 + d)).astype(np.float32)
    return q, s


def reduce_host(q, s, avg: bool) -> tuple:
    """The host's reduce of int8 payloads q [R, rows, 512], scales [R, rows]:
    each rank dequantized and added in rank order in fp32, divided by
    np.float32(R) if ``avg``, then requantized. (int8 [rows * 512], fp32
    [rows])."""
    import warnings

    import numpy as np

    from torchft_tpu_torch import collectives as C

    ranks, rows = s.shape
    n = rows * 512
    acc = np.zeros(n, np.float32)
    with warnings.catch_warnings():  # a NaN row warns in numpy
        warnings.simplefilter("ignore", RuntimeWarning)
        for r in range(ranks):
            acc += C.dequantize_blockwise(q[r].reshape(-1), s[r], n)
        if avg:
            acc = acc / np.float32(ranks)
        return C.quantize_blockwise(acc)


def reduce_case(name: str, q_host, s_host, avg: bool) -> float:
    """The reduce kernel on q_host, s_host against its plain version on the
    card and the host's reduce; raises unless every count is 0. Returns the
    largest |kernel - plain| over payload levels and finite scales."""
    import numpy as np
    import torch

    from torchft_tpu_torch.ops import quantization as Q

    dev = torch.device("cuda")
    q = torch.from_numpy(q_host).to(dev)
    s = torch.from_numpy(s_host).to(dev)
    q_k, s_k = Q.fused_reduce_int8(q, s, avg)
    q_p, s_p = Q.reduce_rows_reference(q, s, avg)
    torch.cuda.synchronize()
    q_k, s_k = q_k.cpu().numpy().reshape(-1), s_k.cpu().numpy()
    q_p, s_p = q_p.cpu().numpy().reshape(-1), s_p.cpu().numpy()
    q_h, s_h = reduce_host(q_host, s_host, avg)
    counts = {
        "payload vs plain": mismatches(q_k, q_p),
        "scales vs plain": mismatches(s_k, s_p),
        "payload vs numpy": mismatches(q_k, q_h),
        "scales vs numpy": mismatches(s_k, s_h),
    }
    ranks, rows = s_host.shape
    print(f"reduce ok: {name} R={ranks} rows={rows} avg={avg}: "
          + ", ".join(f"{k} {v}" for k, v in counts.items()), flush=True)
    if any(counts.values()):
        raise AssertionError(f"reduce {name} R={ranks} avg={avg}: mismatches {counts}")
    finite = np.isfinite(s_p)
    return max(
        float(np.abs(q_k.astype(np.int32) - q_p).max(initial=0)),
        float(np.abs(s_k[finite] - s_p[finite]).max(initial=0.0)),
    )


def reduce_timing() -> dict:
    """The reduce kernel at one 32 MiB bucket (TIMED_N values), cycling over
    four inputs (at R = 2 together 67 MB, more than the 50 MB L2): launched
    straight through its C entry point on preallocated outputs (``ms``),
    through its wrapper (``wrapper_ms``), and its plain version. Timed at
    each R in TIMED_RANKS without averaging, then at R = 2 with averaging
    (what the Manager asks for by default) on the same inputs and on
    tie-heavy ones (``reduce_tie_inputs``: half the quotients are ties, so
    nearly every lane takes the kernel's correctly rounded divide). Its
    bound: (R + 1) * (n + 4n/512) bytes over HBM against about 3R + 6 fp32
    operations per value (per rank a convert, a multiply and an add; the
    divide, |x|, max, divide, rint and clamp of the requantize) over the
    fp32 rate. The R = 2 record is the kernel's; the others ride in it
    under ``ranks_4``, ``avg`` and ``tie_heavy``."""
    import torch

    from torchft_tpu_torch.ops import quantization as Q

    dev = torch.device("cuda")
    n = TIMED_N
    rows = n // 512
    lib = Q._library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    q_out = torch.empty((rows, 512), dtype=torch.int8, device=dev)
    s_out = torch.empty(rows, device=dev)
    rcs = []

    def timed(ranks: int, avg: bool, inputs, what: str = "seeded") -> dict:
        raw = [(q.data_ptr(), s.data_ptr(), ranks, rows, int(avg),
                q_out.data_ptr(), s_out.data_ptr(), stream) for q, s in inputs]
        rec = {}
        for key, fn, args, iters in (
            ("ms", lambda *a: rcs.append(lib.tft_reduce_rows_int8(*a)), raw, 50),
            ("wrapper_ms", lambda q, s: Q.fused_reduce_int8(q, s, avg), inputs, 50),
            ("plain_ms", lambda q, s: Q.reduce_rows_reference(q, s, avg), inputs, 10),
        ):
            rec[key], rec[key.replace("ms", "host_ms")] = time_cold(fn, args, iters)
        t_bytes = (ranks + 1) * (n + 4 * rows) / PEAK_BYTES * 1e3
        t_ops = (3 * ranks + 6) * n / PEAK_FLOPS["float32"] * 1e3
        rec["bound_ms"] = max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"timing reduce R={ranks} avg={avg} {what} n={n}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in rec.items() if isinstance(v, float)
        ) + f" ({rec['bound_by']} bound)", flush=True)
        return rec

    def on_card(pairs) -> list:
        return [(torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev))
                for q, s in pairs]

    records = {}
    for ranks in TIMED_RANKS:
        inputs = on_card(
            reduce_inputs(ranks, rows, seed=40 + 4 * ranks + i) for i in range(4)
        )
        records[ranks] = timed(ranks, False, inputs)
        if ranks == 2:
            records["avg"] = timed(ranks, True, inputs)
        del inputs
    ties = on_card(reduce_tie_inputs(2, rows, seed=60 + i) for i in range(4))
    records["tie_heavy"] = timed(2, True, ties, "tie-heavy")
    del ties
    if any(rcs):
        raise AssertionError(f"a timed launch failed: CUDA errors {set(rcs)}")
    reduce = dict(records[TIMED_RANKS[0]])
    reduce["ranks"] = TIMED_RANKS[0]
    reduce["ranks_4"] = records[4]
    reduce["avg"] = records["avg"]
    reduce["tie_heavy"] = records["tie_heavy"]
    reduce["library_ms"] = None
    reduce["library_call"] = "none: no single PyTorch call computes it"
    return reduce


def harness_phase() -> dict:
    """``python -m torchft_tpu_torch.ops.bench_kernels`` on the card in a
    process of its own (its launch counts start at 0): raises unless it
    exits 0 with ``ok`` true and every kernel launched. Returns its JSON."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "torchft_tpu_torch.ops.bench_kernels"],
        cwd=str(REPO), capture_output=True, text=True, timeout=600,
    )
    (OUT / "bench_kernels.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(
            f"bench_kernels exited {proc.returncode}: {proc.stdout[-2000:]}"
            f"{proc.stderr[-4000:]}"
        )
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    (OUT / "bench_kernels.json").write_text(json.dumps(result, indent=1))
    idle = [k for k, v in result["launches"].items() if v <= 0]
    if not result["ok"] or idle or len(result["launches"]) != 9:
        raise AssertionError(
            f"bench_kernels: ok {result['ok']}, never launched {idle}, "
            f"launches {result['launches']}"
        )
    print(f"bench_kernels ok in {time.monotonic() - t0:.1f}s: "
          + json.dumps(result), flush=True)
    return result


def reduce_phase() -> tuple:
    """Phase 5: (the reduce kernel's record, the harness's JSON)."""
    t0 = time.monotonic()
    err = 0.0
    for ranks in REDUCE_RANKS:
        for avg in (False, True):
            for rows in REDUCE_ROWS:
                err = max(err, reduce_case(
                    "seeded", *reduce_inputs(ranks, rows, seed=ranks * 10 + rows),
                    avg,
                ))
            err = max(err, reduce_case(
                "special rows", *reduce_special_inputs(ranks), avg
            ))
            err = max(err, reduce_case(
                "tie-heavy", *reduce_tie_inputs(ranks, 512, seed=ranks), avg
            ))
            err = max(err, reduce_case(
                "quotient boundary", *reduce_boundary_inputs(ranks, seed=ranks),
                avg,
            ))
    record = reduce_timing()
    record["max_abs_err"] = err
    harness = harness_phase()
    print(f"reduce phase ok in {time.monotonic() - t0:.1f}s", flush=True)
    return record, harness


# ---------------------------------------------------------------------------
# Phases 6 to 8: the fault-tolerant training path
# ---------------------------------------------------------------------------

PATH_ARGS = [
    "--model", "small", "--attn", "flash", "--batch", "8", "--seq", "1024",
    "--steps", "8", "--device", "cuda",
]
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
QUANT_KERNELS = ("quantize", "dequantize")
RING_ARGS = [a if a != "flash" else "ring" for a in PATH_ARGS]
ULYSSES_ARGS = [a if a != "flash" else "ulysses" for a in PATH_ARGS]
# The JAX package's model-heal drill's wire (tools/drills.py) at the sizes
# its trainer runs these models on one chip.
# The flash drill's parameters as the mesh-free trainer (a plain model, no
# FSDP2; PRs 10-13) ended them: at one rank a group's FSDP2 state and its
# steps compute the same bits.
MESH_FREE_FLASH_SHA = (
    "121fa4002656e04bf5c7d70f9b5fbecb9e6a8aedea8b595e4993a2ee9c885725"
)
SMALL_FAMILY_ARGS = [
    "--batch", "8", "--seq", "64", "--steps", "6", "--quantize",
    "--quantize-bits", "4", "--device", "cuda",
]
MOE_ARGS = ["--model", "moe", *SMALL_FAMILY_ARGS]
PIPELINE_ARGS = ["--model", "pipeline", *SMALL_FAMILY_ARGS]


def path_phase(name: str, args, kernels, absent=(), env=None) -> dict:
    """One kill/heal drill of two groups of one rank; raises unless both
    end at the last step (``--steps``) with equal parameters and finite
    losses, every kernel in
    ``kernels`` launched in both groups and none in ``absent``. Each
    group's process counts its own launches from 0, so the counts are this
    drill's alone. ``env`` goes to the groups' processes."""
    import shutil

    from torchft_tpu_torch.drill import kill_heal_drill

    result_dir = OUT / name
    shutil.rmtree(result_dir, ignore_errors=True)
    # The counts of this run only: each group's process starts its own at
    # 0. This process's counts are left alone, since the drills run beside
    # phases that count launches here (``drill_phases``).
    t0 = time.monotonic()
    results = kill_heal_drill(
        args, str(result_dir), str(result_dir / "logs"),
        kill_after_step=3, timeout_s=400.0, env=env,
    )
    wall = time.monotonic() - t0
    steps = int(args[args.index("--steps") + 1])
    for g, r in results.items():
        if [rk["world_size"] for rk in r["ranks"]] != [1]:
            raise AssertionError(f"{name}: group {g} ranks {r['ranks']}")
        if r["final_step"] != steps:
            raise AssertionError(f"{name}: group {g} ended at step {r['final_step']}")
        if not all(math.isfinite(x) for x in r["losses"]) or not r["losses"]:
            raise AssertionError(f"{name}: group {g} losses not finite: {r['losses']}")
        for kernel in kernels:
            if r["kernel_launches"][kernel] <= 0:
                raise AssertionError(f"{name}: group {g} never launched {kernel}")
        for kernel in absent:
            if r["kernel_launches"][kernel] != 0:
                raise AssertionError(
                    f"{name}: group {g} launched {kernel} "
                    f"{r['kernel_launches'][kernel]} times"
                )
    if results[0]["param_sha256"] != results[1]["param_sha256"]:
        raise AssertionError(
            f"{name}: groups disagree after kill + heal: "
            f"{results[0]['param_sha256']} vs {results[1]['param_sha256']}"
        )
    for g, r in results.items():
        med = r["median_step_ms"]
        print(
            f"{name} group {g}: final_step {r['final_step']} losses "
            f"{[round(x, 4) for x in r['losses']]} launches "
            f"{r['kernel_launches']} median step {med:.1f} ms "
            f"({r['tokens_per_step'] / (med / 1e3):.0f} tokens/s) phases "
            + json.dumps({k: round(v, 1) for k, v in r["median_phase_ms"].items()}),
            flush=True,
        )
    print(f"{name} ok: param_sha256 equal {results[0]['param_sha256'][:16]}, "
          f"drill wall {wall:.1f}s", flush=True)
    return results


# ---------------------------------------------------------------------------
# Phases 9 and 10: Streaming DiLoCo and LocalSGD
# ---------------------------------------------------------------------------

DILOCO_OUTER_STEPS = 10
DILOCO_ARGS = [
    "--outer-steps", str(DILOCO_OUTER_STEPS), "--sync-every", "4",
    "--n-fragments", "2", "--fragment-sync-delay", "0", "--quantize",
    "--quantize-bits", "4", "--error-feedback", "--batch-size", "4",
    "--seq-len", "64", "--device", "cuda",
]


def diloco_phase() -> dict:
    """Phase 9: the kill/heal drill over ``train_diloco`` on the card.
    Raises unless both groups end at outer step 10 with equal
    ``global_sha``, finite losses, device ``cuda:0`` and no kernel launch.
    Returns {group: result JSON} with the drill's wall time under
    ``"wall_s"``."""
    import shutil

    from torchft_tpu_torch.drill import kill_heal_drill

    result_dir = OUT / "diloco"
    shutil.rmtree(result_dir, ignore_errors=True)
    t0 = time.monotonic()
    results = kill_heal_drill(
        DILOCO_ARGS, str(result_dir), str(result_dir / "logs"),
        kill_after_step=2, timeout_s=400.0,
        trainer="torchft_tpu_torch.train_diloco", mark="outer_step={n} loss",
    )
    wall = time.monotonic() - t0
    healed = (result_dir / "logs" / "group1.log").read_text(errors="replace")
    if "healing from replica_rank=0" not in healed.split("SIGKILLed")[-1]:
        raise AssertionError("diloco: the restarted group 1 did not heal from group 0")
    for g, r in results.items():
        if r["final_outer_step"] != DILOCO_OUTER_STEPS:
            raise AssertionError(
                f"diloco: group {g} ended at outer step {r['final_outer_step']}"
            )
        if not r["losses"] or not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"diloco: group {g} losses not finite: {r['losses']}")
        if r["device"] != "cuda:0":
            raise AssertionError(f"diloco: group {g} ran on {r['device']}")
        launched = {k: v for k, v in r["kernel_launches"].items() if v}
        if launched:
            raise AssertionError(
                f"diloco: group {g} launched {launched}: its pseudogradients "
                "are quantized on the host and S=64 attention is dense"
            )
    if results[0]["global_sha"] != results[1]["global_sha"]:
        raise AssertionError(
            "diloco: groups disagree after kill + heal: "
            f"{results[0]['global_sha']} vs {results[1]['global_sha']}"
        )
    for g, r in results.items():
        print(
            f"diloco group {g}: final_outer_step {r['final_outer_step']} "
            f"inner_steps {r['inner_steps']} syncs {r['syncs']} losses "
            f"{[round(x, 4) for x in r['losses']]} median inner step "
            f"{r['median_inner_ms']:.2f} ms median sync "
            f"{r['median_sync_ms']:.2f} ms",
            flush=True,
        )
    print(f"diloco ok: global_sha equal {results[0]['global_sha'][:16]}, "
          f"drill wall {wall:.1f}s", flush=True)
    return {"wall_s": wall, **results}


def localsgd_phase() -> dict:
    """Phase 10: one int8 LocalSGD round between two in-process replicas
    on the card. Raises unless both commit with parameters equal to each
    other and to the host quantizer's average, bit for bit, and unless the
    quantize and dequantize kernels launched for both. Returns the
    launches of this phase and each replica's sync wall time."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from torchft_tpu_torch.collectives import (
        dequantize_blockwise,
        quantize_blockwise,
    )
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.local_sgd import LocalSGD
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models import Transformer, llama_debug
    from torchft_tpu_torch.ops import quantization
    from torchft_tpu_torch.process_group import ProcessGroupSocket

    dev = torch.device("cuda", 0)
    models = []
    for r in range(2):
        torch.manual_seed(100 + r)  # the replicas start apart
        models.append(Transformer(llama_debug()).to(dev))
    before = [
        {n: p.detach().clone() for n, p in m.named_parameters()} for m in models
    ]
    n_values = sum(p.numel() for p in before[0].values())
    chunks = -(-n_values // quantization._TRANSFER_CHUNK)
    lighthouse = LighthouseServer(
        bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=10000,
        quorum_tick_ms=20,
    )

    def replica(r: int) -> tuple:
        params = dict(models[r].named_parameters())

        def set_params(values) -> None:
            with torch.no_grad():
                for n, v in values.items():
                    params[n].copy_(torch.as_tensor(v))

        manager = Manager(
            pg=ProcessGroupSocket(timeout=30.0),
            min_replica_size=2,
            use_async_quorum=False,
            timeout=60.0,
            quorum_timeout=60.0,
            replica_id=f"chip_smoke_localsgd{r}",
            lighthouse_addr=lighthouse.address(),
            group_rank=0,
            group_world_size=1,
            init_sync=False,
        )
        try:
            local_sgd = LocalSGD(
                manager, lambda: params, set_params, sync_every=2,
                should_quantize=True,
            )
            if local_sgd.step() is not None:
                raise AssertionError("LocalSGD synced before sync_every")
            t0 = time.monotonic()
            committed = local_sgd.step()
            torch.cuda.synchronize(dev)
            return committed, time.monotonic() - t0
        finally:
            manager.shutdown()

    for kernel in quantization.LAUNCHES:
        quantization.LAUNCHES[kernel] = 0
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            outs = [f.result(timeout=300) for f in
                    [pool.submit(replica, r) for r in range(2)]]
    finally:
        lighthouse.shutdown()
    launches = dict(quantization.LAUNCHES)
    if not all(committed for committed, _ in outs):
        raise AssertionError(f"localsgd: a replica did not commit: {outs}")
    # Each replica quantizes its payload and dequantizes the reduced one in
    # `chunks` transfer chunks: 2 * chunks launches need both replicas.
    for kernel in QUANT_KERNELS:
        if launches[kernel] != 2 * chunks:
            raise AssertionError(
                f"localsgd: {kernel} launched {launches[kernel]} times, want "
                f"{2 * chunks} ({chunks} per replica)"
            )
    for (name, p0), p1 in zip(models[0].named_parameters(), models[1].parameters()):
        if not torch.equal(p0, p1):
            raise AssertionError(f"localsgd: replicas differ in {name}")
    # The host quantizer's average of the same payloads: each rank's flat
    # (its leaves in sorted name order, the wire's layout) quantized and
    # decoded, summed in rank order, requantized, decoded, halved (the
    # wire's blocks are block-aligned, so its chunking changes no value).
    # The kernels write the host quantizer's bytes.
    names = sorted(before[0])
    acc = np.zeros(n_values, np.float32)
    for b in before:
        flat = torch.cat([b[n].reshape(-1) for n in names]).cpu().numpy()
        acc += dequantize_blockwise(*quantize_blockwise(flat, 8), n_values, 8)
    want = dequantize_blockwise(*quantize_blockwise(acc, 8), n_values, 8)
    want *= np.float32(0.5)
    params0 = dict(models[0].named_parameters())
    got = torch.cat(
        [params0[n].detach().reshape(-1) for n in names]
    ).cpu().numpy()
    differ = int((got.view(np.int32) != want.view(np.int32)).sum())
    if differ:
        raise AssertionError(
            f"localsgd: {differ} of {n_values} values differ from the host "
            "quantizer's int8 average"
        )
    sync_ms = [secs * 1e3 for _, secs in outs]
    print(f"localsgd ok: {n_values} values, int8, params equal on both "
          "replicas and to the host quantizer's average bit for bit, sync "
          f"{sync_ms[0]:.1f} / {sync_ms[1]:.1f} ms, launches {launches}",
          flush=True)
    return {"launches": launches, "sync_ms": sync_ms}


# ---------------------------------------------------------------------------
# Phase 11: fault-tolerant DDP on ResNet-50
# ---------------------------------------------------------------------------

DDP_STEPS = 6
DDP_ARGS = [
    "--model", "resnet50", "--image-size", "224", "--num-classes", "1000",
    "--batch-size", "32", "--steps", str(DDP_STEPS), "--quantize",
    "--device", "cuda",
]


def ddp_phase() -> dict:
    """Phase 11: the kill/heal drill over ``train_ddp`` (ResNet-50, int8 on
    the device path) on the card. Raises unless both groups end at step 6
    with equal ``param_sha256``, finite losses and device ``cuda:0``, the
    relaunched group's first committed step started from group 0's
    BatchNorm statistics, bit for bit, and the quantize kernels (and no
    flash kernel) launched in both groups. Returns {group: result JSON}
    with the drill's wall time under ``"wall_s"``."""
    import shutil

    from torchft_tpu_torch.drill import kill_heal_drill

    result_dir = OUT / "ddp"
    shutil.rmtree(result_dir, ignore_errors=True)
    t0 = time.monotonic()
    results = kill_heal_drill(
        DDP_ARGS, str(result_dir), str(result_dir / "logs"),
        kill_after_step=3, timeout_s=400.0,
        trainer="torchft_tpu_torch.train_ddp", mark="[group 1] step={n} loss=",
    )
    wall = time.monotonic() - t0
    healed = (result_dir / "logs" / "group1.log").read_text(errors="replace")
    if "healing from replica_rank=0" not in healed.split("SIGKILLed")[-1]:
        raise AssertionError("ddp: the restarted group 1 did not heal from group 0")
    for g, r in results.items():
        if r["final_step"] != DDP_STEPS:
            raise AssertionError(f"ddp: group {g} ended at step {r['final_step']}")
        if not r["losses"] or not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"ddp: group {g} losses not finite: {r['losses']}")
        if r["device"] != "cuda:0":
            raise AssertionError(f"ddp: group {g} ran on {r['device']}")
        for kernel in QUANT_KERNELS:
            if r["kernel_launches"][kernel] <= 0:
                raise AssertionError(f"ddp: group {g} never launched {kernel}")
        for kernel in FLASH_KERNELS + BLOCK_KERNELS:
            if r["kernel_launches"][kernel] != 0:
                raise AssertionError(f"ddp: group {g} launched {kernel}")
    if results[0]["param_sha256"] != results[1]["param_sha256"]:
        raise AssertionError(
            "ddp: groups disagree after kill + heal: "
            f"{results[0]['param_sha256']} vs {results[1]['param_sha256']}"
        )
    # The param sha cannot see a heal that forgets the statistics (train
    # mode never reads them), so hold the statistics themselves.
    stats = [results[g]["batch_stats_sha"] for g in (0, 1)]
    first = min(stats[1], key=int)
    if stats[1][first] != stats[0].get(first):
        raise AssertionError(
            f"ddp: the relaunched group's first committed step {first} started "
            "from other BatchNorm statistics than group 0's"
        )
    for g, r in results.items():
        med = r["median_step_ms"]
        print(
            f"ddp group {g}: final_step {r['final_step']} committed_steps "
            f"{r['committed_steps']} losses {[round(x, 4) for x in r['losses']]} "
            f"launches {r['kernel_launches']} median step {med:.1f} ms "
            f"({r['images_per_step'] / (med / 1e3):.1f} images/s) phases "
            + json.dumps({k: round(v, 1) for k, v in r["median_phase_ms"].items()}),
            flush=True,
        )
    print(f"ddp ok: param_sha256 equal {results[0]['param_sha256'][:16]}, "
          f"BatchNorm statistics equal at the healed step {first}, drill wall "
          f"{wall:.1f}s", flush=True)
    return {"wall_s": wall, **results}


# ---------------------------------------------------------------------------
# Phases 12 to 14: Ulysses attention, MoE and GPipe through train_hsdp
# ---------------------------------------------------------------------------

PIPELINE_TOL = 1e-5


def pipeline_check(device: str = "cuda") -> dict:
    """Phase 14's check: the GPipe loss and gradients at pp=2 on a mesh
    that repeats the card against pp=1, on the same weights and batch
    (the pipeline drill's model, llama_debug with 4 layers, in fp32; B=8,
    S=64, 2 microbatches). Raises unless the loss and every gradient agree
    within ``PIPELINE_TOL`` of their largest value."""
    import dataclasses

    import torch

    from torchft_tpu_torch.models import Transformer, llama_debug
    from torchft_tpu_torch.parallel import make_mesh, pipeline_grad_step

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    cfg = dataclasses.replace(
        llama_debug(num_layers=4), dtype=torch.float32, remat=False
    )
    torch.manual_seed(0)
    model = Transformer(cfg).to(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    inputs = torch.randint(0, cfg.vocab_size, (8, 64), generator=g, device=dev)
    batch = {"inputs": inputs, "targets": torch.roll(inputs, -1, 1),
             "mask": torch.ones_like(inputs)}
    runs = {}
    for pp in (1, 2):
        mesh = make_mesh(pp=pp, devices=[dev] * pp)
        loss, grads = pipeline_grad_step(model, batch, mesh, n_micro=2)
        runs[pp] = (float(loss), {k: v.clone() for k, v in grads.items()})
    (l1, g1), (l2, g2) = runs[1], runs[2]
    worst = max(
        float((g2[k] - g1[k]).abs().max()) / max(float(g1[k].abs().max()), 1e-30)
        for k in g1
    )
    if not (math.isfinite(l1) and abs(l2 - l1) <= PIPELINE_TOL * abs(l1)
            and worst <= PIPELINE_TOL):
        raise AssertionError(
            f"pipeline pp=2 vs pp=1: loss {l2} vs {l1}, worst gradient "
            f"error {worst:.3g} of its largest value"
        )
    print(f"pipeline ok: pp=2 vs pp=1 fp32 loss {l2:.6f} vs {l1:.6f}, worst "
          f"gradient error {worst:.3g} of its largest value ({len(g1)} leaves)",
          flush=True)
    return {"loss": (l1, l2), "worst_grad_rel": worst}


# ---------------------------------------------------------------------------
# Phases 15 and 16: the checkpoint paths (pg-sharded heal, durable snapshots)
# ---------------------------------------------------------------------------

PG_SHARDED_ARGS = [*PATH_ARGS, "--ckpt-transport", "pg-sharded"]
# Snapshots of ~1.50 GB each, kept out of OUT so the logs directory stays
# small.
DURABLE_DIR = REPO / "build" / "chip_smoke_durable"


def journal_env(name: str) -> dict:
    """The groups' journal directory for drill ``name``, inside the
    directory ``path_phase`` empties before it starts."""
    return {"TORCHFT_JOURNAL_DIR": str(OUT / name / "journal")}


def heal_receives(name: str) -> list:
    """The ``heal_xfer`` receives in drill ``name``'s group 1 journals
    after step 0 (the relaunched group's heal; both groups' first quorum
    at step 0 heals too)."""
    return [
        {**e["attrs"], "step": e["step"]}
        for f in sorted((OUT / name / "journal").glob("journal_replica1_*.jsonl"))
        for e in map(json.loads, f.read_text().splitlines())
        if e["event"] == "heal_xfer" and e["attrs"]["dir"] == "recv"
        and e["step"] > 0
    ]


def llama_small_state_bytes() -> tuple:
    """(bytes, parameter count, tensor count) of the heal state of
    llama_small under AdamW: params, exp_avg and exp_avg_sq at the params'
    dtype, and the float32 step torch keeps per parameter tensor. Worked
    out from the model's shapes (built on the meta device)."""
    import torch

    from torchft_tpu_torch.models import Transformer, llama_small

    with torch.device("meta"):
        params = list(Transformer(llama_small()).parameters())
    nbytes = sum(3 * p.numel() * p.element_size() for p in params) + 4 * len(params)
    return nbytes, sum(p.numel() for p in params), len(params)


def check_heals(name: str, transport: str) -> dict:
    """Raises unless drill ``name``'s relaunched group received its heal by
    ``transport`` ("http", or "pg" sharded) in exactly the state's bytes;
    returns the last such receive's journal record."""
    heals = heal_receives(name)
    want, n_params, n_tensors = llama_small_state_bytes()
    if not heals:
        raise AssertionError(f"{name}: no heal_xfer receive in group 1's journal")
    for heal in heals:
        if heal["transport"] != transport or (
            transport == "pg" and not heal.get("sharded")
        ):
            raise AssertionError(f"{name}: not a {transport} receive: {heal}")
        if heal["nbytes"] != want:
            raise AssertionError(
                f"{name}: the heal received {heal['nbytes']} B, the state is "
                f"{want} B ({n_params} parameters in {n_tensors} tensors)"
            )
    print(f"{name} ok: {want} B = 3 x {n_params} x 4 B + {n_tensors} steps x "
          f"4 B received by {transport}", flush=True)
    return heals[-1]


def heal_line(label: str, heal: dict) -> str:
    return (f"{label} heal at step {heal['step']}: {heal['nbytes']} B, "
            f"elapsed {heal['elapsed_s']:.3f} s (wire {heal['wire_s']:.3f} s, "
            f"ser {heal['ser_s']:.3f} s), "
            f"{heal['nbytes'] / heal['elapsed_s'] / 1e9:.3f} GB/s")


def pg_sharded_phase() -> tuple:
    """Phase 15: the flash drill healing over ``--ckpt-transport
    pg-sharded``. Raises unless it ends in the flash drill's parameters
    (``MESH_FREE_FLASH_SHA``, which phase 6 is held to) and
    the relaunched group's sharded receive moved exactly the state's
    bytes. Returns (the drill's results, that receive's journal record)."""
    name = "pg-sharded path"
    runs = path_phase(
        name, PG_SHARDED_ARGS, FLASH_KERNELS, absent=BLOCK_KERNELS,
        env=journal_env(name),
    )
    if runs[0]["param_sha256"] != MESH_FREE_FLASH_SHA:
        raise AssertionError(
            f"the pg-sharded drill ended in other parameters than the flash "
            f"drill ({runs[0]['param_sha256']} vs {MESH_FREE_FLASH_SHA}): "
            "the heal transport changed bits"
        )
    return runs, check_heals(name, "pg")


def preempt_phase() -> dict:
    """Phase 16: the full-job preemption drill over the flash drill's
    groups. ``preempt_all_drill`` raises unless both groups drained, each
    resumed from its drain-time snapshot and both ended equal; this phase
    also requires step 8, the flash drill's parameters
    (``MESH_FREE_FLASH_SHA``), every flash kernel launched in both
    relaunched groups and no block kernel. The snapshots
    are deleted afterwards."""
    import shutil

    from torchft_tpu_torch.drill import preempt_all_drill

    result_dir = OUT / "preempt"
    shutil.rmtree(result_dir, ignore_errors=True)
    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    # The counts of this run only: each group's process starts its own at 0
    # (as in ``path_phase``).
    try:
        out = preempt_all_drill(
            "torchft_tpu_torch.train_hsdp",
            # Cadence 3: the drain (step 4 or 5) then writes its own
            # snapshot instead of finding the cadence's at its step.
            [*PATH_ARGS, "--durable-every", "3", "--durable-dir", str(DURABLE_DIR)],
            str(result_dir), str(result_dir / "logs"),
            term_after_step=3, timeout_s=600.0,
        )
    finally:
        shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    for g, r in out["resume"].items():
        if r["final_step"] != 8 or r["param_sha256"] != MESH_FREE_FLASH_SHA:
            raise AssertionError(
                f"preemption drill: group {g} ended at step {r['final_step']} "
                f"in {r['param_sha256']}, not at step 8 in the flash drill's "
                f"{MESH_FREE_FLASH_SHA}"
            )
        if not r["losses"] or not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"preemption drill: group {g} losses {r['losses']}")
        for kernel in FLASH_KERNELS:
            if r["kernel_launches"][kernel] <= 0:
                raise AssertionError(f"preemption drill: group {g} never launched {kernel}")
        for kernel in BLOCK_KERNELS:
            if r["kernel_launches"][kernel] != 0:
                raise AssertionError(f"preemption drill: group {g} launched {kernel}")
    for phase in ("drain", "resume"):
        for g, r in out[phase].items():
            for save in r["durable_saves"]:
                print(f"preemption drill {phase} group {g}: snapshot at step "
                      f"{save['step']}: {save['nbytes']} B, host copy "
                      f"{save['copy_s']:.3f} s, write {save['write_s']:.3f} s "
                      f"({save['nbytes'] / save['write_s'] / 1e9:.3f} GB/s)",
                      flush=True)
            med = r["median_step_ms"]
            print(f"preemption drill {phase} group {g}: final_step "
                  f"{r['final_step']} committed {r['committed_steps']} median "
                  f"step {med:.1f} ms phases "
                  + json.dumps({k: round(v, 1) for k, v in r["median_phase_ms"].items()}),
                  flush=True)
    print(f"preemption drill ok: drained at {out['drained_steps']}, resumed from "
          f"{out['resumed_from_steps']}, both at step 8 in "
          f"{MESH_FREE_FLASH_SHA[:16]}, drill wall {out['wall_s']:.1f}s",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 17: the sharded train step (FSDP2 at one rank)
# ---------------------------------------------------------------------------

# The limit on ``make_train_step`` against the mesh-free model doing the
# same arithmetic (``train_step_reference``): bit for bit. At accum 1 both
# take one grad step on the whole batch; at accum 2 both take grad steps on
# the rows 0::2 and 1::2 (the same shapes, so the same kernels and tilings
# on both sides), add the two fp32 gradients and halve the sum (exact), and
# both apply one AdamW step. At one rank FSDP2's all-gather and
# reduce-scatter are copies, so nothing else differs: the largest
# difference of the loss, of any gradient element over its leaf's largest
# |value| and of any parameter element must be 0. Each planted fault
# (microbatch 1 left out; the 1/2 dropped) must exceed it in the
# gradients, or the check could not fail.
ACCUM_LIMIT = 0.0
TRAIN_STEP_FAULTS = {
    "microbatch 1 left out": lambda parts: parts[0],
    "the 1/2 dropped": lambda parts: (
        parts[0][0] + parts[1][0],
        {n: parts[0][1][n] + parts[1][1][n] for n in parts[0][1]},
    ),
}


def halved_sum(parts) -> tuple:
    """accum 2's arithmetic on the two microbatches' (loss, gradients)."""
    (l0, g0), (l1, g1) = parts
    return (l0 + l1) * 0.5, {n: (g0[n] + g1[n]).mul_(0.5) for n in g0}


def train_step_reference(model, init, batch, rows, combine) -> tuple:
    """(loss, gradients, parameters) of the mesh-free ``grad_step`` on each
    of ``rows`` of ``batch``, their (loss, gradients) combined by
    ``combine``, then one AdamW step from the parameters ``init``."""
    import torch

    from torchft_tpu_torch.parallel.train import default_optimizer, grad_step

    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(init[n])
    parts = []
    for r in rows:
        loss, grads = grad_step(model, {k: v[r] for k, v in batch.items()})
        parts.append((loss, {n: g.clone() for n, g in grads.items()}))
    loss, grads = combine(parts)
    optimizer = default_optimizer(model.parameters())
    for n, p in model.named_parameters():
        p.grad = grads[n]
    optimizer.step()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return float(loss), grads, params


def rel_diff(got: dict, want: dict) -> float:
    """The worst leaf's largest |got - want| over its largest |want|."""
    return max(
        float((got[n] - want[n]).abs().max()) / max(float(want[n].abs().max()), 1e-30)
        for n in want
    )


def step_diff(got: tuple, want: tuple) -> dict:
    """The largest differences of ``got``'s loss, gradients (each over its
    leaf's largest |value|) and parameters from ``want``'s."""
    (l1, g1, p1), (l2, g2, p2) = got, want
    return {
        "loss": abs(l1 - l2),
        "grad": rel_diff(g1, g2),
        "param": max(float((p1[n] - p2[n]).abs().max()) for n in p2),
    }


def traced_split(fn, device) -> dict:
    """One call of ``fn`` under torch.profiler: its window, the device's
    busy time, and the host time inside FSDP2's own ranges (its hooks,
    gathers, reduce-scatter and the post-backward callback) and inside
    ``Optimizer.step``, in ms (unions of intervals over the host threads)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torchft_tpu_torch.profile_step import union_us

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        fn()
        torch.cuda.synchronize(device)
    trace = OUT / "train_step_trace.json"
    prof.export_chrome_trace(str(trace))
    events = [
        e for e in json.loads(trace.read_text())["traceEvents"]
        if e.get("ph") == "X" and "dur" in e
    ]
    trace.unlink()
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")]

    def host_ms(pred) -> float:
        return union_us(
            (e["ts"], e["ts"] + e["dur"]) for e in host if pred(e["name"])
        ) / 1e3

    return {
        "window_ms": (max(e["ts"] + e["dur"] for e in events)
                      - min(e["ts"] for e in events)) / 1e3,
        "device_busy_ms": union_us((e["ts"], e["ts"] + e["dur"]) for e in dev) / 1e3,
        "fsdp_host_ms": host_ms(
            lambda n: n.startswith(("FSDP::", "fsdp::"))
            or "RegisterPostBackward" in n
        ),
        "adamw_host_ms": host_ms(lambda n: n.startswith("Optimizer.step")),
    }


def train_step_phase() -> dict:
    """Phase 17: ``make_train_step`` on the card at llama_small's widths
    (B=8, S=1024, flash, one NCCL rank): one step at ``accum_steps`` 1 and
    one at 2, each from a fresh ``init_train_state`` (seed 0), each held to
    ``train_step_reference`` within ``ACCUM_LIMIT``, and each planted fault
    of ``TRAIN_STEP_FAULTS`` held to fail that check. Counts the flash
    launches of the two steps, then times warm steps of FSDP2 and of the
    mesh-free model in turns and traces one of each."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from torchft_tpu_torch.models import llama_small
    from torchft_tpu_torch.ops import flash_attention
    from torchft_tpu_torch.parallel.mesh import group_mesh, init_group
    from torchft_tpu_torch.parallel.train import (
        build_model,
        default_optimizer,
        grad_step,
        init_train_state,
        make_grad_step,
        make_train_step,
    )

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(
        llama_small(), attn_impl="flash", flash_min_seq=1024, remat=False
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = torch.randint(0, cfg.vocab_size, (8, 1024), generator=gen, device=dev)
    batch = {"inputs": inputs, "targets": torch.roll(inputs, -1, 1),
             "mask": torch.ones_like(inputs, dtype=torch.int32)}
    init_group(dev)
    try:
        mesh = group_mesh(1, 0, dev)
        out = {"launches": {k: 0 for k in FLASH_KERNELS}, "ms": {}, "diff": {}}
        steps = {}
        for accum in (1, 2):
            state, _ = init_train_state(cfg, mesh, dev, seed=0)
            step = make_train_step(state, accum_steps=accum)
            for k in flash_attention.LAUNCHES:
                flash_attention.LAUNCHES[k] = 0
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize(dev)
            out["ms"][accum] = (time.perf_counter() - t0) * 1e3
            for k in FLASH_KERNELS:
                if flash_attention.LAUNCHES[k] != 12 * accum:
                    raise AssertionError(
                        f"train step accum {accum}: {k} launched "
                        f"{flash_attention.LAUNCHES[k]} times, want {12 * accum}"
                    )
                out["launches"][k] += flash_attention.LAUNCHES[k]
            named = list(state.model.named_parameters())
            steps[accum] = (
                float(metrics["loss"]),
                {n: p.grad.full_tensor().clone() for n, p in named},
                {n: p.detach().full_tensor().clone() for n, p in named},
            )
            if accum == 1:
                sharded = state
            del state, step, named
        # The mesh-free model of the same seed, and its initial parameters.
        torch.manual_seed(0)
        model = build_model(cfg, mesh).to(dev)
        init = {n: p.detach().clone() for n, p in model.named_parameters()}
        whole, halves = [slice(None)], [slice(0, None, 2), slice(1, None, 2)]
        refs = {
            1: train_step_reference(model, init, batch, whole, lambda parts: parts[0]),
            2: train_step_reference(model, init, batch, halves, halved_sum),
        }
        for accum, ref in refs.items():
            out["diff"][accum] = step_diff(steps[accum], ref)
        for fault, combine in TRAIN_STEP_FAULTS.items():
            ref = train_step_reference(model, init, batch, halves, combine)
            out["diff"][fault] = step_diff(steps[2], ref)
        del refs, ref
        for case, d in out["diff"].items():
            print(f"train step {'accum ' if case in (1, 2) else 'fault: '}{case}: "
                  f"loss {d['loss']:.3g}, worst gradient {d['grad']:.3g} of its "
                  f"leaf's largest, worst parameter {d['param']:.3g} (limit "
                  f"{ACCUM_LIMIT:g})", flush=True)
        for accum in (1, 2):
            if max(out["diff"][accum].values()) > ACCUM_LIMIT:
                raise AssertionError(
                    f"train step accum {accum} differs from the mesh-free "
                    f"model's: {out['diff'][accum]}"
                )
        for fault in TRAIN_STEP_FAULTS:
            if out["diff"][fault]["grad"] <= ACCUM_LIMIT:
                raise AssertionError(
                    f"train step: the planted fault '{fault}' passes the check"
                )
        print(f"train step ok: accum 1 loss {steps[1][0]:.6f} {out['ms'][1]:.1f} ms, "
              f"accum 2 loss {steps[2][0]:.6f} {out['ms'][2]:.1f} ms, bit for bit "
              f"({len(steps[1][1])} gradients and parameters); launches "
              f"{out['launches']}", flush=True)
        out["loss"] = (steps[1][0], steps[2][0])
        del steps
        # FSDP2's cost at one rank: warm steps of the sharded state and of
        # the mesh-free model on the same batch, in turns (medians of 7),
        # each the trainer's work without the allreduce: the grad step,
        # then AdamW.
        fsdp_grad_step = make_grad_step(sharded)
        optimizer = default_optimizer(model.parameters())
        sides = {
            "fsdp2": (lambda: fsdp_grad_step(batch), sharded.optimizer.step),
            "mesh_free": (lambda: grad_step(model, batch), optimizer.step),
        }

        def timed(fn) -> float:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            return (time.perf_counter() - t0) * 1e3

        for grad, opt in sides.values():  # the mesh-free AdamW's first step
            grad()
            opt()
        ms = {side: {"grad": [], "adamw": []} for side in sides}
        for _ in range(7):
            for side, (grad, opt) in sides.items():
                ms[side]["grad"].append(timed(grad))
                ms[side]["adamw"].append(timed(opt))
        out["steady_ms"] = {
            side: {k: statistics.median(v) for k, v in parts.items()}
            for side, parts in ms.items()
        }
        out["trace"] = {
            side: traced_split(lambda: (grad(), opt()), dev)
            for side, (grad, opt) in sides.items()
        }
        for side in sides:
            steady, trace = out["steady_ms"][side], out["trace"][side]
            print(f"warm {side}: grad step {steady['grad']:.1f} ms "
                  f"{[round(x, 1) for x in ms[side]['grad']]}, AdamW "
                  f"{steady['adamw']:.1f} ms {[round(x, 1) for x in ms[side]['adamw']]}; "
                  f"traced step: window {trace['window_ms']:.1f} ms, device busy "
                  f"{trace['device_busy_ms']:.1f} ms, host in FSDP2 "
                  f"{trace['fsdp_host_ms']:.1f} ms, in AdamW "
                  f"{trace['adamw_host_ms']:.1f} ms", flush=True)
        return out
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Phase 6's TORCHFT_PERF check and phase 18: the bench
# ---------------------------------------------------------------------------

FLOP_TOL = 0.10  # measured FLOPs against the analytic 6ND + attention count
PERF_SUFFIX = re.compile(r"step (\d+) loss .* perf\[[^]]*mfu=([0-9.]+)%")


def check_perf(name: str) -> dict:
    """Raises unless drill ``name`` (run under ``TORCHFT_PERF=1``) left a
    ``perf_model`` event in every group process's journal whose FLOPs are
    within ``FLOP_TOL`` of ``perf.flops_per_step`` for llama_small at
    B=8, S=1024, and a ``perf[`` suffix with 0 < mfu < 100% on every
    committed step line of both groups. Returns the events and the mfus."""
    import torch

    from torchft_tpu_torch import perf
    from torchft_tpu_torch.models import Transformer, llama_small

    with torch.device("meta"):
        n = sum(p.numel() for p in Transformer(llama_small()).parameters())
    analytic = perf.flops_per_step(n, llama_small(), 8, 1024)
    events = [
        e["attrs"] for f in sorted((OUT / name / "journal").glob("*.jsonl"))
        for e in map(json.loads, f.read_text().splitlines())
        if e["event"] == "perf_model"
    ]
    if len(events) != 3:  # group 0, group 1 and its relaunch
        raise AssertionError(f"{name}: {len(events)} perf_model events, not 3")
    for ev in events:
        if abs(ev["flops"] / analytic - 1) > FLOP_TOL:
            raise AssertionError(
                f"{name}: counted {ev['flops']:.4g} FLOPs a step, analytic "
                f"{analytic:.4g}: more than {FLOP_TOL:.0%} apart"
            )
    mfus = {}
    for g in (0, 1):
        log = (OUT / name / "logs" / f"group{g}.log").read_text(errors="replace")
        lines = [ln for ln in log.splitlines() if f"[group {g}] step " in ln
                 and " loss " in ln]
        found = [PERF_SUFFIX.search(ln) for ln in lines]
        if not lines or not all(found):
            raise AssertionError(f"{name}: group {g} step lines without perf[: {lines}")
        mfus[g] = [float(m.group(2)) / 100 for m in found]
        if not all(0 < x < 1 for x in mfus[g]):
            raise AssertionError(f"{name}: group {g} mfu {mfus[g]} not in (0, 1)")
    print(f"{name} perf ok: counted {[round(ev['flops'] / analytic, 4) for ev in events]} "
          f"of the analytic {analytic:.4g} FLOPs a step (flash kernels "
          f"{events[0]['kernel_flops']:.4g}); mfu per committed step {mfus}",
          flush=True)
    return {"events": events, "mfu": mfus, "analytic_flops": analytic}


# The bench at llama_small's full widths with its depth cut: the FT loops'
# shapes stay, their lengths shrink.
BENCH_ENV = {
    "BENCH_STEPS": "10", "BENCH_DDP_STEPS": "4", "BENCH_SYNC_EVERY": "32",
    "BENCH_FRAGMENTS": "2", "BENCH_DILOCO_SYNCS": "3",
}


# Phase 18a: the ledger the bench appends its round to, and the baselines
# the gate pins from it.
LEDGER = OUT / "ledger" / "BENCH_LEDGER_torch.jsonl"
BASELINES = OUT / "ledger" / "PERF_BASELINES_torch.json"


def bench_phase() -> dict:
    """Phase 18: ``python -m torchft_tpu_torch.bench`` in a process of its
    own at ``BENCH_ENV``'s depth, appending its round to ``LEDGER``
    (removed first). Raises unless it exits 0 with one JSON line meeting
    phase 18's checks (module docstring). Returns the line."""
    import torch

    out_dir = OUT / "bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    LEDGER.parent.mkdir(parents=True, exist_ok=True)
    LEDGER.unlink(missing_ok=True)
    env = {**os.environ, **BENCH_ENV, "PYTHONPATH": str(REPO),
           "TORCHFT_PERF_LEDGER": str(LEDGER)}
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "torchft_tpu_torch.bench"],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=600,
    )
    wall = time.monotonic() - t0
    (out_dir / "stdout.txt").write_text(proc.stdout)
    (out_dir / "stderr.txt").write_text(proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(
            f"bench exited {proc.returncode}: {proc.stderr[-2000:]}"
        )
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    if len(lines) != 1:
        raise AssertionError(f"bench printed {len(lines)} lines, not one")
    r = json.loads(lines[0])
    fails = []
    if not (math.isfinite(r["tokens_per_sec"]) and r["tokens_per_sec"] > 0):
        fails.append(f"tokens_per_sec {r['tokens_per_sec']}")
    for key in ("mfu_est", "mfu_est_interleaved"):
        if not (r.get(key) is not None and 0 < r[key] <= 1):
            fails.append(f"{key} {r.get(key)}")
    if r["device_kind"] != torch.cuda.get_device_name(0):
        fails.append(f"device_kind {r['device_kind']}")
    if r["metric"] != "diloco_ft_throughput_ratio_vs_nofault" or not (
        math.isfinite(r["value"]) and r["value"] > 0
    ):
        fails.append(f"headline {r['metric']} = {r['value']}")
    for key in ("ft_error", "degraded"):
        if key in r:
            fails.append(f"{key}: {r[key]}")
    if not r.get("ddp_ft_ms_per_step"):
        fails.append("no DDP leg")
    for key in ("heal_bench", "quorum_bench", "long_context"):
        if not isinstance(r.get(key), dict) or "error" in r[key]:
            fails.append(f"{key}: {r.get(key)}")
    if not (r.get("heal_bench") or {}).get("checksum_ok"):
        fails.append("heal_bench checksum")
    if abs(r["flops_counted"] / r["flops_per_step"] - 1) > FLOP_TOL:
        fails.append(
            f"flops_counted {r['flops_counted']:.4g} vs flops_per_step "
            f"{r['flops_per_step']:.4g}"
        )
    for kernel in FLASH_KERNELS + QUANT_KERNELS:
        if r["kernel_launches"][kernel] <= 0:
            fails.append(f"{kernel} never launched")
    if fails:
        raise AssertionError(f"bench: {'; '.join(fails)}")
    print(f"bench ok in {wall:.1f}s: raw {r['raw_ms_per_step']} ms/step, "
          f"{r['tokens_per_sec']} tokens/s, mfu_est {r['mfu_est']} "
          f"(interleaved {r['mfu_est_interleaved']}) "
          f"(counted/analytic FLOPs {r['flops_counted'] / r['flops_per_step']:.4f}); "
          f"long context {json.dumps(r['long_context'])}; DiLoCo "
          f"{r['diloco_ft_ms_per_step']} ms/step, ratio {r['value']} "
          f"{r.get('per_sync_ratios')}; DDP {r['ddp_ft_ms_per_step']} ms/step "
          f"parts {json.dumps(r.get('ddp_per_step_parts_ms'))} split "
          f"{r.get('ddp_split_compute_ms')} ms; heal {r['heal_bench']['gb_per_s']} "
          f"GB/s (raw TCP {r['heal_bench']['calibration']['raw_tcp_gb_per_s']} "
          f"GB/s, vs_raw_tcp {r['heal_bench']['vs_raw_tcp']}); quorum p50 "
          f"{r['quorum_bench']['p50_ms']} p95 {r['quorum_bench']['p95_ms']} ms; "
          f"launches {r['kernel_launches']}", flush=True)
    return {**r, "wall_s": wall}


# ---------------------------------------------------------------------------
# Phase 18a: the bench's round in the port's ledger, and the gate over it
# ---------------------------------------------------------------------------


def ledger_cli(module: str, *args) -> subprocess.CompletedProcess:
    """``python -m torchft_tpu_torch.<module> <args>``, a process of its own."""
    return subprocess.run(
        [sys.executable, "-m", f"torchft_tpu_torch.{module}", *args],
        cwd=str(REPO), env={**os.environ, "PYTHONPATH": str(REPO)},
        capture_output=True, text=True, timeout=120,
    )


def ledger_phase(bench: dict) -> dict:
    """Phase 18a, on the host only: ``perf_ledger --ledger LEDGER --check``
    must exit 0 over phase 18's round, whose records must all carry the
    ``gpu.`` prefix, family ``gpu`` and an ``env`` with this card's name and
    power limit (``card_line``), and include ``gpu.ddp.ms_per_step`` equal
    to the bench's ``ddp_ft_ms_per_step``. ``perf_gate --pin --check`` into
    ``BASELINES`` must exit 0 at the head. Planted regression: a
    ``gpu.ddp.ms_per_step`` record at twice the head's value appended, and
    ``perf_gate --check`` must exit 1 naming that metric. Prints one line;
    returns the records, the gate's summary and the planted line."""
    from torchft_tpu_torch import perf_ledger

    name, _, limit = (part.strip() for part in card_line().partition(","))
    ledger, baselines = str(LEDGER), str(BASELINES)
    check = ledger_cli("perf_ledger", "--ledger", ledger, "--check")
    if check.returncode != 0:
        raise AssertionError(f"perf_ledger --check exited {check.returncode}: "
                             f"{check.stdout}{check.stderr}")
    records = perf_ledger.load(ledger)
    wrong = [r["metric"] for r in records if not r["metric"].startswith("gpu.")
             or r["family"] != "gpu" or r["env"].get("card") != name
             or r["env"].get("card_power_limit") != limit]
    head = perf_ledger.head(records)
    ddp = head.get("gpu.ddp.ms_per_step", {}).get("value")
    if not records or wrong or ddp != float(bench["ddp_ft_ms_per_step"]):
        raise AssertionError(f"ledger {ledger}: records {wrong or len(records)} without "
                             f"gpu./gpu/{name}/{limit}, gpu.ddp.ms_per_step {ddp} vs the "
                             f"bench's {bench['ddp_ft_ms_per_step']}")
    BASELINES.unlink(missing_ok=True)
    gate = ledger_cli("perf_gate", "--ledger", ledger, "--baselines", baselines,
                      "--pin", "--check")
    summary = gate.stdout.strip().splitlines()[-1] if gate.stdout.strip() else ""
    if gate.returncode != 0 or not summary.startswith(f"perf gate: {len(head)} ok,"):
        raise AssertionError(f"perf_gate --pin --check exited {gate.returncode}: "
                             f"{gate.stdout}{gate.stderr}")
    perf_ledger.record("gpu.ddp.ms_per_step", 2 * ddp, "ms", "lower", "gpu",
                       "chip_smoke.py (planted regression)", path=ledger)
    planted = ledger_cli("perf_gate", "--ledger", ledger, "--baselines", baselines,
                         "--check")
    caught = [ln for ln in planted.stdout.splitlines()
              if ln.startswith("REGRESSION gpu.ddp.ms_per_step:")]
    if planted.returncode != 1 or not caught:
        raise AssertionError(f"the planted regression passed the gate (exit "
                             f"{planted.returncode}): {planted.stdout}{planted.stderr}")
    print(f"ledger: {len(records)} records of the bench's round in {LEDGER.name}, metrics "
          f"{sorted(head)}, family gpu, env card {name!r} power limit {limit!r}; "
          f"perf_ledger --check: {check.stdout.strip()}; perf_gate --pin --check: "
          f"{summary}; planted regression (gpu.ddp.ms_per_step at 2x, {2 * ddp:g} ms): "
          f"exit 1, {caught[0]}", flush=True)
    return {"records": records, "summary": summary, "planted": caught[0]}


# ---------------------------------------------------------------------------
# Phase 19: the orchestration path
# ---------------------------------------------------------------------------


def orchestration_phase(path: dict) -> dict:
    """Phase 19: ``drill.runner_kill_heal_drill`` over the flash drill's
    arguments with ``TORCHFT_PG=native`` in both groups (the C++ engine is
    their replica-axis data plane): the C++ lighthouse, two groups rendered
    by ``orchestration.render_topology`` and kept alive by
    ``orchestration.ReplicaGroupRunner``. Group 1 is killed through the
    lighthouse after its step 3 (the runner SIGKILLs it if the trainer
    outlives its manager server) and must be relaunched by the runner once.
    Raises unless both groups end at step 8 in ``MESH_FREE_FLASH_SHA`` (the
    engine's fp32 ring gives the socket ring's bits) with finite losses,
    the runner's restarts are ``{0: 0, 1: 1}``, its journal holds one
    ``proc_death`` (group 1's), both groups launched every flash kernel,
    the groups' journals hold ``pg_collective`` allreduce rows of backend
    ``torchft-native`` and no other backend, and ``drill.kill_episode``
    finds the kill one recovery episode with group 1 its primary, whose
    phases tile its time to recover. With ``drill.FAULT_PLANES_ENV`` in
    both groups, ``drill.fault_planes`` must hold the stripe failover, the
    goodput ledger and the fleet digests (module docstring), and a planted
    all-stripes reset (``planted_stripe_kill``) must be refused. The port's
    exporter and dashboard watch the drill (``exporter``), and
    ``fleet_views_reading`` must hold. Prints the time to recover, its
    phases, each group's median allreduce beside phase 6's (``path``, the
    socket ring), one line for each plane and view and the phase's wall.
    Returns the drill's output with the episode, the planes and the fleet
    views."""
    import shutil

    from torchft_tpu_torch.drill import (
        FAULT_PLANES_ENV,
        fault_planes,
        kill_episode,
        runner_kill_heal_drill,
    )
    from torchft_tpu_torch.telemetry import load_journal

    name = "orchestration path"
    t_phase = time.monotonic()
    planted = planted_stripe_kill()
    result_dir = OUT / name
    shutil.rmtree(result_dir, ignore_errors=True)
    out = runner_kill_heal_drill(
        PATH_ARGS, str(result_dir), str(result_dir / "logs"), env=FAULT_PLANES_ENV,
        exporter=True,
    )
    if out["restarts"] != {0: 0, 1: 1}:
        raise AssertionError(f"{name}: runner restarts {out['restarts']}")
    deaths = [d["subject"] for d in out["proc_deaths"]]
    if deaths != ["replica1/rank0"]:
        raise AssertionError(f"{name}: proc_death events for {deaths}")
    for g, r in out["results"].items():
        if r["final_step"] != 8 or r["param_sha256"] != MESH_FREE_FLASH_SHA:
            raise AssertionError(
                f"{name}: group {g} ended at step {r['final_step']} in "
                f"{r['param_sha256']}, not in {MESH_FREE_FLASH_SHA}"
            )
        if not r["losses"] or not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"{name}: group {g} losses {r['losses']}")
        for kernel in FLASH_KERNELS:
            if r["kernel_launches"][kernel] <= 0:
                raise AssertionError(f"{name}: group {g} never launched {kernel}")
        print(f"{name} group {g}: final_step {r['final_step']} launches "
              f"{r['kernel_launches']} median step {r['median_step_ms']:.1f} ms "
              f"(phase 6, socket, beside other drills: "
              f"{path[g]['median_step_ms']:.1f} ms), median "
              f"allreduce native {r['median_phase_ms']['allreduce']:.1f} ms "
              f"(phase 6: {path[g]['median_phase_ms']['allreduce']:.1f} ms)",
              flush=True)
    events = load_journal([out["journal_dir"]])
    rows = [e["attrs"] for e in events if e["event"] == "pg_collective"]
    backends = {r["backend"] for r in rows}
    # The engine's own flight records: the collectives its ring carried
    # (a dtype outside its set would fall back to the Python ring).
    engine_ops = {}
    for e in events:
        if e["event"] == "native_collective" and e["attrs"]["status"] == "ok":
            engine_ops[e["attrs"]["op"]] = engine_ops.get(e["attrs"]["op"], 0) + 1
    if backends != {"torchft-native"} or not engine_ops.get("allreduce"):
        raise AssertionError(
            f"{name}: pg_collective backends {backends}, engine records "
            f"{engine_ops}: the engine did not carry the gradient allreduce"
        )
    episode = kill_episode(out["journal_dir"], 1)
    out["episode"] = episode
    row = episode["replicas"]["1"]
    # The detector dates the episode from its first journal evidence; a
    # kill between two collectives leaves the survivor none, so the wall
    # from the kill to the healed commit prints beside it.
    print(f"{name} episode {episode['id']}: root cause "
          f"{episode['root_cause']['kind']}, time to recover "
          f"{episode['ttr_s']:.3f} s (group 1's row {row['ttr_s']:.3f} s: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in row["phases"].items())
          + f"; survivors' rows {sorted(set(episode['replicas']) - {'1'})}), "
          f"kill to the healed commit {episode['t_end'] - out['kill_ts']:.3f} s, "
          f"{len(rows)} pg_collective rows of torchft-native, engine records "
          f"{engine_ops}", flush=True)
    planes = fault_planes(out)
    out["planes"] = planes
    print(f"{name} stripe_failover: {FAULT_PLANES_ENV['TORCHFT_LINKS']}, "
          f"{FAULT_PLANES_ENV['TORCHFT_CHAOS']}: handoffs on both ends at step(s) "
          f"{planes['failover_steps']}, committed by both groups; rows "
          + "; ".join(
              f"group {g}: " + ", ".join(
                  f"{f['dir']} s{f['stripe']}->s{f['to_stripe']} {f['tag']} {f['nbytes']} B"
                  for f in rows)
              for g, rows in sorted(planes["failovers"].items())),
          flush=True)
    print(f"{name} goodput ledger (goodput_window events, telemetry.audit_goodput): "
          + "; ".join(
              f"group {g}: {row['incarnations']} incarnation(s), {row['windows']} "
              f"windows, accounted {row['accounted_s']:.6f} s, "
              + ", ".join(f"{k} {v:.6f}" for k, v in row["badput_s"].items() if v)
              for g, row in sorted(planes["goodput"].items()))
          + ": every window and incarnation tiles within 1e-6 s", flush=True)
    print(f"{name} fleet digests at the lighthouse: "
          + "; ".join(
              f"group {g} ({out['fleet'][g]['replica_id']}): step {d['step']}, rate "
              f"{d['rate']} steps/s, gp {d.get('gp')}, chaos {d.get('chaos', 0)}"
              for g, d in sorted(planes["fleet"].items())), flush=True)
    out["fleet_views"] = fleet_views_reading(name, out)
    out["digest_rates"] = digest_rate_reading(name, out)
    print(f"{name} planted fault {planted['spec']}: {planted['errors']} rank(s) failed "
          f"their allreduce, latched {planted['latched']}, {planted['failovers']} "
          f"handoffs: the failover check refused it ({planted['refused']})", flush=True)
    print(f"{name} ok: both groups in MESH_FREE_FLASH_SHA, killed by the "
          f"{out['kill']} (kill_via_lighthouse, then runner.kill_group(1) "
          f"if the trainer outlived its manager server), kill to relaunch "
          f"{out['kill_to_relaunch_s']:.2f}s, drill wall {out['wall_s']:.1f}s, "
          f"restarts {out['restarts']}, restart log {out['restart_log']}, "
          f"phase wall {time.monotonic() - t_phase:.1f}s", flush=True)
    return out


# The planted fault of phase 19: every stripe of the collective reset, so no
# leg is left to take a range over (tests/test_wan.py's all-stripes case).
ALL_STRIPES_RESET = "seed:7,spec:reset@data:match=c1"


def stripe_failover_check(out: dict) -> None:
    """Phase 19's contract for one collective under a stripe reset: every
    rank completed it with the unfaulted bits, no group latched an error,
    and at least one range was handed to a live stripe."""
    if out["errors"] or not out["bitwise"] or out["latched"] or not out["failovers"]:
        raise AssertionError(f"stripe failover: {out}")


def planted_stripe_kill() -> dict:
    """Two ``ProcessGroupNative`` ranks of this process over loopback, four
    stripes a link, one 4 MiB fp32 allreduce under ``ALL_STRIPES_RESET``:
    the collective must fail and latch, and ``stripe_failover_check`` must
    refuse the outcome. Returns the outcome."""
    import threading

    import numpy as np

    from torchft_tpu_torch import _native
    from torchft_tpu_torch.drill import STRIPED_LINKS
    from torchft_tpu_torch.process_group import ProcessGroupNative, ReduceOp
    from torchft_tpu_torch.store import TCPStoreServer

    saved = os.environ.get("TORCHFT_LINKS")
    os.environ["TORCHFT_LINKS"] = STRIPED_LINKS
    store = TCPStoreServer()
    groups = [ProcessGroupNative(timeout=20.0) for _ in range(2)]
    n = 1 << 20
    arrs = [np.arange(n, dtype=np.float32) + r for r in range(2)]
    errors = [None, None]

    def run(r, fn):
        try:
            fn(r)
        except Exception as e:  # noqa: BLE001 - the outcome under test
            errors[r] = e

    def parallel(fn):
        threads = [threading.Thread(target=run, args=(r, fn)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)

    try:
        parallel(lambda r: groups[r].configure(f"{store.address()}/planted", r, 2))
        if any(errors):
            raise AssertionError(f"planted stripe kill: configure failed: {errors}")
        _native.chaos_init(ALL_STRIPES_RESET)
        parallel(lambda r: groups[r].allreduce(arrs[r], ReduceOp.SUM).wait(timeout=30))
        want = np.arange(n, dtype=np.float32) * 2 + 1
        out = {
            "spec": ALL_STRIPES_RESET,
            "errors": sum(e is not None for e in errors),
            "bitwise": all(a.tobytes() == want.tobytes() for a in arrs),
            "latched": any(g.errored() is not None for g in groups),
            "failovers": sum(
                len(g._engine.fr_snapshot(0).get("failovers", [])) for g in groups
            ),
        }
    finally:
        _native.chaos_init(" ")
        for g in groups:
            g.shutdown()
        store.shutdown()
        if saved is None:
            os.environ.pop("TORCHFT_LINKS", None)
        else:
            os.environ["TORCHFT_LINKS"] = saved
    try:
        stripe_failover_check(out)
    except AssertionError as e:
        out["refused"] = str(e)
    else:
        raise AssertionError(f"phase 19: the planted all-stripes kill passed the "
                             f"failover check: {out}")
    if not out["errors"] or not out["latched"]:
        raise AssertionError(f"phase 19: the planted all-stripes kill did not abort "
                             f"and latch: {out}")
    return out


# ---------------------------------------------------------------------------
# The fleet views: the port's exporter and dashboard (phases 16a and 19)
# ---------------------------------------------------------------------------

def frame_bw(frame: str) -> dict:
    """{group: its row's ``BWmin`` cell} of an ``obs_top`` frame."""
    from torchft_tpu_torch.drill import frame_rows

    col = frame.splitlines()[1].split().index("BWmin")
    return {g: row.split()[col] for g, row in frame_rows(frame).items()}


def planted_frame_fault(label: str, fleet: dict, frame: str, broken: str, want: str) -> str:
    """The port's ``check_frame`` on ``broken``, a copy of the live ``frame``
    with a planted fault: raises unless it reports the problem ``want``,
    which the live frame does not have. Returns the problem."""
    from torchft_tpu_torch.obs_top import check_frame

    if want in check_frame(fleet, frame):
        raise AssertionError(f"{label}: the live frame already has {want!r}")
    if broken == frame or want not in check_frame(fleet, broken):
        raise AssertionError(f"{label}: the planted frame fault passed check_frame "
                             f"({check_frame(fleet, broken)}); want {want!r}")
    return want


def native_peer_gauges(label: str, journal) -> dict:
    """``python -m torchft_tpu_torch.obs_export --once --journal <journal>``
    over an engine drill's journal. Raises unless it exits 0 with a
    ``torchft_exporter_native_peer_gib_s`` line for both groups in both
    directions, each equal to ``bytes / 2**30 / (busy_ns / n_streams /
    1e9)`` (to the exporter's 4 places) recomputed here from the last
    ``native_counters`` event of each replica in the same journal, with
    ``drill.STRIPED_LINKS``' streams. Returns {(replica, peer, dir): GiB/s}."""
    from torchft_tpu_torch.drill import STRIPED_LINKS
    from torchft_tpu_torch.telemetry import _replica_key, load_journal

    streams = int(re.search(r"streams=(\d+)", STRIPED_LINKS).group(1))

    proc = journal_report("obs_export", "--once", "--journal", journal)
    if proc.returncode != 0:
        raise AssertionError(f"{label}: obs_export --once --journal exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    line = re.compile(r'torchft_exporter_native_peer_gib_s\{replica="([^"]*)",'
                      r'peer="([^"]*)",dir="(tx|rx)"\} (\S+)')
    got = {m.groups()[:3]: m.group(4) for m in map(line.fullmatch, proc.stdout.splitlines())
           if m}
    last = {}
    for e in load_journal([str(journal)]):
        if e["event"] == "native_counters":
            last[_replica_key(e)] = e["attrs"]
    want = {}
    for rid, c in last.items():
        if c["n_streams"] != streams:
            raise AssertionError(f"{label}: replica {rid} ran {c['n_streams']} streams")
        for peer in c["peers"]:
            for d in ("tx", "rx"):
                busy = peer[f"{d}_busy_ns"] / c["n_streams"] / 1e9
                want[(rid, str(peer["peer"]), d)] = (
                    f"{peer[f'{d}_bytes'] / 2**30 / busy:.4f}" if busy > 0 else None)
    pairs = sorted((rid, d) for rid, _, d in got)
    if got != want or pairs != [("0", "rx"), ("0", "tx"), ("1", "rx"), ("1", "tx")]:
        raise AssertionError(f"{label}: the exporter's per-peer GiB/s {got}, recomputed "
                             f"from the last native_counters {want}")
    return {k: float(v) for k, v in got.items()}


def fleet_views_reading(label: str, out: dict) -> dict:
    """Phase 19's exporter and dashboard (``runner_kill_heal_drill`` with
    ``exporter``). Raises unless the exporter exited 0 on SIGINT after at
    least 10 scrapes, its journaled ``quorum_id`` never fell, its last
    sample counts a leave and a join (group 1's killed id, its relaunch's
    fresh id), ``obs_top --once --check`` exited 0 with a row for each
    group whose ``BWmin`` is a number (the engine's digests carry ``bw``),
    the live ``/metrics`` body has the exporter up, two fleet replicas and
    a step rate for each group, and ``native_peer_gauges`` holds over the
    groups' journal. Planted fault: ``check_frame`` on the frame with
    group 1's row removed must report it missing. Prints one line each;
    returns the readings."""
    from torchft_tpu_torch.drill import frame_rows

    ex = out["exporter"]
    ids = ex["quorum_ids"]
    if ex["rc"] != 0 or ex["scrapes"] < 10:
        raise AssertionError(f"{label}: the exporter exited {ex['rc']} after "
                             f"{ex['scrapes']} scrapes; see {ex['journal']}")
    if any(b < a for a, b in zip(ids, ids[1:])):
        raise AssertionError(f"{label}: the exporter's quorum ids fell: {ids}")
    if not (ex["leaves_total"] >= 1 and ex["joins_total"] >= 1):
        raise AssertionError(f"{label}: the exporter's last sample has joins "
                             f"{ex['joins_total']}, leaves {ex['leaves_total']}")
    bw = frame_bw(ex.get("frame", "")) if ex.get("frame") else {}
    if ex.get("obs_top_rc") != 0 or sorted(bw) != [0, 1] or not all(
            re.fullmatch(r"\d+\.\d\d", v) for v in bw.values()):
        raise AssertionError(f"{label}: obs_top --once --check exited "
                             f"{ex.get('obs_top_rc')}, BWmin cells {bw}:\n{ex.get('frame')}"
                             f"{ex.get('obs_top_stderr')}")
    body = ex.get("metrics", "").splitlines()
    rates = {g: [ln for ln in body if ln.startswith(
        f'torchft_exporter_replica_step_rate{{job="default",replica="{g}:')] for g in (0, 1)}
    if "torchft_exporter_up 1" not in body or (
            'torchft_exporter_fleet_replicas{job="default"} 2' not in body) or not all(
            rates.values()):
        raise AssertionError(f"{label}: the live /metrics body:\n{ex.get('metrics')}")
    gib_s = native_peer_gauges(label, out["journal_dir"])
    row = frame_rows(ex["frame"])[1]
    victim = next(rid for rid in ex["fleet"]["replicas"] if rid.startswith("1:"))
    planted_frame_fault(
        label, ex["fleet"], ex["frame"],
        "\n".join(ln for ln in ex["frame"].splitlines() if ln != row) + "\n",
        f"replica {victim!r} missing from rendered frame")
    print(f"{label} exporter: exit {ex['rc']} on SIGINT after {ex['scrapes']} scrapes "
          f"every 0.5 s; journaled quorum ids {sorted(set(ids))} (never falling), last "
          f"sample joins_total {ex['joins_total']}, leaves_total {ex['leaves_total']}",
          flush=True)
    print(f"{label} obs_top --once --check: exit {ex['obs_top_rc']}, BWmin "
          + ", ".join(f"group {g} {v} GiB/s" for g, v in sorted(bw.items()))
          + "; /metrics: up 1, fleet_replicas 2, step rate "
          + "; ".join(rates[g][0] for g in (0, 1)) + f"; planted fault (group 1's row "
          f"removed) caught", flush=True)
    print(f"{label} exporter --once --journal, per-peer GiB/s (bytes / (busy_ns / "
          f"n_streams), each direction, the incarnation's last native_counters): "
          + ", ".join(f"group {r} peer {p} {d} {v}" for (r, p, d), v in sorted(gib_s.items()))
          + "; equal to the journal's counters", flush=True)
    return {"bw": bw, "gib_s": gib_s, "quorum_ids": sorted(set(ids)),
            "joins_total": ex["joins_total"], "leaves_total": ex["leaves_total"],
            "scrapes": ex["scrapes"]}


def bandwidth_line(views: dict, lanes: dict) -> None:
    """Prints phase 19's engine bandwidth three ways, each group's
    ``obs_top`` ``BWmin`` (``views``: ``fleet_views_reading``'s) beside the
    exporter's per-peer GiB/s and phase 19a's bounding lane (``lanes``:
    ``obs_report``'s ``native_stall_attribution``), with each one's
    normalisation."""
    print("phase 19's bandwidth, three normalisations: "
          + "; ".join(
              f"group {g}: obs_top BWmin {views['bw'][g]} GiB/s (the digest's worst peer, "
              "tx+rx bytes over tx+rx busy_ns / streams, live), exporter "
              + ", ".join(f"{d} {v:.4f}" for (r, _, d), v in sorted(views["gib_s"].items())
                          if r == str(g))
              + " GiB/s (each direction's bytes over its busy_ns / streams, whole "
              f"incarnation), 19a's bounding lane peer {lanes[str(g)]['peer']} stripe "
              f"{lanes[str(g)]['stripe']} {lanes[str(g)]['dir']} "
              f"{lanes[str(g)]['gib_s']} GiB/s (the slowest lane's bytes over its windows, "
              "summed over the collectives it bounded)"
              for g in (0, 1)), flush=True)


# Phase 19's digest step rates against the journal: each reading must lie
# within this band of the rate of the gates it covers.
DIGEST_RATE_BAND = (0.5, 2.0)
# The reference formula's span for a window of one gate: the time from the
# gate to the digest's push, 0.38 ms on the card (a live /metrics under that
# formula read 2631 steps/s). Its one-gate value is the planted fault.
REFERENCE_PUSH_LAG_S = 0.38e-3
# A /metrics body holds a digest pushed at a gate that ended at most this
# long before the body was fetched: the exporter's 0.5 s scrape, the 0.1 s
# heartbeat and the sampler's 0.25 s poll, with room.
METRICS_LAG_S = 1.5


def gate_windows(journal_dir, replica_id: str) -> list:
    """The digest windows of one incarnation (``replica_id``), read off its
    journal's ``goodput_window`` events at its commit gates (the drain's
    window is no gate). The incarnation's first gate has no gate-to-gate
    time, so the Manager notes it in no window; for each later gate, the
    gates noted in the 60 s up to it (``DigestWindow``'s default), with
    ``end_ts``, ``n`` gates, ``committed``, ``seconds`` (their gate-to-gate
    seconds, heal excluded, as the Manager counts them), the ``rate``
    (committed over seconds), ``gp`` and the last committed ``step``."""
    from torchft_tpu_torch.telemetry import load_journal

    gates = [
        (e["ts"], e.get("step"), bool(e["attrs"]["committed"]),
         max(float(e["attrs"]["dur_s"]) - float(e["attrs"]["splits"].get("heal", 0.0)), 0.0))
        for e in load_journal(sorted(str(f) for f in Path(journal_dir).glob(
            "journal_replica*.jsonl")))
        if e["event"] == "goodput_window" and e.get("replica_id") == replica_id
        and e["attrs"].get("residual") != "drain"
    ][1:]
    out, last_step = [], 0
    for k, (ts, step, committed, _) in enumerate(gates):
        if committed:
            last_step = max(last_step, int(step))
        window = [g for g in gates[:k + 1] if g[0] >= ts - 60.0]
        seconds = sum(g[3] for g in window)
        good = sum(g[3] for g in window if g[2])
        n_committed = sum(1 for g in window if g[2])
        out.append({"end_ts": ts, "oldest_ts": window[0][0], "n": len(window),
                    "committed": n_committed,
                    "seconds": seconds, "rate": n_committed / seconds if seconds else 0.0,
                    "gp": good / seconds if seconds else 0.0, "step": last_step})
    return out


def rate_holds(rate: float, window: dict) -> bool:
    lo, hi = DIGEST_RATE_BAND
    return lo * window["rate"] <= rate <= hi * window["rate"]


def digest_rate_reading(label: str, out: dict) -> dict:
    """Holds phase 19's digest step rates to the journal. Each group's
    digest at the lighthouse (``out["fleet"]``, with its ``step`` and
    ``gp``) and each replica's ``/metrics`` step rate (the exporter's body,
    fetched at ``metrics_ts``) must lie within ``DIGEST_RATE_BAND`` of the
    committed steps over the gate-to-gate seconds of the gates it covers
    (``gate_windows`` of its incarnation). A digest's window is the one
    with its last committed step whose goodput is nearest its ``gp``. A
    ``/metrics`` gauge carries no step: its window is the nearest in rate
    of those that ended in the ``METRICS_LAG_S`` before the fetch and the
    last before them. Planted fault: the reference's formula on each
    group's first window with a commit (one gate in these drills: its
    committed gates over ``REFERENCE_PUSH_LAG_S``) must fall outside the
    band. Prints one line; returns the readings."""
    journal_dir = out["journal_dir"]
    rows, readings = [], {}
    for g, row in sorted(out["fleet"].items()):
        digest = row["digest"]
        wins = [w for w in gate_windows(journal_dir, row["replica_id"])
                if w["step"] == digest["step"]]
        if not wins:
            raise AssertionError(f"{label}: no gate of {row['replica_id']} in its "
                                 f"journal ends at the digest's step {digest['step']}")
        win = min(wins, key=lambda w: abs(w["gp"] - float(digest.get("gp", 1.0))))
        readings[f"digest {g}"] = (digest["rate"], win)
    ex = out["exporter"]
    for rid, value in re.findall(
            r'torchft_exporter_replica_step_rate\{job="default",replica="([^"]+)"\} (\S+)',
            ex["metrics"]):
        wins = gate_windows(journal_dir, rid)
        recent = [w for w in wins if ex["metrics_ts"] - METRICS_LAG_S < w["end_ts"]
                  <= ex["metrics_ts"]]
        earlier = [w for w in wins if w["end_ts"] <= ex["metrics_ts"] - METRICS_LAG_S]
        cands = recent + earlier[-1:]
        if not cands:
            raise AssertionError(f"{label}: no gate of {rid} in its journal before "
                                 f"the /metrics body")
        rate = float(value)
        win = min(cands, key=lambda w: abs(math.log(max(rate, 1e-9) / max(w["rate"], 1e-9))))
        readings[f"/metrics {rid.split(':', 1)[0]}"] = (rate, win)
    for name, (rate, win) in readings.items():
        rows.append(f"{name} {rate:.6g} steps/s against the journal's {win['committed']} "
                    f"committed of {win['n']} gate(s) over {win['seconds']:.3f} s, "
                    f"{win['rate']:.6g} steps/s (to step {win['step']})")
        if not rate_holds(rate, win):
            raise AssertionError(f"{label}: {rows[-1]}: outside {DIGEST_RATE_BAND}x")
    planted = []
    for g, row in sorted(out["fleet"].items()):
        first = next(w for w in gate_windows(journal_dir, row["replica_id"]) if w["committed"])
        # The reference's span: from the oldest gate's end to the push.
        ref = first["committed"] / (first["end_ts"] - first["oldest_ts"] + REFERENCE_PUSH_LAG_S)
        if rate_holds(ref, first):
            raise AssertionError(f"{label}: the reference formula's one-gate value "
                                 f"{ref:.6g} steps/s passed against {first}")
        planted.append(f"group {g} {ref:.6g} against {first['rate']:.6g}")
    print(f"{label} digest step rates held to the journal within {DIGEST_RATE_BAND}x: "
          + "; ".join(rows) + "; planted fault (the reference formula's one-gate "
          f"value, committed gates over {REFERENCE_PUSH_LAG_S * 1e3:.2f} ms): "
          + ", ".join(planted) + " steps/s refused", flush=True)
    return {name: {"rate": rate, **win} for name, (rate, win) in readings.items()}


def fleet_plane_phase() -> dict:
    """Phase 16a: ``drill.fleet_plane_drill`` on the card (its own checks
    raise), then two planted faults: the port's ``check_frame`` on the
    live frame with group 1's ``STRAGGLER`` tag removed, and the drill's
    gauge check (``drill.fleet_gauges_hold``) on ``render_fleet_prometheus``
    of the live fleet with group 1's ``hb_jitter`` flag removed, must both
    fail. Prints the seconds from the start to the straggler flag and its
    flags, the anomalies journaled, the exporter's scrapes and the drill's
    wall. Returns the drill's output."""
    import copy
    import shutil

    from torchft_tpu_torch.drill import fleet_gauges_hold, fleet_plane_drill, frame_rows
    from torchft_tpu_torch.obs_export import render_fleet_prometheus

    name = "fleet plane"
    work = OUT / name
    shutil.rmtree(work, ignore_errors=True)
    out = fleet_plane_drill(str(work), device="cuda")
    rid = out["straggler"]["replica_id"]
    row = frame_rows(out["frame"])[1]
    planted_frame_fault(name, out["fleet"], out["frame"],
                        out["frame"].replace(row, row.replace("STRAGGLER ", "")),
                        f"replica {rid!r} is a straggler but its row has no STRAGGLER tag")
    up = "torchft_exporter_up 1\n"
    if not fleet_gauges_hold(render_fleet_prometheus(out["fleet"]) + up, rid):
        raise AssertionError(f"{name}: the gauge check fails on the live fleet")
    unflagged = copy.deepcopy(out["fleet"])
    unflagged["replicas"][rid]["flags"].remove("hb_jitter")
    if fleet_gauges_hold(render_fleet_prometheus(unflagged) + up, rid):
        raise AssertionError(f"{name}: the gauge check passed a fleet without "
                             f"{rid}'s hb_jitter flag")
    print(f"{name}: group 1 ({rid}) flagged a straggler online at "
          f"+{out['straggler']['t_s']:.3f} s with flags {out['straggler']['flags']}; "
          f"obs_top --once --check exit {out['obs_top_rc']}; /metrics up 1, one "
          f"straggler, hb_jitter gauge; the exporter exited {out['exporter_rc']} on "
          f"SIGINT with {out['status_events']} lighthouse_status events "
          f"({out['scrapes_seen']} seen live) and anomalies {out['anomalies']}; planted "
          f"faults (the STRAGGLER tag, the hb_jitter flag) caught; drill wall "
          f"{out['wall_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 16b: the departure drills (python -m torchft_tpu_torch.drills)
# ---------------------------------------------------------------------------

# BASELINE config #3 at its published widths (phase 11's workload) on the
# int4 wire without error feedback: the gradients, and a spare's or a
# healing group's zeros, take the device path through kernels 7 and 8.
# (With error feedback every bucket takes the host quantizer.)
DEPARTURE_RESNET = [
    "--model", "resnet50", "--image-size", "224", "--num-classes", "1000",
    "--batch-size", "32", "--quantize", "--quantize-bits", "4",
]
# Each drill's arguments (``python -m torchft_tpu_torch.drills <drill>``)
# and whether it runs ResNet-50 (``DEPARTURE_RESNET``) in place of the JAX
# drills' cnn. Cuts from the JAX defaults: the spare drill 2000 -> 100
# ResNet-50 steps (its kill at step 15 leaves a runway of 85 steps, ~40 s,
# for the victim's relaunch), the heal storm 100 -> 30 steps, the soak 4 ->
# 2 kills; elastic-up runs 2400 cnn steps, up from 1200, so that the run
# outlives the joiner's start on the card beside the other lanes.
# model-heal runs ulysses only: phases 13 and 14 run moe and pipeline on
# the same int4 device wire (with the HTTP heal; the pg-sharded heal runs
# in phase 15).
DEPARTURES = {
    "spare-failover": (["--steps", "100"], True),
    "heal-storm": (["--steps", "30"], True),
    "model-heal": (["--model", "ulysses", "--steps", "30"], False),
    "drain": (["--steps", "60"], False),
    "elastic-up": (["--steps", "2400"], False),
    "elastic-down": (["--steps", "120"], False),
    "preempt-all": (["--steps", "60", "--via", "operator"], False),
    "soak": (["--steps", "100", "--kills", "2"], False),
}
# The drills whose trainers launch kernels 7 and 8 (the int4 device wire).
DEVICE_WIRE_DRILLS = ("spare-failover", "heal-storm", "model-heal")
# Before a ResNet-50 drill starts, the card's memory in use (every
# process's) must fall to this many GiB: its two or three groups take up
# to ~18 GiB (phase 16b alone: 18.02 GiB at most), and the other lanes'
# llama_small drills up to ~66 GiB while they overlap, against the 76 GiB
# the whole run must stay under. Waits at most DEPARTURE_WAIT_S, then runs.
DEPARTURE_CARD_GIB = 50.0
DEPARTURE_WAIT_S = 240.0


def wait_for_card_memory(limit_gib: float, timeout_s: float) -> float:
    """Waits, reading once a second, until the card's memory in use is at
    most ``limit_gib``, or ``timeout_s`` passed; returns the seconds
    waited."""
    import torch

    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        free, total = torch.cuda.mem_get_info()
        if (total - free) / 2**30 <= limit_gib:
            break
        time.sleep(1.0)
    return time.monotonic() - t0


def card_peak_gib(t0: float, t1: float):
    """The most card memory in use (every process's) that the host watch
    read between the epoch seconds ``t0`` and ``t1``; None without a
    watch."""
    if HOST_WATCH is None:
        return None
    used = [h["card_used_gib"] for ts, h in list(HOST_WATCH.readings)
            if t0 <= ts <= t1 and "card_used_gib" in h]
    return max(used) if used else None


def departure(drill: str) -> dict:
    """One departure drill on the card (``drills.run``: its verdicts by
    ``drills.check_report``, which raises with the report on a failure),
    its directory under ``OUT/departures/<drill>``. Then
    ``drills.planted`` of its report must be refused. For the drills on the
    device wire, kernels 7 and 8 must have launched in every group's last
    incarnation and no attention kernel in a DDP drill. Prints the wall, the
    restarts, the heal receives' bytes, each group's kernel 7 / 8 launches
    and the card's peak memory meanwhile; returns {"report", "launches"
    (summed over the groups), "wall_s"}."""
    import shutil

    from torchft_tpu_torch import drills

    argv, full_width = DEPARTURES[drill]
    work = OUT / "departures" / drill
    shutil.rmtree(work, ignore_errors=True)
    args = drills.parse_args([drill, *argv, "--device", "cuda"])
    args.workdir = str(work)
    waited = 0.0
    if full_width:
        args.ddp_args = DEPARTURE_RESNET
        waited = wait_for_card_memory(DEPARTURE_CARD_GIB, DEPARTURE_WAIT_S)
    t0 = time.time()
    try:
        report = drills.run(args)
    except drills.DrillFailed as e:
        raise AssertionError(f"departure {drill}: {e.reasons}; report "
                             f"{json.dumps(e.report)}") from None
    t1 = time.time()
    try:
        drills.check_report(drill, drills.planted(drill, report))
    except AssertionError:
        pass
    else:
        raise AssertionError(f"departure {drill}: its planted fault passed check_report")
    results = {f.relative_to(work).as_posix(): json.loads(f.read_text())
               for f in sorted(work.glob("*/results/**/group*.json"))}
    launches = {name.split("/results/")[-1]: {k: r["kernel_launches"][k] for k in QUANT_KERNELS}
                for name, r in results.items()}
    if drill in DEVICE_WIRE_DRILLS:
        for name, r in results.items():
            for k in QUANT_KERNELS:
                if r["kernel_launches"][k] <= 0:
                    raise AssertionError(f"departure {drill}: {name} never launched {k}")
            if full_width and r["device"] != "cuda:0":
                raise AssertionError(f"departure {drill}: {name} ran on {r['device']}")
            for k in FLASH_KERNELS + BLOCK_KERNELS:
                if full_width and r["kernel_launches"][k] != 0:
                    raise AssertionError(f"departure {drill}: {name} launched {k}")
    heals = [
        e["attrs"]["nbytes"]
        for f in sorted(work.glob("*/journal/journal_replica*.jsonl"))
        for e in map(json.loads, f.read_text().splitlines())
        if e["event"] == "heal_xfer" and e["attrs"]["dir"] == "recv" and e["step"] > 0
    ]
    peak = card_peak_gib(t0, t1)
    verdicts = {k: v for k, v in report.items()
                if k not in ("drill", "wall_s", "journal_dir", "restarts")}
    model = ("ResNet-50" if full_width
             else "llama_debug" if drill == "model-heal" else "cnn")
    line = (f"departure {drill} ok ({model}"
            f"{', kernels 7-8' if drill in DEVICE_WIRE_DRILLS else ''}): wall "
            f"{t1 - t0:.1f} s (after {waited:.1f} s waiting for the card's memory); "
            f"restarts {report.get('restarts')}; heal receives (B) {heals}; kernel 7 / 8 "
            f"launches {json.dumps(launches) if drill in DEVICE_WIRE_DRILLS else 'none (host wire)'}; "
            f"card memory in use at most {peak} GiB meanwhile; planted fault refused; "
            + json.dumps(verdicts))
    print(line, flush=True)
    out = {
        "report": report,
        "launches": {k: sum(v[k] for v in launches.values())
                     if drill in DEVICE_WIRE_DRILLS else 0 for k in QUANT_KERNELS},
        "group_launches": launches,
        "heals": heals,
        "wall_s": t1 - t0,
        "waited_s": waited,
        "card_peak_gib": peak,
        "line": line,
    }
    (OUT / "departures" / f"{drill}.json").write_text(json.dumps(out, default=str))
    return out


def departures(names) -> dict:
    """Phase 16b's drills ``names``, in turn: {drill: ``departure``'s
    result (also in ``OUT/departures/<drill>.json``)}, and the kernel 7 / 8
    launches summed under ``"launches"``."""
    out = {name: departure(name) for name in names}
    out["launches"] = {k: sum(out[n]["launches"][k] for n in names)
                       for k in QUANT_KERNELS}
    return out


def departures_cnn_phase() -> dict:
    """Phase 16b's first lane: cnn drills at the JAX drills' own
    configuration on ``cuda``."""
    return departures(("elastic-down", "preempt-all", "soak", "elastic-up"))


def departures_device_phase() -> dict:
    """Phase 16b's second lane: the cnn drain and Ulysses' model-heal first
    (the three llama_small drills that open the other lanes hold up to ~68
    GiB of the card for their first ~110 s), then ResNet-50's spare failover
    and heal storm at its published widths, each once the card's memory
    allows (``wait_for_card_memory``)."""
    return departures(("drain", "model-heal", "spare-failover", "heal-storm"))


# ---------------------------------------------------------------------------
# Phase 19a: the port's journal reports over phases 6, 15 and 19's journals
# ---------------------------------------------------------------------------

def journal_report(module: str, *args) -> subprocess.CompletedProcess:
    """``python -m torchft_tpu_torch.<module> <args>`` from the repo's root."""
    return subprocess.run(
        [sys.executable, "-m", f"torchft_tpu_torch.{module}", *map(str, args)],
        cwd=str(REPO), env={**os.environ, "PYTHONPATH": str(REPO)},
        capture_output=True, text=True, timeout=120,
    )


def json_report(module: str, *args) -> dict:
    """The report ``module`` over ``args`` with ``--json``. Raises unless it
    exits 0 and, with ``--check`` in ``args``, prints its ``check OK`` line
    last; returns its JSON."""
    proc = journal_report(module, *args, "--json")
    out = proc.stdout.rstrip("\n").splitlines()
    checked = "--check" in args
    if proc.returncode != 0 or (checked and not (
            out and out[-1].startswith(f"{module} check OK"))):
        raise AssertionError(f"{module} {list(args)} exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]} {out[-1:]}")
    if checked:
        print(f"  {out.pop()}", flush=True)
    return json.loads("\n".join(out))


def perf_reading(label: str, journal, emit, plant: bool = False,
                 lanes: bool = False) -> dict:
    """``perf_report`` over drill ``label``'s journal, its rows re-journaled
    to ``emit``. Raises unless the check passes, the run-level exposed-
    allreduce share is in (0, 1] and, with ``lanes``, the engine's flight
    records gave lane rows. With ``plant``, ``--expect-exposed-allreduce``
    at that share (``--tol 0.02``) must exit 0 and at a share 0.5 away,
    folded back into [0, 1], exit 1. Prints the run-level split, each
    group's dominant phase and steady steps' fingerprints, and the lanes.
    Returns the report."""
    report = json_report("perf_report", journal, "--check", "--emit", emit)
    s = report["summary"]
    frac = s["exposed_allreduce_frac"]
    if frac is None or not 0 < frac <= 1:
        raise AssertionError(f"{label}: exposed_allreduce_frac {frac} not in (0, 1]")
    if plant:
        far = frac + 0.5 if frac + 0.5 <= 1 else frac - 0.5
        codes = [
            journal_report("perf_report", journal, "--check",
                           "--expect-exposed-allreduce", repr(f), "--tol", "0.02").returncode
            for f in (frac, far)
        ]
        if codes != [0, 1]:
            raise AssertionError(f"{label}: --expect-exposed-allreduce {frac} and the "
                                 f"planted {far} exited {codes}, not [0, 1]")
        print(f"{label} planted fault: --expect-exposed-allreduce {far:.4f} exits 1, "
              f"{frac:.4f} exits 0", flush=True)
    if lanes and not report["lane_exposure"]:
        raise AssertionError(f"{label}: no lane rows from the engine's flight records")
    print(f"{label} critical path: {s['num_rows']} rows of {s['num_steps']} steps, "
          + ", ".join(f"{k} {s[f'{k}_s']:.6f} s" for k in
                      ("quorum", "heal", "compute", "allreduce", "commit"))
          + f" (allreduce exposed; {s['comm_hidden_s']:.6f} s hidden of "
          f"{s['comm_inflight_s']:.6f} s in flight), exposed_allreduce_frac {frac:.6f}, "
          f"overlap_frac {s['overlap_frac']}, dominant {s['dominant_exposed']}",
          flush=True)
    groups: dict = {}
    for step, srec in sorted(report["steps"].items(), key=lambda kv: int(kv[0])):
        for rid, a in srec["replicas"].items():
            groups.setdefault(rid, []).append((int(step), a))
    for rid, rows in sorted(groups.items()):
        sums = {p: sum(a[f"{p}_s"] for _, a in rows)
                for p in ("quorum", "heal", "allreduce", "commit")}
        steady = [f"s{step} {a['fingerprint']}" for step, a in rows if a["heal_s"] == 0]
        print(f"{label} group {rid}: dominant exposed {max(sums, key=sums.get)}, "
              f"steady steps {steady}", flush=True)
    for r in report["lane_exposure"]:
        print(f"{label} lane peer {r['peer']} stripe {r['stripe']} {r['dir']}: sole "
              f"{r['sole_s']:.6f} s of {r['busy_s']:.6f} s busy over {r['count']} "
              f"collectives, {r['bytes']} B", flush=True)
    return report


def recovery_reading(label: str, journal, episode: dict = None) -> dict:
    """``recovery_report`` over drill ``label``'s journal. Raises unless the
    check passes with at least one episode; with ``episode`` (the drill's
    ``drill.kill_episode`` of group 1), unless the report holds it with the
    same id, root cause and time to recover and the same five phase seconds
    for group 1, a goodput attribution from the drill's ledger, and
    ``--min-episodes`` one above the count found exits 1. Prints each
    episode with its primary's phases. Returns the report."""
    from torchft_tpu_torch.telemetry import RECOVERY_PHASES

    report = json_report("recovery_report", journal, "--check", "--min-episodes", 1)
    n = report["summary"]["num_episodes"]
    for e in report["episodes"]:
        ph = e["replicas"][e["primary"]]["phases"]
        print(f"{label} episode {e['id']}: {'open' if e['open'] else 'closed'}, root "
              f"cause {e['root_cause']['kind']} on {e['root_cause']['replica']}, "
              f"primary {e['primary']}, max_step {e['max_step']}, ttr {e['ttr_s']:.6f} s ("
              + ", ".join(f"{k} {ph[k]:.6f}" for k in RECOVERY_PHASES)
              + f"), detected by {(e.get('detect_signal') or {}).get('source')}, "
              f"healthy-fleet goodput {e.get('goodput_during_heal')}", flush=True)
    if episode is None:
        return report
    mine = [e for e in report["episodes"] if e["id"] == episode["id"]]
    want = (episode["root_cause"], episode["ttr_s"], episode["replicas"]["1"]["phases"])
    if len(mine) != 1 or (
        mine[0]["root_cause"], mine[0]["ttr_s"], mine[0]["replicas"]["1"]["phases"]
    ) != want:
        raise AssertionError(f"{label}: the report's episode {episode['id']} is not the "
                             f"kill's: {mine} vs {want}")
    if mine[0].get("goodput_during_heal") is None:
        raise AssertionError(f"{label}: episode {episode['id']} has no goodput "
                             "attribution from the ledger")
    code = journal_report("recovery_report", journal, "--check",
                          "--min-episodes", n + 1).returncode
    if code != 1:
        raise AssertionError(f"{label}: --min-episodes {n + 1} of {n} exited {code}, not 1")
    print(f"{label} ok: episode {episode['id']} is drill.kill_episode's (root cause, "
          f"ttr and group 1's phases equal); planted fault --min-episodes {n + 1} "
          f"exits 1", flush=True)
    return report


def refused(label: str, module: str, args, code: int = 1) -> str:
    """Raises unless ``module`` over ``args`` (a planted fault) exits
    ``code``; returns its stderr's first line."""
    proc = journal_report(module, *args)
    if proc.returncode != code:
        raise AssertionError(f"{label}: planted fault {module} {list(args)} exited "
                             f"{proc.returncode}, not {code}: {proc.stdout[-500:]}")
    return (proc.stderr.splitlines() or [""])[0]


def timeline_reading(label: str, journal, perf: dict, kill_step: int = None) -> dict:
    """``obs_report --json`` over drill ``label``'s journal. Raises unless its
    comm attribution is ``perf_report``'s (``perf``: the same rows, the same
    ``overlap_frac`` to 4 places) and, with ``kill_step`` (the kill's
    episode's step), unless the run's largest quorum wait is group 0's (the
    survivor's) at that step, the default stall detector's reading agrees
    with its threshold (a stall at that step, or none because the 95th
    percentile of the run's waits is that wait), and ``--stall-pct 50``
    flags the step while ``--stall-min-s`` above the wait flags nothing.
    Prints each step's slowest replica and dominant phase, the stalls with
    their thresholds, the engine's bounding lane per replica and the goodput
    rollup. Returns the report."""
    from torchft_tpu_torch.obs_report import _percentile

    report = json_report("obs_report", journal)
    att = report["comm_attribution"]
    s = perf["summary"]
    want = None if s["overlap_frac"] is None else round(s["overlap_frac"], 4)
    if not att or (att["rows"], att["overlap_frac"]) != (s["num_rows"], want):
        raise AssertionError(f"{label}: obs_report's comm attribution {att} is not "
                             f"perf_report's ({s['num_rows']} rows, overlap_frac {want})")
    print(f"{label} timeline: {len(report['steps'])} steps, slowest replica (dominant "
          "phase) " + ", ".join(f"s{k} {v['slowest']['replica']} ({v['slowest']['phase']})"
                                for k, v in report["steps"].items())
          + f"; comm attribution {att}", flush=True)
    waits = sorted((row["quorum_s"], int(step), rid)
                   for step, v in report["steps"].items()
                   for rid, row in v["replicas"].items() if row["quorum_s"] > 0)
    top = waits[-1]
    threshold = max(_percentile([w for w, _, _ in waits], 95.0), 0.5)
    print(f"{label} stalls (--stall-pct 95 --stall-min-s 0.5, threshold "
          f"{threshold:.4f} s over {len(waits)} quorum waits): {report['stalls']}; "
          f"largest wait {top[0]:.6f} s, group {top[2]} at step {top[1]}", flush=True)
    for rid, a in sorted(report["native_stall_attribution"].items()):
        print(f"{label} replica {rid} bounded by peer {a.get('peer')} stripe "
              f"{a.get('stripe')} ({a.get('dir')}) in {a.get('count')}/{a.get('records')} "
              f"collectives at {a.get('gib_s')} GiB/s, skipped {a.get('skipped', 0)}",
              flush=True)
    print(f"{label} goodput rollup: {report['goodput']}", flush=True)
    if kill_step is None:
        return report
    if top[1:] != (kill_step, "0"):
        raise AssertionError(f"{label}: the largest quorum wait is group {top[2]}'s at "
                             f"step {top[1]}, not the survivor's at the kill's step {kill_step}")
    flagged = [(x["step"], x["replica"]) for x in report["stalls"]]
    if (top[0] > threshold and (kill_step, "0") not in flagged) or (
            top[0] <= threshold and flagged):
        raise AssertionError(f"{label}: stalls {flagged} at threshold {threshold}")
    wide = json_report("obs_report", journal, "--stall-pct", 50)["stalls"]
    if (kill_step, "0") not in [(x["step"], x["replica"]) for x in wide]:
        raise AssertionError(f"{label}: --stall-pct 50 stalls {wide} miss the kill's step")
    above = json_report("obs_report", journal, "--stall-pct", 50,
                        "--stall-min-s", repr(top[0] + 0.001))["stalls"]
    if above:
        raise AssertionError(f"{label}: --stall-min-s above the largest wait gave {above}")
    print(f"{label} ok: the survivor's wait at the kill's step {kill_step} is the "
          f"run's largest; --stall-pct 50 flags it ({len(wide)} stall(s)); planted "
          f"fault --stall-min-s {top[0] + 0.001:.4f} flags nothing", flush=True)
    return report


def goodput_reading(label: str, journal, planes: dict = None) -> dict:
    """``goodput_report --check --json`` over drill ``label``'s journal.
    Raises unless the check passes and ``--min-windows`` one above the
    windows found exits 1; with ``planes`` (``drill.fault_planes`` of the
    drill), unless each group's account is the drill's
    ``telemetry.audit_goodput`` row, group 1 has two incarnations and
    ``down`` above 0, and the fault cost has a ``process_loss`` row.
    Prints the fleet's goodput, retention and cost by fault kind. Returns
    the report."""
    report = json_report("goodput_report", journal, "--check")
    s = report["summary"]
    n = s["num_windows"]
    refused(label, "goodput_report", [journal, "--check", "--min-windows", n + 1])
    print(f"{label} goodput ledger: {s['num_replicas']} replicas, "
          f"{s['num_incarnations']} incarnations, {n} windows, accounted "
          f"{s['accounted_s']:.6f} s, goodput_frac {s['goodput_frac']}, "
          f"goodput_retention {s['goodput_retention']}, fault badput "
          f"{s['fault_badput_s']:.6f} s over {s['num_episodes']} episodes, cost by kind "
          + "; ".join(f"{k} x{r['episodes']} {r['total_cost_s']:.6f} s {r['cost_s']}"
                      for k, r in sorted(s["fault_cost"].items()))
          + f"; planted fault --min-windows {n + 1} exits 1", flush=True)
    if planes is None:
        return report
    g1 = report["replicas"].get("1", {})
    if (report["replicas"] != planes["goodput"] or g1.get("incarnations") != 2
            or not g1["down_s"] > 0 or "process_loss" not in s["fault_cost"]):
        raise AssertionError(f"{label}: goodput_report {report['replicas']} "
                             f"{s['fault_cost']} vs drill.fault_planes {planes['goodput']}")
    print(f"{label} ok: each group's account is drill.fault_planes' audit; group 1 "
          f"down {g1['down_s']:.6f} s over 2 incarnations", flush=True)
    return report


def detect_reading(label: str, journal) -> dict:
    """``detect_report --check --json --min-injections 1`` over drill
    ``label``'s journal (the engine journals each seeded stripe reset as a
    ``chaos_inject``). Raises unless the check passes (every row's phases
    tile) and ``--min-injections`` one above the count found exits 1.
    Prints each injection with its phases. Returns the report."""
    report = json_report("detect_report", journal, "--check", "--min-injections", 1)
    k = report["summary"]["num_injections"]
    refused(label, "detect_report", [journal, "--check", "--min-injections", k + 1])
    for r in report["rows"]:
        print(f"{label} injection {r['kind']}@{r['victim']}: source {r['source']}, "
              + ", ".join(f"{p} {r[p]}" for p in ("signal_s", "quorum_s", "react_s",
                                                  "total_s")), flush=True)
    print(f"{label} detection: {k} injections, {report['summary']['num_detected']} "
          f"detected, matrix {report['summary']['matrix']}; planted fault "
          f"--min-injections {k + 1} exits 1", flush=True)
    return report


def trace_reading(label: str, journal, out, episode: dict = None) -> dict:
    """``obs_trace --check -o out`` over drill ``label``'s journal. Raises
    unless it exits 0 with its ``wrote`` line, the port's ``validate_trace``
    passes the file and finds problems in a copy with one span's ``dur``
    removed and, with ``episode`` (``drill.kill_episode`` of an engine
    drill), unless the trace has spans on the ``native engine`` thread and
    a ``recovery`` track holding that episode's phases. Prints the event
    and span counts. Returns the trace."""
    import copy

    from torchft_tpu_torch.obs_trace import validate_trace

    proc = journal_report("obs_trace", journal, "--check", "-o", out)
    line = proc.stdout.strip()
    if proc.returncode != 0 or not line.startswith(f"wrote {out}"):
        raise AssertionError(f"{label}: obs_trace exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]} {line}")
    trace = json.loads(Path(out).read_text())
    errs = validate_trace(trace)
    broken = copy.deepcopy(trace)
    next(e for e in broken["traceEvents"] if e["ph"] == "X").pop("dur")
    if errs or not validate_trace(broken):
        raise AssertionError(f"{label}: validate_trace gave {errs[:5]} on the trace and "
                             f"{validate_trace(broken)} on one without a dur")
    names = {(e["pid"], e["tid"]): e["args"]["name"]
             for e in trace["traceEvents"] if e["name"] == "thread_name"}
    spans: dict = {}  # X spans by thread, the engine's lane threads as one
    for e in trace["traceEvents"]:
        if e["ph"] == "X":
            track = names[(e["pid"], e["tid"])]
            track = "engine lanes" if track.startswith("peer") else track
            spans[track] = spans.get(track, 0) + 1
    print(f"{label} trace: {line}; spans by track {dict(sorted(spans.items()))}", flush=True)
    if episode is None:
        return trace
    phases = [e for e in trace["traceEvents"] if e.get("cat") == "episode" and e["ph"] == "X"
              and e["args"]["episode"] == episode["id"]
              and names[(e["pid"], e["tid"])] == "recovery"]
    if not spans.get("native engine") or not phases:
        raise AssertionError(f"{label}: {spans.get('native engine')} native engine spans, "
                             f"{len(phases)} recovery spans of episode {episode['id']}")
    print(f"{label} ok: the trace validates, {spans['native engine']} native engine "
          f"spans, {len(phases)} recovery spans of episode {episode['id']}; a copy "
          "without one span's dur is refused", flush=True)
    return trace


def unnamed_record_refused(label: str, journal, out_dir) -> str:
    """A planted journal: the first ``native_collective`` record of drill
    ``label``'s journal with its ``op`` emptied, so its span has no name.
    Raises unless ``obs_trace --check`` over it exits 2; returns the
    message."""
    from torchft_tpu_torch.telemetry import load_journal

    ev = next(e for e in load_journal([str(journal)]) if e["event"] == "native_collective")
    ev["attrs"]["op"] = ""
    bad = Path(out_dir) / "unnamed_record.jsonl"
    bad.write_text(json.dumps(ev) + "\n")
    msg = refused(label, "obs_trace", [bad, "--check"], code=2)
    print(f"{label} planted fault: a native record without an op, obs_trace --check "
          f"exits 2 ({msg})", flush=True)
    return msg


def readers_reading(label: str, journal, trace_out, perf: dict, recovery: dict,
                    engine: dict = None, kill: bool = False) -> dict:
    """The timeline, goodput, detection and trace readers over drill
    ``label``'s journal, beside its ``perf_report`` (``perf``) and
    ``recovery_report`` (``recovery``). ``engine`` is an engine drill's
    output (its ``episode`` and ``planes``): both groups must have a
    bounding lane, its goodput is held to the planes, its injections are
    read and its trace must draw the episode. With ``kill``, the stall
    reading is held to the step of the kill's episode (the one after step
    0 in ``recovery``). Returns the reports and the trace's event count."""
    kill_step = None
    if kill:
        steps = [e["max_step"] for e in recovery["episodes"] if (e["max_step"] or 0) > 0]
        if len(steps) != 1:
            raise AssertionError(f"{label}: episodes after step 0 at steps {steps}, "
                                 "want the kill's alone")
        kill_step = steps[0]
    out = {"timeline": timeline_reading(label, journal, perf, kill_step)}
    lanes = out["timeline"]["native_stall_attribution"]
    if engine is not None and not all("peer" in lanes.get(g, {}) for g in ("0", "1")):
        raise AssertionError(f"{label}: no bounding lane for both groups: {lanes}")
    if engine is not None or any("goodput_window" in f.read_text()
                                 for f in Path(journal).glob("*.jsonl")):
        out["goodput"] = goodput_reading(label, journal, engine and engine["planes"])
    if engine is not None:
        out["detect"] = detect_reading(label, journal)
    trace = trace_reading(label, journal, trace_out, engine and engine["episode"])
    out["trace_events"] = len(trace["traceEvents"])
    return out


def reports_phase(orchestration: dict, bench: dict) -> None:
    """Phase 19a: the port's journal readers as processes of their own over
    the journals phases 6 (the socket ring under ``TORCHFT_PERF=1``), 15
    (pg-sharded) and 19 (the engine, ``orchestration``) already wrote; no
    drill of its own. Raises unless every report passes its check, phase
    6's has an mfu in (0, 1) from a ``perf_model`` of this card, the
    planted faults are caught, phase 19's has lane rows and its recovery
    report holds ``drill.kill_episode``'s episode (``perf_reading``,
    ``recovery_reading``), and unless the timeline, goodput, detection
    and trace readers hold (``timeline_reading``, ``goodput_reading``,
    ``detect_reading``, ``trace_reading``, ``unnamed_record_refused``).
    Prints phase 6's whole-step mfu beside phase 18's (``bench``) bare-step
    ``mfu_est`` and the phase's wall; the reports' JSON, traces and
    re-journaled ``perf_step`` events go to ``OUT/reports``."""
    import shutil

    import torch

    t0 = time.monotonic()
    out_dir = OUT / "reports"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    kind = torch.cuda.get_device_name(0)
    drills = {
        "path": ("phase 6, socket ring", OUT / "path" / "journal", {"plant": True}),
        "pg-sharded": ("phase 15, pg-sharded", OUT / "pg-sharded path" / "journal", {}),
        "orchestration": ("phase 19, engine", orchestration["journal_dir"], {"lanes": True}),
    }
    reports = {}
    for name, (label, journal, kw) in drills.items():
        perf = perf_reading(f"reports {label}", journal, out_dir / f"{name}.jsonl", **kw)
        episode = orchestration["episode"] if name == "orchestration" else None
        reports[name] = {
            "perf": perf,
            "recovery": recovery_reading(f"reports {label}", journal, episode),
        }
        reports[name].update(readers_reading(
            f"reports {label}", journal, out_dir / f"{name}.trace.json", perf,
            reports[name]["recovery"], orchestration if episode else None,
            kill=name == "path"))
        (out_dir / f"{name}.json").write_text(json.dumps(reports[name], indent=1))
    unnamed_record_refused("reports phase 19, engine", orchestration["journal_dir"], out_dir)
    bandwidth_line(orchestration["fleet_views"],
                   reports["orchestration"]["timeline"]["native_stall_attribution"])
    mfu = reports["path"]["perf"]["mfu"]
    kinds = [m.get("device_kind") for m in reports["path"]["perf"]["perf_models"].values()]
    if not mfu or mfu["mfu"] is None or not 0 < mfu["mfu"] < 1 or kind not in kinds:
        raise AssertionError(f"phase 6's report: mfu {mfu}, perf_model device kinds "
                             f"{kinds}; want an mfu in (0, 1) for {kind}")
    wall = time.monotonic() - t0
    print(f"reports ok: phase 6's whole committed step at mfu {mfu['mfu']:.6f} "
          f"({mfu['tflops_per_s']:.4f} TF/s over a mean step of "
          f"{mfu['mean_step_s'] * 1e3:.1f} ms, {kind}) beside phase 18's bare step "
          f"at mfu_est {bench['mfu_est']} (interleaved {bench['mfu_est_interleaved']}); "
          f"phase wall {wall:.1f}s", flush=True)


# ---------------------------------------------------------------------------
# Phase 20: the Baby group
# ---------------------------------------------------------------------------

# The Managers' collective deadline: room for the int8 allreduce through
# the Baby group with both replicas in this process (7.6 s in a development
# run). The wedged step waits BABY_WEDGE_WAIT_S instead, the caller's
# deadline, at which the Manager aborts the groups.
BABY_TIMEOUT_S = 120.0
BABY_WEDGE_WAIT_S = 5.0
# The engine's int8 wire against the fp32 mean: the JAX package's test
# tolerance (tests/test_process_group_native.py, two quantization steps of
# standard normal blocks of 512).
NATIVE_INT8_ATOL = 0.1


def hb_lapses(lighthouse, tag: str) -> list:
    """The ``hb_lapse`` records of an in-process lighthouse's signal ring
    (its ``fleet`` RPC's ``signals``; ``gap_ms``, ``budget_ms``:
    torchft_tpu/_cpp/lighthouse.cc:1383-1389), each printed beside the host
    watch's state and phases at that moment. Returns the records."""
    from torchft_tpu_torch.coordination import LighthouseClient

    try:
        client = LighthouseClient(lighthouse.address(), connect_timeout=5.0)
        try:
            signals = client.fleet(timeout=5.0).get("signals", [])
        finally:
            client.close()
    except Exception as e:  # noqa: BLE001 - a reading; the phase's checks decide
        print(f"baby: {tag} lighthouse's signals unread: {e!r}", flush=True)
        return []
    lapses = [s for s in signals if s.get("source") == "hb_lapse"]
    for s in lapses:
        at = s.get("ts_ms", 0) / 1000.0
        watch = HOST_WATCH
        host = watch.near(at) if watch is not None else None
        phases = list(watch.phases_at(at)) if watch is not None else []
        print(f"baby: {tag} lighthouse hb_lapse on {s.get('replica_id')} at {at:.3f}: "
              f"{json.dumps(s.get('detail'))}; phases {phases}; host {json.dumps(host)}",
              flush=True)
    return lapses


def baby_phase() -> dict:
    """Phase 20: two Managers in threads of this process against an
    in-process lighthouse, each over ``ProcessGroupBabySocket``, on buffers
    of llama_small's parameter shapes on the card (one seed a replica):
    (a) an fp32 ``Manager.allreduce`` that must commit and equal, bit for
    bit, the same allreduce through ``ProcessGroupSocket`` (two more
    Managers, run in turn on the same inputs); (b) the int8 quantized
    allreduce, equal to the host quantizer's int8 average bit for bit, with
    the quantize and dequantize kernels launched for both replicas (the
    counts set to 0 just before); (c) one replica's child wedged with
    ``_inject_stall``: the wait times out (``BABY_WEDGE_WAIT_S``) and the
    Manager aborts the groups, killing the children; the step fails, the next
    quorum respawns them (new ``child_pid``), and the next allreduce
    commits with the fp32 bytes of (a). Then (d) a third pair of Managers,
    over ``ProcessGroupNative`` (the C++ engine), on the same inputs: the
    fp32 allreduce must commit and equal the socket group's bytes, and a
    planted fault (replica 1's input changed after the socket reference
    was taken) must fail that equality; (e) a fourth pair over the engine's
    int8 wire (``wire="int8"``): both replicas decode the same bytes,
    within ``NATIVE_INT8_ATOL`` of the fp32 mean (the JAX package's test
    tolerance), moving under half the fp32 engine's ``pg_wire_tx`` bytes.
    Prints each allreduce's seconds with every group, the respawn seconds
    and ``df /dev/shm``. Returns the launches and timings."""
    import functools
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from torchft_tpu_torch.baby import ProcessGroupBabySocket
    from torchft_tpu_torch.collectives import (
        dequantize_blockwise,
        quantize_blockwise,
    )
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models import Transformer, llama_small
    from torchft_tpu_torch.ops import quantization
    from torchft_tpu_torch.process_group import ProcessGroupNative, ProcessGroupSocket
    from torchft_tpu_torch.telemetry import byte_stats

    df = subprocess.run(["df", "-B1", "/dev/shm"], capture_output=True, text=True)
    print(f"baby: df /dev/shm\n{df.stdout.strip()}", flush=True)
    dev = torch.device("cuda", 0)
    with torch.device("meta"):
        shapes = {n: p.shape for n, p in Transformer(llama_small()).named_parameters()}
    names = sorted(shapes)
    inputs = []
    for r in range(2):
        g = torch.Generator(device=dev).manual_seed(200 + r)
        inputs.append([torch.randn(shapes[n], generator=g, device=dev) for n in names])
    n_values = sum(t.numel() for t in inputs[0])

    def make_managers(pg_cls, tag: str):
        lighthouse = LighthouseServer(
            bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=10000,
            quorum_tick_ms=20,
        )

        def make(r: int) -> Manager:
            manager = Manager(
                pg=pg_cls(timeout=60.0),
                min_replica_size=2,
                use_async_quorum=False,
                timeout=BABY_TIMEOUT_S,
                quorum_timeout=120.0,
                replica_id=f"chip_smoke_{tag}{r}",
                lighthouse_addr=lighthouse.address(),
                group_rank=0,
                group_world_size=1,
                init_sync=False,
            )
            manager.register_state_dict_fn("w", lambda: {}, lambda v: None)
            return manager

        with ThreadPoolExecutor(max_workers=2) as pool:
            return lighthouse, list(pool.map(make, range(2)))

    def step(managers, quantize: bool, before=None, wait_s=None) -> list:
        """One step of both replicas: (committed, outputs, seconds)."""
        def run(r: int):
            m = managers[r]
            m.start_quorum()
            if before is not None:
                before(r, m)
            t0 = time.monotonic()
            work = m.allreduce(inputs[r], should_quantize=quantize)
            outs = work.wait(timeout=wait_s)
            torch.cuda.synchronize(dev)
            secs = time.monotonic() - t0
            return m.should_commit(), outs, secs

        with ThreadPoolExecutor(max_workers=2) as pool:
            return [f.result(timeout=600) for f in
                    [pool.submit(run, r) for r in range(2)]]

    def flat(outs) -> np.ndarray:
        return torch.cat([t.reshape(-1) for t in outs]).cpu().numpy()

    def differing(outs, want) -> int:
        return int((flat(outs).view(np.int32) != want.view(np.int32)).sum())

    # (a) fp32 through the socket group, then through the Baby group.
    lapses = []

    def close(lighthouse, managers, tag: str) -> None:
        # Every lighthouse's hb_lapse records print, failed or not.
        lapses.extend(hb_lapses(lighthouse, tag))
        # The caller owns a Manager's process group: shut it down too.
        for m in managers:
            m.shutdown()
            m._pg.shutdown()
        lighthouse.shutdown()

    lighthouse, managers = make_managers(ProcessGroupSocket, "socket")
    try:
        sock = step(managers, False)
    finally:
        close(lighthouse, managers, "socket")
    lighthouse, managers = make_managers(ProcessGroupBabySocket, "baby")
    pgs = [m._pg for m in managers]
    try:
        baby = step(managers, False)
        spawn_s = [pg.spawn_seconds() for pg in pgs]
        if not all(c for c, _, _ in sock + baby):
            raise AssertionError(
                f"baby: fp32 commits socket {[c for c, _, _ in sock]} baby "
                f"{[c for c, _, _ in baby]}"
            )
        want = flat(sock[0][1])
        for r in range(2):
            for label, run in (("socket", sock), ("baby", baby)):
                differ = int((flat(run[r][1]).view(np.int32) != want.view(np.int32)).sum())
                if differ:
                    raise AssertionError(
                        f"baby: replica {r}'s fp32 {label} allreduce differs from "
                        f"the socket group's in {differ} of {n_values} values"
                    )

        # (b) int8 on the device path through the Baby group.
        chunks = -(-n_values // quantization._TRANSFER_CHUNK)
        for kernel in quantization.LAUNCHES:
            quantization.LAUNCHES[kernel] = 0
        q8 = step(managers, True)
        launches = dict(quantization.LAUNCHES)
        if not all(c for c, _, _ in q8):
            raise AssertionError(f"baby: int8 commits {[c for c, _, _ in q8]}")
        for kernel in QUANT_KERNELS:
            if launches[kernel] != 2 * chunks:
                raise AssertionError(
                    f"baby: {kernel} launched {launches[kernel]} times, want "
                    f"{2 * chunks} ({chunks} per replica)"
                )
        acc = np.zeros(n_values, np.float32)
        for r in range(2):
            x = flat(inputs[r])
            acc += dequantize_blockwise(*quantize_blockwise(x, 8), n_values, 8)
        want_q = dequantize_blockwise(*quantize_blockwise(acc, 8), n_values, 8)
        want_q *= np.float32(0.5)
        for r in range(2):
            differ = int((flat(q8[r][1]).view(np.int32) != want_q.view(np.int32)).sum())
            if differ:
                raise AssertionError(
                    f"baby: replica {r}'s int8 allreduce differs from the host "
                    f"quantizer's int8 average in {differ} of {n_values} values"
                )

        # (c) a wedged child: the step fails at the deadline, the next
        # quorum respawns the children, the step after commits.
        old = [pg.child_pid() for pg in pgs]

        def wedge(r: int, m) -> None:
            if r == 1:
                m._pg._inject_stall(3600.0)

        t_wedge = time.monotonic()
        wedged = step(managers, False, before=wedge, wait_s=BABY_WEDGE_WAIT_S)
        wedge_s = time.monotonic() - t_wedge
        if any(c for c, _, _ in wedged):
            raise AssertionError("baby: a step over a wedged child committed")
        t_heal = time.monotonic()
        healed = step(managers, False)
        heal_s = time.monotonic() - t_heal
        new = [pg.child_pid() for pg in pgs]
        respawn_s = [pg.spawn_seconds() for pg in pgs]
        if not all(c for c, _, _ in healed) or new[1] in (None, old[1]):
            raise AssertionError(
                f"baby: after the wedge commits {[c for c, _, _ in healed]}, "
                f"child pids {old} -> {new}"
            )
        for r in range(2):
            if flat(healed[r][1]).tobytes() != want.tobytes():
                raise AssertionError(f"baby: replica {r}'s allreduce after the respawn differs")
    finally:
        close(lighthouse, managers, "baby")

    # (d) fp32 through the native engine, then a planted fault.
    def wire_step(managers) -> tuple:
        """One fp32 step of both replicas and the pg_wire_tx bytes it sent."""
        tx0 = byte_stats().get("pg_wire_tx", 0)
        run = step(managers, False)
        return run, byte_stats().get("pg_wire_tx", 0) - tx0

    lighthouse, managers = make_managers(ProcessGroupNative, "native")
    try:
        if {m._pg.getBackendName() for m in managers} != {"torchft-native"}:
            raise AssertionError("baby: the native pair is not over the engine")
        native, native_tx = wire_step(managers)
        if not all(c for c, _, _ in native):
            raise AssertionError(f"baby: native fp32 commits {[c for c, _, _ in native]}")
        for r in range(2):
            differ = differing(native[r][1], want)
            if differ:
                raise AssertionError(
                    f"baby: replica {r}'s fp32 native allreduce differs from the "
                    f"socket group's in {differ} of {n_values} values"
                )
        planted = inputs[1][0].reshape(-1)
        planted[0] += 1.0
        try:
            faulty = step(managers, False)
        finally:
            planted[0] -= 1.0
        fault_differ = [differing(faulty[r][1], want) for r in range(2)]
        if not all(fault_differ):
            raise AssertionError(
                f"baby: the planted fault passed the native equality check "
                f"({fault_differ} values differ)"
            )
    finally:
        close(lighthouse, managers, "native")

    # (e) the engine's int8 wire.
    lighthouse, managers = make_managers(
        functools.partial(ProcessGroupNative, wire="int8"), "native_int8"
    )
    try:
        native_q8, q8_tx = wire_step(managers)
        if not all(c for c, _, _ in native_q8):
            raise AssertionError(f"baby: native int8 commits {[c for c, _, _ in native_q8]}")
        got = [flat(native_q8[r][1]) for r in range(2)]
        if got[0].tobytes() != got[1].tobytes():
            raise AssertionError("baby: the replicas decode different int8 engine bytes")
        q8_err = float(np.abs(got[0] - want).max())
        if not (q8_err <= NATIVE_INT8_ATOL and 0 < q8_tx < native_tx / 2):
            raise AssertionError(
                f"baby: native int8 max error {q8_err} (limit {NATIVE_INT8_ATOL}), "
                f"wire {q8_tx} B against fp32 {native_tx} B"
            )
    finally:
        close(lighthouse, managers, "native_int8")
    out = {
        "launches": launches,
        "fp32_socket_s": [s for _, _, s in sock],
        "fp32_baby_s": [s for _, _, s in baby],
        "int8_baby_s": [s for _, _, s in q8],
        "spawn_s": spawn_s,
        "respawn_s": respawn_s,
        "wedge_step_s": wedge_s,
        "step_after_respawn_s": heal_s,
        "fp32_after_respawn_s": [s for _, _, s in healed],
        "fp32_native_s": [s for _, _, s in native],
        "fp32_native_planted_fault_differ": fault_differ,
        "int8_native_s": [s for _, _, s in native_q8],
        "int8_native_max_abs_err": q8_err,
        "native_wire_tx": {"fp32": native_tx, "int8": q8_tx},
        "hb_lapses": lapses,
    }
    print(f"baby ok: {n_values} values ({4 * n_values} B fp32) a replica; fp32 "
          f"allreduce socket {out['fp32_socket_s']} s, baby {out['fp32_baby_s']} s "
          f"(bit-equal); int8 baby {out['int8_baby_s']} s (the host quantizer's "
          f"bits, launches {launches}); child spawn {spawn_s} s; wedged step "
          f"{wedge_s:.2f} s, children {old} -> {new}, respawn {respawn_s} s, "
          f"next step {heal_s:.2f} s (allreduce {out['fp32_after_respawn_s']} s); "
          f"native fp32 {out['fp32_native_s']} s (the socket group's bytes; the "
          f"planted fault differs in {fault_differ} values), native int8 "
          f"{out['int8_native_s']} s (max error {q8_err:.4f}, wire {q8_tx} B "
          f"against fp32 {native_tx} B); hb_lapse records {len(lapses)}",
          flush=True)
    (OUT / "baby.json").write_text(json.dumps(out, indent=1))
    return out


# ---------------------------------------------------------------------------
# Phase 20a: the Manager's fault scenarios on the card's tensors
# ---------------------------------------------------------------------------

SCENARIO_SEED = 27
SCENARIO_LR = 0.01
# Phase 20a's wall budget, seconds: cut steps, not scenarios, to meet it.
SCENARIO_BUDGET_S = 90.0
# The int4 leaf's length: odd, so the nibble packing ends in a ragged byte,
# and over one transfer chunk, so each replica quantizes and dequantizes in
# two chunks.
SCENARIO_Q4_N = 25_000_001


def state_equal(a: dict, b: dict) -> bool:
    """Whether two fp32 states hold the same names, shapes and bits."""
    import torch

    return sorted(a) == sorted(b) and all(
        a[n].shape == b[n].shape
        and torch.equal(a[n].view(torch.int32), b[n].view(torch.int32))
        for n in a)


def manager_scenarios_phase(device: str = "cuda", model: str = "small",
                            q4_n: int = SCENARIO_Q4_N) -> dict:
    """Phase 20a: the port's Manager in threads of this process against an
    in-process lighthouse, over ``ProcessGroupSocket``, each replica's state
    on ``device`` at ``model``'s parameter shapes (llama_small's on the
    card), gradients from a ``torch.Generator`` on the device seeded by
    (replica, step), SGD on the device. Five scenarios, each ending in a
    check that raises:
    1. crash and heal: replica 1 crashes at step 2, restarts and heals by
       HTTP from replica 0; both end equal, the heal delivered exactly the
       parameters' bytes, and one element planted into the healed state
       after the heal fails the equality;
    2. three replicas, one crash: a third replica joins mid-run (upscale,
       a heal), then replica 1 crashes and heals; all three end equal;
    3. operator drain: ``request_drain`` on replica 1, which sees
       ``drain_requested()`` at its next quorum and leaves; replica 0
       commits alone (``min_replica_size`` 1) until ``drain_all`` ends it;
    4. lighthouse outage: the lighthouse process is SIGKILLed between two
       rounds; the round without it fails to commit on both replicas and no
       trainer thread raises; a new lighthouse at the same address and the
       next round commits; both end equal with failed commits above 0;
    5. the device-quantized allreduce at int4 over three replicas, one leaf
       of ``q4_n`` values (``SCENARIO_Q4_N`` on the card): on a CUDA device the quantize and
       dequantize kernels launch once per transfer chunk per replica (the
       counts set to 0 just before); every replica's result equals, bit for
       bit, the host quantizer's int4 average (each payload quantized and
       dequantized, summed in rank order, requantized, times 1/3), and the
       int8 reference (the planted fault) differs.
    Prints one line with each scenario's wall, commits, failed commits and
    heal bytes; returns them with the kernels' launches."""
    import signal as signal_mod
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from torchft_tpu_torch.collectives import dequantize_blockwise, quantize_blockwise
    from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models import Transformer, llama_debug, llama_small
    from torchft_tpu_torch.ops import quantization
    from torchft_tpu_torch.process_group import ProcessGroupSocket

    t_phase = time.monotonic()
    dev = torch.device(device)
    with torch.device("meta"):
        cfg = llama_small() if model == "small" else llama_debug()
        shapes = {n: tuple(p.shape) for n, p in Transformer(cfg).named_parameters()}
    names = sorted(shapes)
    state_bytes = sum(4 * math.prod(s) for s in shapes.values())

    def init_state() -> dict:
        g = torch.Generator(device=dev).manual_seed(SCENARIO_SEED)
        return {n: 0.02 * torch.randn(shapes[n], generator=g, device=dev) for n in names}

    def grads(replica: int, step: int) -> list:
        g = torch.Generator(device=dev).manual_seed(SCENARIO_SEED + 1000 * (step + 1) + replica)
        return [torch.randn(shapes[n], generator=g, device=dev) for n in names]

    def lighthouse(min_replicas: int, bind: str = "127.0.0.1:0") -> LighthouseServer:
        return LighthouseServer(bind=bind, min_replicas=min_replicas, join_timeout_ms=10000,
                                quorum_tick_ms=20, heartbeat_timeout_ms=5000)

    class Replica:
        """One replica group's loop; ``crash_at`` crashes its first
        incarnation before that step (its Manager shut down, its state
        dropped) and starts a second, which heals."""

        def __init__(self, r: int, addr: str, tag: str, total: int, min_size: int = 1,
                     crash_at: int = None, hook=None, drains: bool = False):
            self.r, self.addr, self.tag, self.total = r, addr, tag, total
            self.min_size, self.crash_at, self.hook, self.drains = min_size, crash_at, hook, drains
            self.commits = self.failed = 0
            self.heal_bytes, self.participants, self.managers = [], [], []
            self.state = None
            self.drained = False

        def run(self) -> dict:
            for incarnation in range(2 if self.crash_at is not None else 1):
                self.state = init_state()
                if not self._incarnation(crash=incarnation == 0 and self.crash_at is not None):
                    return self.state
            return self.state

        def _load(self, sd: dict) -> None:
            # The heal delivers each leaf as a tensor or, from a host
            # buffer, a numpy array.
            sd = {n: torch.as_tensor(t) for n, t in sd.items()}
            self.heal_bytes.append(sum(t.numel() * t.element_size() for t in sd.values()))
            for n, t in sd.items():
                self.state[n].copy_(t)

        def _incarnation(self, crash: bool) -> bool:
            """One Manager's life; True when it crashed."""
            m = Manager(
                pg=ProcessGroupSocket(timeout=60.0), state_dict=lambda: dict(self.state),
                load_state_dict=self._load, min_replica_size=self.min_size,
                use_async_quorum=False, timeout=60.0, quorum_timeout=60.0,
                replica_id=f"chip_smoke_{self.tag}{self.r}", lighthouse_addr=self.addr,
                group_rank=0, group_world_size=1, init_sync=False,
            )
            self.managers.append(m)
            try:
                while m.current_step() < self.total:
                    if crash and m.current_step() >= self.crash_at:
                        return True
                    if self.drains and m.drain_requested():
                        if not m.leave():
                            raise AssertionError(f"{self.tag}: replica {self.r}'s leave failed")
                        self.drained = True
                        return False
                    m.start_quorum()
                    if self.hook is not None:
                        self.hook(self, m)
                    step = m.current_step()
                    if step >= self.total:
                        break
                    reduced = m.allreduce(grads(self.r, step)).wait(timeout=120)
                    with m.fenced_state_dict():
                        if m.should_commit():
                            for n, g in zip(names, reduced):
                                self.state[n].add_(g, alpha=-SCENARIO_LR)
                            self.commits += 1
                            self.participants.append(m.num_participants())
                        else:
                            self.failed += 1
                return False
            finally:
                m.shutdown()
                m._pg.shutdown()

    def run_all(replicas, delays=None) -> None:
        pool = ThreadPoolExecutor(max_workers=len(replicas))
        try:
            futs = []
            for i, rep in enumerate(replicas):
                if delays and delays.get(i):
                    delays[i]()
                futs.append(pool.submit(rep.run))
            for f in futs:
                f.result(timeout=300)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def all_equal(tag: str, replicas) -> None:
        for rep in replicas[1:]:
            if not state_equal(replicas[0].state, rep.state):
                raise AssertionError(f"{tag}: replica {rep.r}'s state differs from replica 0's")

    def healed(tag: str, rep) -> None:
        if not rep.heal_bytes or any(b != state_bytes for b in rep.heal_bytes):
            raise AssertionError(f"{tag}: replica {rep.r}'s heals delivered {rep.heal_bytes} B, "
                                 f"the parameters are {state_bytes} B")

    out: dict = {"state_bytes": state_bytes, "scenarios": {}}

    def record(tag: str, t0: float, replicas, **more) -> None:
        out["scenarios"][tag] = {
            "wall_s": round(time.monotonic() - t0, 2),
            "commits": [rep.commits for rep in replicas],
            "failed": [rep.failed for rep in replicas],
            "heal_bytes": [rep.heal_bytes for rep in replicas], **more}

    # 1. Crash and heal.
    t0 = time.monotonic()
    lh = lighthouse(1)
    try:
        reps = [Replica(0, lh.address(), "crash", 4),
                Replica(1, lh.address(), "crash", 4, crash_at=2)]
        run_all(reps)
    finally:
        lh.shutdown()
    all_equal("crash", reps)
    healed("crash", reps[1])
    planted = {n: t.clone() for n, t in reps[1].state.items()}
    planted[names[0]].view(-1)[0] += 1.0
    if state_equal(reps[0].state, planted):
        raise AssertionError("crash: a planted element in the healed state passed the equality")
    record("crash", t0, reps, planted_fault_caught=True)

    # 2. Three replicas: a third joins mid-run, then replica 1 crashes.
    t0 = time.monotonic()
    joined = threading.Event()

    def pace(rep, m) -> None:
        # Rounds keep forming while 0 and 1 wait for the joiner.
        if not joined.is_set():
            joined.wait(0.25)

    def joiner(rep, m) -> None:
        if m.num_participants() >= 3:
            joined.set()

    lh = lighthouse(1)
    try:
        reps = [Replica(0, lh.address(), "three", 5, hook=pace),
                Replica(1, lh.address(), "three", 5, crash_at=3, hook=pace),
                Replica(2, lh.address(), "three", 5, hook=joiner)]

        def after_first_commit() -> None:
            deadline = time.monotonic() + 120
            while reps[0].commits < 1:
                if time.monotonic() > deadline:
                    raise AssertionError("three: replicas 0 and 1 made no progress")
                time.sleep(0.05)

        run_all(reps, delays={2: after_first_commit})
    finally:
        lh.shutdown()
    all_equal("three", reps)
    healed("three", reps[2])
    healed("three", reps[1])
    if 3 not in reps[0].participants:
        raise AssertionError(f"three: never three wide: {reps[0].participants}")
    record("three", t0, reps)

    # 3. Operator drain.
    t0 = time.monotonic()
    lh = lighthouse(1)
    try:
        reps = [Replica(0, lh.address(), "drain", 50, drains=True),
                Replica(1, lh.address(), "drain", 50, drains=True)]
        client = LighthouseClient(lh.address())
        pool = ThreadPoolExecutor(max_workers=2)
        try:
            futs = [pool.submit(rep.run) for rep in reps]

            def until(cond, what: str) -> None:
                deadline = time.monotonic() + 120
                while not cond():
                    for f in futs:
                        if f.done():
                            f.result()
                    if time.monotonic() > deadline:
                        raise AssertionError(f"drain: {what}")
                    time.sleep(0.05)

            until(lambda: reps[1].commits >= 1 and reps[1].managers, "replica 1 never committed")
            client.request_drain(reps[1].managers[-1].replica_id())
            until(lambda: reps[1].drained, "replica 1 never drained")
            alone = reps[0].commits
            until(lambda: reps[0].commits > alone and reps[0].participants[-1] == 1,
                  "replica 0 never committed alone")
            report = client.drain_all()
            for f in futs:
                f.result(timeout=120)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
            client.close()
    finally:
        lh.shutdown()
    if not (reps[0].drained and reps[1].drained and report.get("n_sent", 0) >= 1
            and reps[0].commits < 50):
        raise AssertionError(f"drain: drained {[r.drained for r in reps]}, drain_all {report}, "
                             f"commits {[r.commits for r in reps]}")
    record("drain", t0, reps, drain_all=report, alone_commits=reps[0].participants.count(1))

    # 4. Lighthouse outage and restart.
    t0 = time.monotonic()
    lh = lighthouse(2)
    addr = lh.address()
    port = int(addr.rsplit(":", 1)[1])
    barrier = threading.Barrier(3)
    raised = []

    class OutageReplica(Replica):
        def run(self) -> dict:
            self.state = init_state()
            m = Manager(
                pg=ProcessGroupSocket(timeout=60.0), state_dict=lambda: dict(self.state),
                load_state_dict=self._load, min_replica_size=2, use_async_quorum=False,
                timeout=60.0, quorum_timeout=60.0, replica_id=f"chip_smoke_outage{self.r}",
                lighthouse_addr=self.addr, group_rank=0, group_world_size=1,
                init_sync=False, max_retries=5,
            )
            try:
                for rnd in range(3):
                    barrier.wait(timeout=120)
                    try:
                        m.start_quorum(timeout=6.0 if rnd == 1 else 60.0)
                    except Exception:  # noqa: BLE001 - the latched error fails the commit
                        if m.errored() is None:
                            raise
                    step = m.current_step()
                    reduced = m.allreduce(grads(self.r, step)).wait(timeout=120)
                    with m.fenced_state_dict():
                        if m.should_commit():
                            for n, g in zip(names, reduced):
                                self.state[n].add_(g, alpha=-SCENARIO_LR)
                            self.commits += 1
                        else:
                            self.failed += 1
            except BaseException as e:
                raised.append(repr(e))
                raise
            finally:
                m.shutdown()
                m._pg.shutdown()
            return self.state

    reps = [OutageReplica(r, addr, "outage", 3) for r in range(2)]
    pool = ThreadPoolExecutor(max_workers=2)
    lh2 = None
    try:
        futs = [pool.submit(rep.run) for rep in reps]

        def next_round() -> None:
            while barrier.n_waiting < 2:
                for f in futs:
                    if f.done():
                        f.result()
                time.sleep(0.05)

        barrier.wait(timeout=120)  # round 0: healthy
        time.sleep(0.1)
        next_round()
        lh._server._proc.send_signal(signal_mod.SIGKILL)
        lh._server._proc.wait(timeout=30)
        barrier.wait(timeout=120)  # round 1: the lighthouse is dead
        next_round()
        lh2 = lighthouse(2, bind=f"127.0.0.1:{port}")
        barrier.wait(timeout=120)  # round 2: back at the same address
        for f in futs:
            f.result(timeout=300)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        lh.shutdown()
        if lh2 is not None:
            lh2.shutdown()
    all_equal("outage", reps)
    if raised or [r.commits for r in reps] != [2, 2] or not all(r.failed > 0 for r in reps):
        raise AssertionError(f"outage: commits {[r.commits for r in reps]}, failed "
                             f"{[r.failed for r in reps]}, raised {raised}")
    record("outage", t0, reps)

    # 5. The device-quantized int4 allreduce over three replicas.
    t0 = time.monotonic()
    n = q4_n
    chunks = -(-n // quantization._TRANSFER_CHUNK)
    leaves = []
    for r in range(3):
        g = torch.Generator(device=dev).manual_seed(SCENARIO_SEED + 500 + r)
        leaves.append(torch.randn(n, generator=g, device=dev))
    lh = lighthouse(3)
    results, ranks = {}, {}
    try:
        managers = []

        def make(r: int) -> Manager:
            return Manager(
                pg=ProcessGroupSocket(timeout=60.0), min_replica_size=3,
                use_async_quorum=False, timeout=60.0, quorum_timeout=60.0,
                replica_id=f"chip_smoke_q4_{r}", lighthouse_addr=lh.address(),
                group_rank=0, group_world_size=1, init_sync=False,
            )

        with ThreadPoolExecutor(max_workers=3) as pool:
            managers = list(pool.map(make, range(3)))
        try:
            for kernel in quantization.LAUNCHES:
                quantization.LAUNCHES[kernel] = 0

            def step(r: int):
                m = managers[r]
                m.start_quorum()
                ranks[r] = m.participating_rank()
                (res,) = m.allreduce([leaves[r]], should_quantize=True,
                                     quantize_bits=4).wait(timeout=120)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                results[r] = res
                return m.should_commit()

            with ThreadPoolExecutor(max_workers=3) as pool:
                commits = list(pool.map(step, range(3)))
            launches = dict(quantization.LAUNCHES)
        finally:
            for m in managers:
                m.shutdown()
                m._pg.shutdown()
    finally:
        lh.shutdown()
    if not all(commits):
        raise AssertionError(f"int4: commits {commits}")
    if dev.type == "cuda":
        for kernel in QUANT_KERNELS:
            if launches[kernel] != 3 * chunks:
                raise AssertionError(f"int4: {kernel} launched {launches[kernel]} times, want "
                                     f"{3 * chunks} ({chunks} chunks per replica)")
    order = sorted(range(3), key=lambda r: ranks[r])

    def host_average(bits: int) -> np.ndarray:
        acc = np.zeros(n, np.float32)
        for r in order:
            x = leaves[r].cpu().numpy()
            acc += dequantize_blockwise(*quantize_blockwise(x, bits), n, bits)
        return dequantize_blockwise(*quantize_blockwise(acc, bits), n, bits) * np.float32(1 / 3)

    want4, want8 = host_average(4), host_average(8)
    for r in range(3):
        got = results[r].cpu().numpy()
        differ = int((got.view(np.int32) != want4.view(np.int32)).sum())
        if differ:
            raise AssertionError(f"int4: replica {r} differs from the host quantizer's int4 "
                                 f"average in {differ} of {n} values")
    int8_differ = int((results[0].cpu().numpy().view(np.int32) != want8.view(np.int32)).sum())
    if not int8_differ:
        raise AssertionError("int4: the planted int8 reference equals the int4 result")
    out["scenarios"]["int4"] = {"wall_s": round(time.monotonic() - t0, 2),
                                "commits": [int(c) for c in commits], "failed": [0, 0, 0],
                                "heal_bytes": [[], [], []], "n": n, "chunks": chunks,
                                "int8_reference_differs_in": int8_differ}
    out["launches"] = {k: launches[k] for k in QUANT_KERNELS}
    out["wall_s"] = round(time.monotonic() - t_phase, 1)
    print("manager scenarios ok: " + "; ".join(
        f"{tag} {sc['wall_s']} s, commits {sc['commits']}, failed {sc['failed']}, heal bytes "
        f"{sc['heal_bytes']}" for tag, sc in out["scenarios"].items())
        + f"; parameters {state_bytes} B a replica; int4 launches {out['launches']} "
        f"({chunks} chunks a replica), the int8 reference differs in {int8_differ} values; "
        f"wall {out['wall_s']} s (budget {SCENARIO_BUDGET_S:g} s)", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "manager_scenarios.json").write_text(json.dumps(out, indent=1))
    if out["wall_s"] > SCENARIO_BUDGET_S:
        raise AssertionError(f"phase 20a took {out['wall_s']} s, over its budget")
    return out


# ---------------------------------------------------------------------------
# Phase 21: tensor and expert parallelism across two ranks on one card
# ---------------------------------------------------------------------------

# The fp32 bars (the FMA kernel bodies): those of the CPU tests against the
# JAX package (tests/test_torch_tp_ep.py): the loss to rtol 1e-5, every
# gradient leaf's largest difference over its largest |value| to 1e-4.
TP_FP32 = {"loss": 1e-5, "grad": 1e-4}
# The bf16 bars (the tensor-core bodies), on the same statistics, set from
# readings. The split run rounds at other places than the whole one (each
# sum over the ranks adds partials already rounded to bf16), and bf16 keeps
# 8 significant bits: 2^-8 between two roundings of a value. Sound runs on
# the card read at most 2.34e-5 on the loss and 0.0160 (about 4 x 2^-8) on
# a gradient leaf, the CPU rehearsal 2.23e-5 and 0.0094; the planted fault
# reads 2.34e-4 on the loss and 1.95 on the gradients on the card, 1.11e-3
# and 1.57 on the CPU (PERF.md, PR 17). The bars: 2^-14 = 6.1e-5 on the
# loss, 2.6 times its largest sound reading and a 3.8th of the fault's
# smallest, and 16 x 2^-8 = 2^-4 on the gradients, 3.9 times its largest
# sound reading and a 25th of the fault's smallest. The fault must fail
# both.
TP_BF16 = {"loss": 2.0**-14, "grad": 2.0**-4}
ADAMW_LR, ADAMW_EPS = 3e-4, 1e-8


def adamw_excess(got, want, g_got, g_want) -> float:
    """The largest |got - want| past its bound, over every element, after
    one AdamW step (``default_optimizer``) from equal parameters with the
    gradients ``g_got`` and ``g_want``. The first step moves a parameter by
    lr * g / (|g| + eps) besides the decay, which is the same on both
    sides; that function's slope is eps / (|g| + eps)^2, so two gradients
    whose smaller magnitude is m and whose signs agree move it by at most
    |dg| eps / (m + eps)^2 apart, and by at most |dg| / eps (m = 0) where
    the signs differ; never by more than 2. The bound: 1e-5 (fp32
    rounding) plus lr times that. It holds the elements whose gradient
    cancelled to rounding noise below eps as well, where
    tests/test_torch_fsdp.py's ``_adamw_close`` allows 2 lr and bounds
    their count instead (one in 10,000 at llama_debug)."""
    import torch

    dg = (g_got - g_want).abs()
    same = torch.sign(g_got) == torch.sign(g_want)
    m = torch.where(same, torch.minimum(g_got.abs(), g_want.abs()), 0.0)
    move = (dg * ADAMW_EPS / (m + ADAMW_EPS) ** 2).clamp_max(2.0)
    return float(((got - want).abs() - 1e-5 - ADAMW_LR * move).clamp_min(0).max())


# (family, dtype, mesh axis at 2) of phase 21's cases: the dense model
# (llama_small on the card, llama_debug in the CPU rehearsal) at tp 2 and
# llama_moe_debug at ep 2, each in fp32 and bf16.
TP_EP_CASES = [(family, dtype, axis)
               for family, axis in (("dense", "tp"), ("moe", "ep"))
               for dtype in ("float32", "bfloat16")]
# The JAX trainer's MoE mesh for eight devices (train_hsdp.py: fsdp 2 x ep
# 2 x tp 2; group_mesh(8, ..., "moe")) and its cases: llama_moe_debug in
# fp32 and bf16, in a world of eight ranks of its own.
MOE_EP_TP_MESH = {"fsdp": 2, "ep": 2, "tp": 2}
MOE_EP_TP_AXIS = " x ".join(f"{a} {n}" for a, n in MOE_EP_TP_MESH.items())
MOE_EP_TP_CASES = [("moe", dtype, MOE_EP_TP_AXIS) for dtype in ("float32", "bfloat16")]
# Sequence and pipeline parallelism across the two ranks: the dense model
# at sp 2 with the default attention (the flash setting on the card: k and
# v gathered, the blocks folded by the offset-block kernels), ring and
# Ulysses, and at pp 2 (llama_small: 6 layers a stage; 2 microbatches).
SP_PP_CASES = [(family, dtype, axis)
               for family, axis in (("default", "sp"), ("ring", "sp"),
                                    ("ulysses", "sp"), ("pipeline", "pp"))
               for dtype in ("float32", "bfloat16")]
# The planted fault of each family, run in fp32 on the first step: each
# must fail the loss and the gradient bars. dense: every wo's two tp
# shards swapped; default and Ulysses: rank 1's RoPE positions start at 0;
# ring: a hop that moves no block (each rank folds its own twice);
# pipeline: stage 0 sends zeros for its last microbatch; the MoE model at
# ep x tp: each rank takes its first expert from its tp rank, not its ep
# rank. The tp and the ep x tp faults must fail both bars.
PLANTED_FAULTS = {
    "dense": "wo's tp shards swapped",
    f"moe {MOE_EP_TP_AXIS}": "the first expert from the tp rank",
    "default": "RoPE offset 0 on rank 1",
    "ulysses": "RoPE offset 0 on rank 1",
    "ring": "a ring hop that skips a block",
    "pipeline": "stage 0 drops its last microbatch",
}
# The pipeline's bars: its stages run the one rank's arithmetic, and the
# sums over pp add zeros, so it must be bit for bit in both dtypes.
PP_BARS = {"loss": 0.0, "grad": 0.0}
# Phase 21's wall: 117.8-125.7 s on the card with the sp and pp cases,
# 35.0-52.2 s for the tp and ep cases alone (PERF.md §6).
TP_EP_BUDGET_S = 150.0


def case_name(family: str, dtype: str, axis: str) -> str:
    return f"{family} {dtype} {axis}" if axis == MOE_EP_TP_AXIS else f"{family} {dtype} {axis}=2"


def fault_key(family: str, axis: str) -> str:
    """The case's key in ``PLANTED_FAULTS`` (absent: no planted fault)."""
    return f"{family} {axis}" if axis == MOE_EP_TP_AXIS else family


def case_bars(family: str, dtype: str) -> dict:
    if family == "pipeline":
        return PP_BARS
    return TP_FP32 if dtype == "float32" else TP_BF16


def gather_full(t):
    """The whole value of DTensor ``t`` on every rank of the world, through
    c10d's ``all_gather_into_tensor`` of each rank's shard and its offsets
    (every shard the same shape, as the plan's even splits give).
    ``full_tensor()`` goes through DTensor's functional collectives, which
    never returned for a gloo world's CUDA tensors on the card (PERF.md,
    PR 17)."""
    import torch
    import torch.distributed as dist

    from torchft_tpu_torch.parallel.sharding import local_slices

    local = t.to_local().contiguous()
    world = dist.get_world_size()
    shards = local.new_empty((world * local.shape[0],) + tuple(local.shape[1:]))
    dist.all_gather_into_tensor(shards, local)
    starts = torch.tensor([s.start for s in local_slices(t)], dtype=torch.int64)
    every = starts.new_empty(world * starts.numel())
    dist.all_gather_into_tensor(every, starts)
    full = local.new_empty(tuple(t.shape))
    for r, shard in enumerate(shards.chunk(world)):
        at = every.view(world, -1)[r].tolist()
        full[tuple(slice(o, o + n) for o, n in zip(at, local.shape))] = shard
    return full


def plant_fault(family: str, rank: int):
    """Installs the planted fault (``PLANTED_FAULTS``) of the case whose
    :func:`fault_key` is ``family`` in this rank's process; returns the
    function that removes it."""
    import torch
    import torch.distributed as dist

    from torchft_tpu_torch.models.llama import MoEMLP, Transformer
    from torchft_tpu_torch.parallel import pipeline, ring_attention

    if family == f"moe {MOE_EP_TP_AXIS}":
        saved = MoEMLP.first_expert
        MoEMLP.first_expert = lambda self, n: n * dist.get_rank(self.tp_group)
        return lambda: setattr(MoEMLP, "first_expert", saved)
    if family in ("default", "ulysses"):
        saved = Transformer.sequence_offset
        Transformer.sequence_offset = lambda self, n: 0
        return lambda: setattr(Transformer, "sequence_offset", saved)
    if family == "ring":
        saved = ring_attention.ring_hop
        ring_attention.ring_hop = lambda group: (lambda k, v: (k, v))
        return lambda: setattr(ring_attention, "ring_hop", saved)
    if family == "pipeline":
        cls = pipeline._SendNext
        send = cls.apply  # torch.autograd.Function's, bound to the class

        def drop_last(y, group, peer, tag):
            # The graph stays whole (y * 0), so the backward's receives
            # still pair with stage 1's sends.
            return send(y * 0 if tag == 1 else y, group, peer, tag)

        cls.apply = staticmethod(drop_last)
        return lambda: delattr(cls, "apply")
    raise ValueError(family)


def gloo_answers(dev) -> dict:
    """Whether the world's gloo takes ``all_to_all_single`` and
    point-to-point ``send``/``recv`` of ``dev``'s tensors (the port calls
    the first as it is and stages the second through the host where gloo
    carries the card's tensors, chosen by the backend): each tried once on
    4 floats, all-to-all first. An error is the answer; a crash ends the
    process (the caller reads the missing answer)."""
    import torch
    import torch.distributed as dist

    rank = dist.get_rank()
    out = {}
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
    try:
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        want = torch.tensor([0, 1, 10, 11] if rank == 0 else [2, 3, 12, 13],
                            dtype=torch.float32)
        out["all_to_all_single"] = "ok" if torch.equal(y.cpu(), want) else f"wrong: {y.tolist()}"
    except Exception as e:  # noqa: BLE001 - the probe's answer
        out["all_to_all_single"] = f"refused: {type(e).__name__}: {str(e)[:160]}"
    try:
        if rank == 0:
            dist.send(x, 1)
            out["send_recv"] = "sent"
        else:
            y = torch.zeros_like(x)
            dist.recv(y, 0)
            out["send_recv"] = "ok" if torch.equal(y.cpu(), torch.arange(4.0)) else f"wrong: {y.tolist()}"
    except Exception as e:  # noqa: BLE001 - the probe's answer
        out["send_recv"] = f"refused: {type(e).__name__}: {str(e)[:160]}"
    return out


def case_mesh(axis: str, world: int, rank: int, dev):
    """The mesh of a case, as seen by ``rank`` of a world of ``world``:
    ``make_mesh(<axis>=2)``, or ``MOE_EP_TP_MESH``."""
    from torchft_tpu_torch.parallel import make_mesh

    axes = MOE_EP_TP_MESH if axis == MOE_EP_TP_AXIS else {axis: 2}
    mesh = make_mesh(**axes, devices=[dev] * world)
    mesh.process_rank = rank
    return mesh


def tp_ep_rank(spec: dict) -> None:
    """One rank of one of phase 21's worlds (``spec``: rank, world, init,
    device, model, out, cases). Joins a gloo world that carries the
    device's tensors (NCCL refuses two ranks on one card) before
    ``init_group``, which then returns at once; per case:
    ``init_train_state`` at the case's mesh (:func:`case_mesh`) and two
    steps (``make_train_step``; the pipeline's
    ``make_grad_step`` with ``make_pipeline_loss`` and an AdamW step),
    counting the flash and block kernels' launches; each family's planted
    fault in fp32 on one step, from the same state's first parameters
    (:func:`case_runner`). Rank 0 then runs the same two steps on one
    rank (the mesh-free model of the same seed, whole-sequence flash
    attention; the pipeline's one-rank schedule), once per reference and
    dtype, and writes the differences to ``out/rank0.json``; every rank
    writes its launches to ``out/rank<r>.json``."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from torchft_tpu_torch.models import llama_debug, llama_moe_debug, llama_small
    from torchft_tpu_torch.ops import flash_attention
    from torchft_tpu_torch.parallel import make_mesh, make_pipeline_loss
    from torchft_tpu_torch.parallel.mesh import init_group
    from torchft_tpu_torch.parallel.pipeline import gather_stages
    from torchft_tpu_torch.parallel.train import (
        build_model,
        default_optimizer,
        grad_step,
        init_train_state,
        make_grad_step,
        make_train_step,
    )

    from datetime import timedelta

    rank, world, dev = spec["rank"], spec["world"], torch.device(spec["device"])
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # A collective that never completes fails at the timeout, with its
    # traceback in the rank's log, inside the phase's budget.
    dist.init_process_group(
        "cpu:gloo,cuda:gloo" if dev.type == "cuda" else "gloo",
        init_method=spec["init"], rank=rank, world_size=world,
        timeout=timedelta(seconds=60),
    )
    init_group(dev)
    # The collectives the plan's sums, FSDP2 and the checks' gathers run,
    # on the device's tensors: each must be taken and give the exact sums.
    total = world * (world + 1) / 2
    one = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(one)
    every = one.new_empty(4 * world)
    dist.all_gather_into_tensor(every, one)
    part = one.new_empty(4)
    dist.reduce_scatter_tensor(part, every)
    if not (one.eq(total).all() and every.eq(total).all() and part.eq(world * total).all()):
        raise AssertionError(f"gloo collectives on {dev}: {one}, {every}, {part}")
    print(f"rank {rank}: all_reduce, all_gather_into_tensor and "
          f"reduce_scatter_tensor exact on {dev}", flush=True)
    small = spec["model"] == "small"
    dense = (dataclasses.replace(llama_small(), attn_impl="flash", flash_min_seq=1024)
             if small else llama_debug())
    shapes = {"dense": (8, 1024 if small else 64), "moe": (8, 64)}
    kernels = FLASH_KERNELS + BLOCK_KERNELS
    out = {"launches": {}, "diff": {}, "loss": {}}
    refs = {}

    def batch(shape: tuple, k: int, vocab: int) -> dict:
        B, S = shape
        g = torch.Generator(device=dev).manual_seed(k)
        x = torch.randint(0, vocab, (B, S), generator=g, device=dev)
        return {"inputs": x, "targets": torch.roll(x, -1, 1),
                "mask": torch.ones_like(x, dtype=torch.int32)}

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def case_cfg(family: str, dtype: str):
        base = llama_moe_debug() if family == "moe" else dense
        if family in ("ring", "ulysses"):
            base = dataclasses.replace(base, attn_impl=family)
        return dataclasses.replace(base, dtype=getattr(torch, dtype), remat=False)

    def case_runner(family: str, cfg, mesh, axis: str):
        """``run(batches, fault=False) -> (losses, first step's gradients,
        parameters after it)``, gathered whole, of the case's steps on one
        state made here: each call starts from the state's first
        parameters with a fresh AdamW, so the planted fault's run needs no
        state of its own. Over sp every rank holds the whole model, so
        this rank's own tensors are the whole ones."""
        state, _ = init_train_state(cfg, mesh, dev, seed=0)
        born = [p.detach().to_local().clone() for p in state.model.parameters()]
        if family == "pipeline":
            grad = make_grad_step(state, make_pipeline_loss(cfg, mesh, n_micro=2))

            def step(state, b):
                loss, _ = grad(b)
                state.optimizer.step()
                return state, {"loss": loss}

            whole = lambda named: gather_stages(  # noqa: E731
                {n: t.to_local() for n, t in named.items()}, mesh, cfg.num_layers
            )
        else:
            step = make_train_step(state)
            if axis == "sp":
                whole = lambda named: {n: t.to_local().clone() for n, t in named.items()}  # noqa: E731
            else:
                whole = lambda named: {n: gather_full(t) for n, t in named.items()}  # noqa: E731

        def run(batches, fault: bool = False):
            with torch.no_grad():
                for p, b in zip(state.model.parameters(), born):
                    p.detach().to_local().copy_(b)
            state.optimizer.state.clear()
            if family == "dense" and fault:
                # Each rank computes with the other rank's block of every
                # wo's input columns.
                with torch.no_grad():
                    for block in state.model.layers.values():
                        w = block.attn.wo.weight
                        full, local = gather_full(w), w.to_local()
                        n = local.shape[1]
                        local.copy_(full[:, (1 - rank) * n:(2 - rank) * n])
            losses, g1, p1 = [], None, None
            for b in batches:
                _, m = step(state, b)
                losses.append(float(m["loss"]))
                if g1 is None:
                    named = list(state.model.named_parameters())
                    g1 = whole({n: p.grad for n, p in named})
                    p1 = whole({n: p.detach() for n, p in named})
            return losses, g1, p1

        return run

    def reference(family: str, cfg, batches):
        """The one-rank steps of the same seed (rank 0 only)."""
        torch.manual_seed(0)
        model = build_model(dataclasses.replace(
            cfg, attn_impl="flash" if small else "dense"
        ) if family in ("ring", "ulysses") else cfg).to(dev)
        opt = default_optimizer(model.parameters())
        loss_fn = None
        if family == "pipeline":
            one = make_mesh(devices=[dev])
            loss_fn = make_pipeline_loss(cfg, one, n_micro=2)
        losses, g1, p1 = [], None, None
        for b in batches:
            loss, grads = grad_step(model, b, loss_fn)
            losses.append(float(loss))
            if g1 is None:
                g1 = {n: g.clone() for n, g in grads.items()}
                opt.step()
                p1 = {n: p.detach().clone() for n, p in model.named_parameters()}
        return losses, g1, p1

    try:
        for family, dtype, axis in spec["cases"]:
            name = case_name(family, dtype, axis)
            print(f"rank {rank}: {name}", flush=True)
            cfg = case_cfg(family, dtype)
            shape = shapes["moe" if family == "moe" else "dense"]
            b1, b2 = (batch(shape, k, cfg.vocab_size) for k in (0, 1))
            mesh = case_mesh(axis, world, rank, dev)
            for k in flash_attention.LAUNCHES:
                flash_attention.LAUNCHES[k] = 0
            sync()
            t0 = time.perf_counter()
            run = case_runner(family, cfg, mesh, axis)
            got, g1, p1 = run((b1, b2))
            sync()
            step_s = time.perf_counter() - t0
            out["launches"][name] = {k: flash_attention.LAUNCHES[k] for k in kernels}
            fault = None
            planted = fault_key(family, axis)
            if planted in PLANTED_FAULTS and (family == "dense" or dtype == "float32"):
                undo = plant_fault(planted, rank) if family != "dense" else (lambda: None)
                try:
                    fl, fg, _ = run((b1,), fault=True)
                finally:
                    undo()
                fault = (fl[0], fg)
            del run
            if rank == 0:
                key = (
                    "moe" if family == "moe"
                    else "pipeline" if family == "pipeline" else "dense", dtype,
                )
                if key not in refs:
                    refs[key] = reference(family, cfg, (b1, b2))
                want, r_g1, r_p1 = refs[key]
                out["diff"][name] = {
                    "loss": max(abs(a - b) / abs(b) for a, b in zip(got, want)),
                    "grad": rel_diff(g1, r_g1),
                    "adamw_excess": max(
                        adamw_excess(p1[n], r_p1[n], g1[n], r_g1[n]) for n in r_p1
                    ),
                    "router_grad_l1": sum(
                        float(g1[n].abs().sum()) for n in g1 if "router" in n
                    ),
                    "fault_loss": None if fault is None else abs(fault[0] - want[0]) / abs(want[0]),
                    "fault_grad": None if fault is None else rel_diff(fault[1], r_g1),
                    "first_step_s": step_s,
                }
                out["loss"][name] = {"ranks": got, "one": want}
            del g1, p1, fault
        (Path(spec["out"]) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def gloo_probe_rank(spec: dict) -> None:
    """One rank of phase 21's probe pair (``spec``: rank, init, device,
    out): joins a two-rank ``cpu:gloo,cuda:gloo`` world of its own and
    writes :func:`gloo_answers` to ``out/gloo<r>.json``. A crash in the
    probe leaves no file: that is its answer."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    rank, dev = spec["rank"], torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "cpu:gloo,cuda:gloo" if dev.type == "cuda" else "gloo",
        init_method=spec["init"], rank=rank, world_size=2,
        timeout=timedelta(seconds=30),
    )
    try:
        answers = gloo_answers(dev)
        (Path(spec["out"]) / f"gloo{rank}.json").write_text(json.dumps(answers))
    finally:
        dist.destroy_process_group()


def tp_ep_check(device: str = "cuda:0", model: str = "small", timeout_s: float = 240.0,
                cases=tuple(TP_EP_CASES), moe_cases=()) -> dict:
    """Phase 21's check (on the CPU: its rehearsal at llama_debug's size)
    over ``cases`` in a world of two ranks of :func:`tp_ep_rank` and
    ``moe_cases`` (``MOE_EP_TP_CASES``) in a world of eight beside it,
    each rank a process of its own; then each case's differences held to
    its bars: the loss (both steps) and the first step's gradients in fp32
    to ``TP_FP32``, bf16 to ``TP_BF16``, the pipeline bit for bit
    (``PP_BARS``); every case's parameters after the first AdamW step to
    the bound of ``adamw_excess``, every element; each planted fault must
    exceed its loss or gradient bar (the tp and the ep x tp faults both);
    the MoE router's gradient must be nonzero; and on the card
    (llama_small), the flash kernels must launch in both ranks of the
    dense cases at tp 2, Ulysses' and the pipeline's, the block kernels in
    the default and ring cases at sp 2; every rank must exit 0. Returns
    the cases' differences, bars, losses and launches, each world's wall,
    and the answers of the probe pair (:func:`gloo_probe_rank`, run beside
    the two-rank world; a probe rank that died leaves none: that is its
    answer)."""
    import shutil
    import socket
    import tempfile

    n_moe = math.prod(MOE_EP_TP_MESH.values())
    worlds = {n: [tuple(c) for c in cs] for n, cs in ((2, cases), (n_moe, moe_cases)) if cs}
    work = Path(tempfile.mkdtemp(prefix="tp_ep_", dir=REPO / "build"
                                 if (REPO / "build").is_dir() else None))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONUNBUFFERED": "1",
           # A crash in native code prints its Python stack to the log.
           "PYTHONFAULTHANDLER": "1",
           "PYTHONPATH": os.pathsep.join(
               p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p)}

    def start(target: str, name: str, spec: dict):
        log = open(work / f"{name}.log", "w")
        return subprocess.Popen(
            [sys.executable, "-c",
             f"import json, sys, chip_smoke; chip_smoke.{target}(json.loads(sys.argv[1]))",
             json.dumps(spec)],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT, env=env,
        ), log

    def logs(world: int) -> str:
        tail = 3000 if world == 2 else 1200
        return "\n".join(f"world {world} rank {r}: "
                         + (work / f"w{world}rank{r}.log").read_text()[-tail:]
                         for r in range(world))

    def free_ports(n: int) -> list:
        socks = [socket.socket() for _ in range(n)]
        try:
            for sock in socks:
                sock.bind(("localhost", 0))
            return [f"tcp://localhost:{sock.getsockname()[1]}" for sock in socks]
        finally:
            for sock in socks:
                sock.close()

    procs, probes = {}, []
    answers, walls = {}, {}
    try:
        inits = free_ports(len(worlds) + 1)
        t0 = time.monotonic()
        for (world, world_cases), init in zip(worlds.items(), inits):
            (work / f"w{world}").mkdir()
            for rank in range(world):
                procs[(world, rank)] = start("tp_ep_rank", f"w{world}rank{rank}", {
                    "rank": rank, "world": world, "init": init, "device": device,
                    "model": model, "out": str(work / f"w{world}"), "cases": world_cases,
                })
        # The probe pair runs beside the cases, in a world of its own.
        for rank in (0, 1):
            probes.append(start("gloo_probe_rank", f"probe{rank}", {
                "rank": rank, "init": inits[-1], "device": device, "out": str(work),
            }))
        deadline = t0 + timeout_s
        ended = {}
        while len(ended) < len(procs):
            for key, (proc, _) in procs.items():
                if key not in ended and proc.poll() is not None:
                    ended[key] = time.monotonic()
                    if proc.returncode != 0:
                        raise AssertionError(f"phase 21: world {key[0]} rank {key[1]} "
                                             f"exited {proc.returncode}:\n" + logs(key[0]))
            if time.monotonic() > deadline:
                late = sorted(set(procs) - set(ended))
                raise AssertionError(f"phase 21: {late} still running after "
                                     f"{timeout_s:g} s:\n" + logs(late[0][0]))
            time.sleep(0.1)
        walls = {world: max(ended[(world, r)] for r in range(world)) - t0 for world in worlds}
        ranks = {world: [json.loads((work / f"w{world}" / f"rank{r}.json").read_text())
                         for r in range(world)] for world in worlds}
        for r, (proc, _) in enumerate(probes):
            try:
                rc = proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                rc = None
            probe = work / f"gloo{r}.json"
            if probe.exists():
                answers[r] = json.loads(probe.read_text())
            else:
                said = [line for line in (work / f"probe{r}.log").read_text().splitlines()
                        if re.search(r"terminate|what\(\)|enforce|Error|Fatal|Abort", line)]
                answers[r] = {"died": f"probe rank {r} ended "
                              f"({'still running' if rc is None else f'exit {rc}'}): "
                              + " | ".join(said[-4:])[-600:]}
    finally:
        for proc, log in list(procs.values()) + probes:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(work, ignore_errors=True)
    result = {"cases": {}, "gloo": answers, "world_wall_s": walls, "launches": {
        k: sum(r["launches"][n][k] for rs in ranks.values() for r in rs for n in r["launches"])
        for k in FLASH_KERNELS + BLOCK_KERNELS
    }}
    print(f"gloo on {device} (a cpu:gloo,cuda:gloo world): " + json.dumps(answers), flush=True)
    print("phase 21 worlds' walls: " + ", ".join(
        f"{world} ranks {wall:.1f} s" for world, wall in walls.items()), flush=True)
    failed = []
    for world, world_cases in worlds.items():
        for family, dtype, axis in world_cases:
            name = case_name(family, dtype, axis)
            d = ranks[world][0]["diff"][name]
            bar = case_bars(family, dtype)
            launches = [r["launches"][name] for r in ranks[world]]
            planted = fault_key(family, axis)
            result["cases"][name] = {**d, "bar": bar, "launches": launches, "world": world,
                                     "loss_pair": ranks[world][0]["loss"][name]}
            print(f"{name} ({world} ranks): loss {d['loss']:.3g} (bar {bar['loss']:.3g}), "
                  f"worst gradient {d['grad']:.3g} of its leaf's largest (bar "
                  f"{bar['grad']:.3g}), AdamW excess {d['adamw_excess']:.3g}"
                  + (f", planted fault ({PLANTED_FAULTS[planted]}): loss "
                     f"{d['fault_loss']:.3g}, gradient {d['fault_grad']:.3g}"
                     if d["fault_grad"] is not None else "")
                  + (f", router gradient L1 {d['router_grad_l1']:.4g}" if family == "moe" else "")
                  + f", first step {d['first_step_s']:.2f} s; losses "
                  f"{ranks[world][0]['loss'][name]}; launches per rank "
                  + (f"{launches}" if world == 2 else f"{launches[0]} (rank 0)"),
                  flush=True)
            if d["loss"] > bar["loss"] or d["grad"] > bar["grad"]:
                failed.append(f"{name} past its bars: {d} vs {bar}")
            if d["adamw_excess"] > 0:
                failed.append(f"{name} parameters past the AdamW bound: {d}")
            if d["fault_grad"] is not None:
                past = (d["fault_loss"] > bar["loss"], d["fault_grad"] > bar["grad"])
                # The tp and ep x tp faults must fail both bars (PERF.md
                # §6); the others must fail the case's check, which one bar
                # past does.
                both = family == "dense" or axis == MOE_EP_TP_AXIS
                if not (all(past) if both else any(past)):
                    failed.append(
                        f"{name}: the planted fault ({PLANTED_FAULTS[planted]}) passes "
                        f"the bars (loss {d['fault_loss']:.3g}, gradient "
                        f"{d['fault_grad']:.3g}; bars {bar})"
                    )
            if planted in PLANTED_FAULTS and dtype == "float32" and d["fault_grad"] is None:
                failed.append(f"{name}: no planted fault ran")
            if family == "moe" and not d["router_grad_l1"] > 0:
                failed.append(f"{name}: router gradient {d['router_grad_l1']}")
            if model == "small" and family != "moe":
                want = BLOCK_KERNELS if family in ("default", "ring") else FLASH_KERNELS
                if not all(r[k] > 0 for r in launches for k in want):
                    failed.append(f"{name}: a kernel of {want} did not launch: {launches}")
    if failed:
        raise AssertionError("phase 21: " + "; ".join(failed))
    return result


def tp_ep_phase() -> dict:
    """Phase 21 on the card: :func:`tp_ep_check` at llama_small's full
    width over ``TP_EP_CASES`` and ``SP_PP_CASES`` in a world of two ranks
    and ``MOE_EP_TP_CASES`` in a world of eight beside it; prints the wall
    time, which must stay under ``TP_EP_BUDGET_S``."""
    t0 = time.perf_counter()
    result = tp_ep_check("cuda:0", "small", timeout_s=TP_EP_BUDGET_S + 60,
                         cases=TP_EP_CASES + SP_PP_CASES, moe_cases=MOE_EP_TP_CASES)
    result["wall_s"] = time.perf_counter() - t0
    (OUT / "tp_ep.json").write_text(json.dumps(result, indent=1))
    print(f"tp/ep/sp/pp ok in {result['wall_s']:.1f} s (budget {TP_EP_BUDGET_S:g} s); "
          f"flash and block launches over both ranks {result['launches']}", flush=True)
    if result["wall_s"] > TP_EP_BUDGET_S:
        raise AssertionError(f"phase 21 took {result['wall_s']:.1f} s")
    return result


# ---------------------------------------------------------------------------
# The drills side by side
# ---------------------------------------------------------------------------

# Each phase's wall, seconds, by name; printed before the kernels line.
PHASE_WALLS: dict = {}
# The phase each thread of this process is in, by thread name: the host
# watch stamps its wake-ups with it.
RUNNING: dict = {}


def walled(name: str, fn, *args):
    """``fn(*args)``, its wall seconds kept in ``PHASE_WALLS[name]``."""
    import threading

    thread = threading.current_thread().name
    RUNNING[thread] = name
    t0 = time.monotonic()
    try:
        return fn(*args)
    finally:
        PHASE_WALLS[name] = round(time.monotonic() - t0, 1)
        RUNNING.pop(thread, None)


# ---------------------------------------------------------------------------
# The host watch
# ---------------------------------------------------------------------------

# The watch sleeps WATCH_PERIOD_S at a time and records how late each sleep
# woke: a host-wide stall delays every thread, this one too. Every
# WATCH_READ_S, and after every wake-up later than WATCH_STALL_S, it reads
# the host's state (``read_host``). The lighthouse's evidence budget is
# 1.2 s (``hb_interval_ms`` times ``evict_mult``, floored at
# ``evict_floor_ms``: torchft_tpu/_cpp/lighthouse.cc:1375-1377), so a stall
# of that length turns into an ``hb_lapse``.
WATCH_PERIOD_S = 0.1
WATCH_READ_S = 1.0
WATCH_STALL_S = 0.5
EVIDENCE_BUDGET_S = 1.2
MEMINFO_KEYS = ("MemAvailable", "SwapFree", "Dirty", "Writeback", "Shmem")
PRESSURE_KINDS = ("cpu", "memory", "io")
def _pressure(text: str) -> dict:
    """``/proc/pressure/<kind>`` as {"some": {"avg10", "total"}, "full": ...}."""
    out = {}
    for line in text.splitlines():
        kind, *fields = line.split()
        vals = dict(f.split("=", 1) for f in fields)
        out[kind] = {"avg10": float(vals["avg10"]), "total": int(vals["total"])}
    return out


def read_host(proc: Path = Path("/proc")) -> dict:
    """The host's state, read only: ``loadavg`` (the 1, 5 and 15 minute
    loads and running/total tasks), ``pressure`` ({cpu, memory, io}: some
    and full avg10 and total µs; None where ``/proc/pressure`` is absent),
    ``meminfo`` (``MEMINFO_KEYS`` in kB) and ``self`` (this process's CPU
    seconds, resident kB and threads)."""
    out: dict = {}
    out["loadavg"] = (proc / "loadavg").read_text().split()[:4]
    pressure = {}
    for kind in PRESSURE_KINDS:
        try:
            pressure[kind] = _pressure((proc / "pressure" / kind).read_text())
        except OSError:
            pass
    out["pressure"] = pressure or None
    meminfo = {}
    for line in (proc / "meminfo").read_text().splitlines():
        key, _, rest = line.partition(":")
        if key in MEMINFO_KEYS:
            meminfo[key] = int(rest.split()[0])
    out["meminfo"] = meminfo
    # This process's own share: resident memory, threads, CPU seconds.
    own = {"cpu_s": round(sum(os.times()[:2]), 2)}
    try:
        for line in (proc / "self" / "status").read_text().splitlines():
            key, _, rest = line.partition(":")
            if key in ("VmRSS", "Threads"):
                own[key] = int(rest.split()[0])
    except OSError:
        pass
    out["self"] = own
    return out


class HostWatch:
    """A thread that records how late each of its sleeps wakes, with the
    host's state and the phases running (``RUNNING``). ``clock`` and
    ``sleep`` are the monotonic clock and the sleep it measures, ``wall``
    the epoch clock the lighthouse's records use, ``read`` the host reader
    and ``extra`` a callable whose dict joins each reading (the card's
    memory)."""

    def __init__(self, period: float = WATCH_PERIOD_S, read_every: float = WATCH_READ_S,
                 clock=time.monotonic, sleep=time.sleep, wall=time.time,
                 read=read_host, extra=None) -> None:
        self.period, self.read_every = period, read_every
        self._clock, self._sleep, self._wall = clock, sleep, wall
        self._read, self._extra = read, extra
        self.wakes: list = []      # (epoch s, late s, phases)
        self.readings: list = []   # (epoch s, host state)
        self._last_read = None
        self._stop = None
        self._thread = None

    def reading(self) -> dict:
        host = self._read()
        if self._extra is not None:
            host.update(self._extra())
        return host

    def tick(self) -> float:
        """One sleep: records its lateness (and reads the host when due);
        returns the lateness in seconds."""
        t0 = self._clock()
        self._sleep(self.period)
        late = max(0.0, self._clock() - t0 - self.period)
        now = self._wall()
        self.wakes.append((now, late, tuple(sorted(set(RUNNING.values())))))
        if (self._last_read is None or now - self._last_read >= self.read_every
                or late >= WATCH_STALL_S):
            self._last_read = now
            try:
                self.readings.append((now, self.reading()))
            except Exception as e:  # noqa: BLE001 - the watch must outlive a bad read
                self.readings.append((now, {"error": repr(e)}))
        return late

    def _run(self) -> None:
        while not self._stop.is_set():
            self.tick()

    def start(self) -> "HostWatch":
        import threading

        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="host-watch", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(5)

    def near(self, at: float) -> dict:
        """The first reading taken at or after ``at`` (a stall delays the
        reading too, so it sees the host as the stall left it), else the
        last one; None before any."""
        for ts, host in self.readings:
            if ts >= at:
                return host
        return self.readings[-1][1] if self.readings else None

    def phases_at(self, at: float) -> tuple:
        """The phases running at the wake-up nearest ``at``."""
        if not self.wakes:
            return ()
        return min(self.wakes, key=lambda w: abs(w[0] - at))[2]

    def worst(self, n: int = 5) -> list:
        """The ``n`` latest wake-ups, latest first, each with the host's
        state right after it and the phases then running."""
        ranked = sorted(self.wakes, key=lambda w: -w[1])[:n]
        return [{"at": round(ts, 3), "late_s": round(late, 3), "phases": list(phases),
                 "host": self.near(ts)} for ts, late, phases in ranked]

    def stalls(self, limit: float = WATCH_STALL_S) -> int:
        return sum(1 for _, late, _ in self.wakes if late >= limit)

    def summary(self) -> str:
        """The line the smoke prints: how many wake-ups, how many late past
        ``WATCH_STALL_S`` and past the evidence budget, whether
        ``/proc/pressure`` was there, and the five worst."""
        first = self.readings[0][1] if self.readings else {}
        pressure = ("present" if first.get("pressure") else "absent (no PSI on this kernel)")
        return (f"host watch: {len(self.wakes)} wake-ups of {self.period:g} s, "
                f"{self.stalls()} late by >= {WATCH_STALL_S:g} s, "
                f"{self.stalls(EVIDENCE_BUDGET_S)} by >= {EVIDENCE_BUDGET_S:g} s "
                f"(the evidence budget); /proc/pressure {pressure}; five worst "
                + json.dumps(self.worst(5)))


# The watch over ``drill_phases``, for phase 20's lighthouse records.
HOST_WATCH = None


def flash_path_phase() -> tuple:
    """Phase 6: the flash drill under ``TORCHFT_PERF=1``, held to the
    mesh-free trainer's parameters, its HTTP heal and its perf lines.
    Returns (the drill's results, the heal's journal record)."""
    path = path_phase(
        "path", PATH_ARGS, FLASH_KERNELS,
        env={**journal_env("path"), "TORCHFT_PERF": "1"},
    )
    if path[0]["param_sha256"] != MESH_FREE_FLASH_SHA:
        raise AssertionError(
            f"the flash drill ended in {path[0]['param_sha256']}, not in the "
            f"mesh-free trainer's parameters {MESH_FREE_FLASH_SHA}: FSDP2 at "
            "one rank moved bits"
        )
    http_heal = check_heals("path", "http")
    check_perf("path")
    return path, http_heal


def quantized_phase() -> dict:
    """Phase 7: the int8 drill; its parameters must differ from the flash
    drill's."""
    quantized = path_phase(
        "quantized path", [*PATH_ARGS, "--quantize"], FLASH_KERNELS + QUANT_KERNELS
    )
    if quantized[0]["param_sha256"] == MESH_FREE_FLASH_SHA:
        raise AssertionError(
            "the quantized drill ended in the unquantized drill's parameters: "
            "the gradients were not quantized"
        )
    return quantized


def ring_phase() -> dict:
    """Phase 8: the ring drill at sp=1, in the flash drill's parameters."""
    ring = path_phase("ring path", RING_ARGS, BLOCK_KERNELS, absent=FLASH_KERNELS)
    if ring[0]["param_sha256"] != MESH_FREE_FLASH_SHA:
        raise AssertionError(
            "the ring drill (sp=1) ended in other parameters than the flash "
            f"drill ({ring[0]['param_sha256']} vs {MESH_FREE_FLASH_SHA}): "
            "the block and whole-sequence entry points no longer compute "
            "the same bits"
        )
    return ring


def ulysses_phase() -> dict:
    """Phase 12's drill: Ulysses at sp=1, in the flash drill's parameters."""
    ulysses = path_phase(
        "ulysses path", ULYSSES_ARGS, FLASH_KERNELS, absent=BLOCK_KERNELS
    )
    if ulysses[0]["param_sha256"] != MESH_FREE_FLASH_SHA:
        raise AssertionError(
            "the Ulysses drill (sp=1) ended in other parameters than the flash "
            f"drill ({ulysses[0]['param_sha256']} vs {MESH_FREE_FLASH_SHA}): "
            "at sp=1 both run the whole-sequence kernels on the same inputs"
        )
    return ulysses


def moe_phase() -> dict:
    """Phase 13's drill. The small families' drills run the int4 device
    wire and dense attention (S=64): the quantize kernels, no attention
    kernel."""
    moe = path_phase(
        "moe path", MOE_ARGS, QUANT_KERNELS, absent=FLASH_KERNELS + BLOCK_KERNELS
    )
    for g, r in moe.items():
        if not r["router_grad_l1"] > 0:
            raise AssertionError(f"moe path: group {g} router gradient {r['router_grad_l1']}")
    return moe


def pipeline_phase() -> dict:
    """Phase 14's drill, held as phase 13's."""
    return path_phase(
        "pipeline path", PIPELINE_ARGS, QUANT_KERNELS,
        absent=FLASH_KERNELS + BLOCK_KERNELS,
    )


# Phases 6-17 and 20. Each lane runs its phases in turn and the lanes run
# side by side: a drill's wall is mostly its processes' start and the
# survivor's wait for the relaunched group, which leave the card idle.
# Phase 16b's ResNet-50 drills come last in their lane, after the first
# llama_small drills of the other lanes have freed the card.
# The phases that launch kernels in this process or count launches here
# run on the main thread (``IN_PROCESS``), one at a time, after the two
# small drills, when no more than two llama_small drills share the card
# with them. ``drill_phases`` prints the card's peak memory in use.
DRILL_LANES = (
    (("path", flash_path_phase), ("preempt", preempt_phase),
     ("fleet_plane", fleet_plane_phase)),
    (("quantized", quantized_phase), ("ring", ring_phase), ("ulysses", ulysses_phase)),
    (("pg_sharded", pg_sharded_phase), ("diloco", diloco_phase), ("ddp", ddp_phase)),
    (("departures_cnn", departures_cnn_phase),),
    (("departures_device", departures_device_phase),),
)
IN_PROCESS = (
    ("moe", moe_phase), ("pipeline", pipeline_phase),
    ("localsgd", localsgd_phase), ("ulysses_check", ulysses_check),
    ("pipeline_check", pipeline_check), ("train_step", train_step_phase),
    ("baby", baby_phase), ("manager_scenarios", manager_scenarios_phase),
)


def drill_phases() -> dict:
    """Runs ``DRILL_LANES`` in threads and ``IN_PROCESS`` on this thread,
    sampling the card's memory in use (every process's) once a second.
    Returns {phase name: its result}; phase 6's heal record is under
    ``"http_heal"``. Raises the first failure once every lane has ended.
    A ``HostWatch`` runs beside them (it also reads the card's memory) and
    its line prints at the end, failed or not."""
    global HOST_WATCH
    from concurrent.futures import ThreadPoolExecutor

    import torch

    out = {}
    peak = [0]

    def card_memory() -> dict:
        free, total = torch.cuda.mem_get_info()
        peak[0] = max(peak[0], total - free)
        return {"card_used_gib": round((total - free) / 2**30, 2)}

    def run(lane) -> None:
        for name, fn in lane:
            out[name] = walled(name, fn)

    HOST_WATCH = HostWatch(extra=card_memory).start()
    try:
        with ThreadPoolExecutor(len(DRILL_LANES), thread_name_prefix="lane") as pool:
            lanes = [pool.submit(run, lane) for lane in DRILL_LANES]
            run(IN_PROCESS)
            for lane in lanes:
                lane.result()
    finally:
        HOST_WATCH.stop()
        (OUT / "host_watch.json").write_text(json.dumps(
            {"wakes": HOST_WATCH.wakes, "readings": HOST_WATCH.readings}))
        print(HOST_WATCH.summary(), flush=True)
    print(f"drills: {len(DRILL_LANES)} lanes beside the main thread, card memory "
          f"in use at most {peak[0] / 2**30:.1f} GiB of "
          f"{torch.cuda.mem_get_info()[1] / 2**30:.1f}; lane walls (s) "
          + ", ".join(f"{'+'.join(n for n, _ in lane)} "
                      f"{sum(PHASE_WALLS[n] for n, _ in lane):.1f}"
                      for lane in (*DRILL_LANES, IN_PROCESS)), flush=True)
    out["path"], out["http_heal"] = out["path"]
    return out


class Tee:
    """A text stream that writes to every stream it holds."""

    def __init__(self, *streams) -> None:
        self.streams = streams

    def write(self, text: str) -> None:
        for s in self.streams:
            s.write(text)

    def flush(self) -> None:
        for s in self.streams:
            s.flush()


def drills_only(runs: int) -> int:
    """``python3 chip_smoke.py --drills N``: the kernels' build, then
    ``drill_phases`` (phase 16b with the other drills) N times in turn and nothing else (no result line), each
    run with its host watch's line (``host_watch_run<i>.json``); a failed
    run is printed and the next one starts. Everything printed also goes
    to ``drills.log``. Exit 1 if any run failed. It counts how often the
    host stalls past the evidence budget."""
    import contextlib
    import traceback

    build_kernels()
    failed = []
    with open(OUT / "drills.log", "w") as log, contextlib.redirect_stdout(Tee(sys.stdout, log)):
        print(f"card: {card_line()}", flush=True)
        for i in range(runs):
            t0 = time.monotonic()
            PHASE_WALLS.clear()
            try:
                drill_phases()
                verdict = "ok"
            except Exception as e:  # noqa: BLE001 - the next run still starts
                traceback.print_exc(file=sys.stdout)
                failed.append(i)
                verdict = f"FAILED: {type(e).__name__}: {e}"
            print(f"drills run {i + 1} of {runs}: {verdict}; wall "
                  f"{time.monotonic() - t0:.1f} s; phase walls (s) {json.dumps(PHASE_WALLS)}",
                  flush=True)
            watch = OUT / "host_watch.json"
            if watch.exists():
                watch.rename(OUT / f"host_watch_run{i + 1}.json")
        print(f"drills: {runs - len(failed)} of {runs} runs passed", flush=True)
    return 1 if failed else 0


def main() -> int:
    t_main = time.monotonic()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    sys.path.insert(0, str(REPO))
    try:
        import torchft_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"torchft_tpu_torch not importable next to this script: {e}")
    OUT.mkdir(parents=True, exist_ok=True)

    card = card_line()
    print(f"card: {card}", flush=True)
    set_peaks(torch.cuda.get_device_name(0))
    if sys.argv[1:2] == ["--drills"]:
        return drills_only(int(sys.argv[2]))
    from concurrent.futures import ThreadPoolExecutor

    # Phase 1a needs the CPU only: it runs beside the build and the SASS
    # check, before any phase times the card.
    t_build = time.monotonic()
    with ThreadPoolExecutor(1) as pool:
        runtime = pool.submit(engine_runtime_phase)
        build_kernels()
        sass_check()
        runtime.result()
    PHASE_WALLS["1 build, 1a runtime"] = round(time.monotonic() - t_build, 1)

    records = walled("2 flash", kernel_phase)
    records.update(walled("3 block", block_phase))
    records.update(walled("4 quantize", quantize_phase))
    records["reduce"], harness = walled("5 reduce", reduce_phase)
    # The bench times the card: it runs alone, before the drills.
    bench = walled("18 bench", bench_phase)
    walled("18a ledger", ledger_phase, bench)
    drills = walled("6-17, 20, 20a drills", drill_phases)
    path, quantized, ring, ulysses = (
        drills[k] for k in ("path", "quantized", "ring", "ulysses"))
    (pg_sharded, pg_heal), preempt = drills["pg_sharded"], drills["preempt"]
    ddp, moe, pipeline = drills["ddp"], drills["moe"], drills["pipeline"]
    localsgd, train_step, baby = drills["localsgd"], drills["train_step"], drills["baby"]
    print(heal_line("http (phase 6)", drills["http_heal"]), flush=True)
    print(heal_line("pg-sharded (phase 15)", pg_heal), flush=True)
    # Phase 16b's lines again, here where the end of the output keeps them.
    for lane in ("departures_cnn", "departures_device"):
        for name, result in drills[lane].items():
            if name != "launches":
                print(result["line"], flush=True)
    # Phase 19 sets the parent's environment (the runner's journal, phase
    # 19's planted fault's links), which every process started meanwhile
    # would inherit: it runs after the drills, alone.
    orchestration = walled("19 orchestration", orchestration_phase, path)
    walled("19a reports", reports_phase, orchestration, bench)
    # Phase 21 holds its wall to TP_EP_BUDGET_S: it runs alone.
    tp_ep = walled("21 tp/ep/sp/pp", tp_ep_phase)
    for g in (0, 1):
        a, b, c, d, e = path[g], quantized[g], ring[g], ulysses[g], pg_sharded[g]
        print(f"group {g} median step: unquantized {a['median_step_ms']:.1f} ms "
              f"{json.dumps(a['median_phase_ms'])}, int8 {b['median_step_ms']:.1f} ms "
              f"{json.dumps(b['median_phase_ms'])}, ring {c['median_step_ms']:.1f} ms "
              f"{json.dumps(c['median_phase_ms'])}, ulysses "
              f"{d['median_step_ms']:.1f} ms {json.dumps(d['median_phase_ms'])}, "
              f"pg-sharded {e['median_step_ms']:.1f} ms "
              f"{json.dumps(e['median_phase_ms'])}",
              flush=True)

    kernels = []
    for name, rec in records.items():
        if name == "reduce":
            # No training step reduces on the card: the harness's launches.
            launches = harness["launches"][name]
        else:
            drill = (quantized if name in QUANT_KERNELS
                     else ring if name in BLOCK_KERNELS else path)
            launches = sum(r["kernel_launches"][name] for r in drill.values())
        if name in QUANT_KERNELS:
            # The ResNet-50 DDP, MoE and GPipe drills' launches go on the
            # same rows.
            more = {
                f"{drill}_launches": sum(
                    runs[g]["kernel_launches"][name] for g in (0, 1)
                )
                for drill, runs in (("ddp", ddp), ("moe", moe), ("pipeline", pipeline))
            }
            more["bench_launches"] = bench["kernel_launches"][name]
            more["baby_launches"] = baby["launches"][name]
            more["manager_scenarios_launches"] = drills["manager_scenarios"]["launches"][name]
            # Phase 16b: ResNet-50's spare failover and heal storm, and
            # Ulysses' model-heal, on the int4 device wire.
            more["departures_launches"] = drills["departures_device"]["launches"][name]
            launches += sum(more.values())
            rec = {**rec, "localsgd_launches": localsgd["launches"][name], **more}
        if name in FLASH_KERNELS:
            # The Ulysses, pg-sharded and preemption drills and phase 17's
            # train steps run the whole-sequence kernels too.
            more = {
                "ulysses_launches": sum(
                    ulysses[g]["kernel_launches"][name] for g in (0, 1)
                ),
                "pg_sharded_launches": sum(
                    pg_sharded[g]["kernel_launches"][name] for g in (0, 1)
                ),
                "preempt_launches": sum(
                    preempt[phase][g]["kernel_launches"][name]
                    for phase in ("drain", "resume") for g in (0, 1)
                ),
                "train_step_launches": train_step["launches"][name],
                "bench_launches": bench["kernel_launches"][name],
                "orchestration_launches": sum(
                    orchestration["results"][g]["kernel_launches"][name]
                    for g in (0, 1)
                ),
                # Phase 21's steps, both ranks: tp 2 (6 q / 2 kv heads),
                # Ulysses at sp 2 (6 q / 2 kv heads on the whole sequence)
                # and the pipeline's stages at pp 2.
                "tp_sp_pp_launches": tp_ep["launches"][name],
            }
            launches += sum(more.values())
            rec = {**rec, **more}
        if name in BLOCK_KERNELS:
            # Phase 21's default and ring attention at sp 2 (shards of 512).
            more = {"sp_launches": tp_ep["launches"][name]}
            launches += sum(more.values())
            rec = {**rec, **more}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "torchft_tpu_torch/ops/csrc/"
            + ("quantization.cu" if name in QUANT_KERNELS + ("reduce",)
               else "flash_attention.cu"),
            "replaces": {
                "flash_fwd": "torchft_tpu/ops/flash_attention.py:202",
                "flash_bwd_dq": "torchft_tpu/ops/flash_attention.py:245",
                "flash_bwd_dkv": "torchft_tpu/ops/flash_attention.py:284",
                "quantize": "torchft_tpu/ops/quantization.py:70",
                "dequantize": "torchft_tpu/ops/quantization.py:138",
                "flash_block_fwd": "torchft_tpu/ops/flash_attention.py:549",
                "flash_block_bwd_dq": "torchft_tpu/ops/flash_attention.py:587",
                "flash_block_bwd_dkv": "torchft_tpu/ops/flash_attention.py:620",
                "reduce": "torchft_tpu/ops/quantization.py:189",
            }[name],
            "launches": launches,
            **rec,
        })
    (OUT / "kernels.json").write_text(json.dumps(kernels, indent=1))
    print(f"phase walls (s): {json.dumps(PHASE_WALLS)}", flush=True)
    print(f"chip_smoke wall {time.monotonic() - t_main:.1f} s (limit 1200 s)",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException as e:  # noqa: BLE001 - any phase failure fails the run
        import traceback

        traceback.print_exc()
        fail(f"{type(e).__name__}: {e}")
