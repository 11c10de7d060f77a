"""Drive the PyTorch port's serving paths on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --xmesh-ab OTHER [--sf 1.0] [--out FILE]

The second form runs only phase 20 from two checkouts on one card, in
turns (`xmesh_ab`).

Phases, one printed line each; any failure raises and exits non-zero:

  1. device   — needs torch.cuda; prints `nvidia-smi` name and power limit
  2. build    — compiles every CUDA kernel of the path from csrc/ (nvcc,
                all sources at once), then the native host library
                (native/*.cpp, g++)
  3. kernels  — each kernel against its plain PyTorch version on the card,
                bit-exact:
                - random buckets, each one launch of a one-entry launch
                  table: K in 1,3,8,32,1024; W in 1,2,3,8,128,256;
                  frontier row occupancy 1 %, 20 %, 100 %; exact and
                  all-ones row flags; plain and fused (first-visit) mode;
                  out, seen and flags compared, rows outside the bucket's
                  slice untouched; then narrow rows of many slots (K 64 to
                  131,072 at W 1, 2, 3, 4, 8, 32, 1-17 rows, one-bit rows
                  and 20 %-occupied words): the slot-parallel bodies and
                  rows split over blocks;
                - one hop of a has_tag-like 2^20-node graph (hub combines
                  of K2 up to 131,072) at W 1-32, plain and fused, with
                  and without flags, run twice, against the plain table
                  walk: its launches (one per table level) and the parts
                  its split rows take;
                - the four real hops of the phase-5 run, each from the
                  frontier and seen of the run up to the hop before: the
                  fused hop (two grouped launches, asserted) vs the plain
                  table walk and vs the unfused kernel plus the torch
                  update; per hop its CUDA-event time, each level's device
                  time, row occupancy and least-bytes bound; per-bucket
                  device times (one-entry tables) and host µs per hop of
                  hops 1 and 4;
                - the first kernel's yardstick: one unfused, flag-less hop
                  of a random ~0.25-density frontier (every row occupied),
                  beside that kernel's 2.672 ms (PERF.md)
  4. serve    — a 2^20-node / 16.5M-edge store (powerlaw_edges seed 42,
                `follows` uid edges, `name: string @index(exact)` "p<i>");
                a batch of eq(name) @recurse queries through
                engine.batch.query_batch on the card, byte-equal to the same
                batch served with device="cpu"; launch counts are zeroed
                just before this run and read just after
  5. bench    — bench.py stage 2 on the card: 4096 lanes (W = 128 int32
                words), depth 4, seeds make_seeds(2^20, 4096, seed=7);
                make_ell_recurse(count_edges=False) timed with CUDA events
                (median of 5, seed mask re-put outside the timed region),
                then make_ell_count; per-lane counts checked against the
                numpy walk for 64 lanes and the total against its
                978,649,539; the profile must show no torch bitwise
                kernel (the first-visit update runs inside the hop
                launches); bound_ms is the sum of phase 3's per-hop bounds
  6. ldbc     — per-query serving (engine.Engine) over LDBC SNB SF1
                (models/ldbc.generate(sf=1.0, seed=9) + load_into the port's
                StoreBuilder; generation and build seconds printed): the 14
                IC templates and the config-3 query through
                Engine(device="cuda") at device_threshold 512 and at 0
                (every non-empty frontier on the card), each response
                byte-equal to Engine(device="cpu", device_threshold=10**9),
                the pure numpy route (whole-block programs off); the card
                route (programs on) must serve at least one expansion of
                config 3 and of the IC mix at 512. Prints the
                per-route counts, the warm p50 of each template (3 reps) on
                all three routes and the IC mix's p50 over all its
                requests, config 3's p50 and edges/s, and a
                torch.profiler breakdown of one mix pass at 512: device and
                wall time, top kernels, per template its wall and device
                time, and per engine layer (parse, execute, render) and op
                (gather_edges, expand_level, to_device, to_host) its calls,
                device launches, host and device time, with each compute
                op's least-bytes bound; and gather_edges' edge→row map
                timed two ways at real `knows` frontiers (the reference's
                scatter + cummax, the port's search), equal maps asserted
  7. ic batch — lane-kernel serving of the LDBC IC mix on the SF1 store of
                phase 6: 32 instances of each of IC1-IC13 and config 3 and
                4 of IC14 (models/ldbc.ic_batch, a distinct start person
                per instance) in one engine.batch.query_batch call on the
                card. (a) every group formed as planned (IC1-IC12 and
                config 3 level trees, IC13 a shortest group, IC14 left to
                the per-query engine), the bucket_hop launches under the
                call (counts zeroed just before, read just after), each
                response equal (sort_keys JSON) to Engine(device="cuda")
                on the same query, cold and warm batch wall time against
                the per-query engine's over the same queries (the warm
                run is the profiled one: its wall includes the
                profiler's cost), its profile by range (tree / step /
                recurse runs against their host rebuild and render),
                and every tree
                and step program of the batch held against the same
                program on bucket_hop_plain, mask for mask (IC4, IC6 and
                IC12 timed over 5 runs); (b) at 1024 lanes (W = 32): the
                tree programs of IC3, IC4, IC6, IC12 and config 3 and one
                8-hop make_ell_step stage, first-visit and level-DAG, each
                against its plain-hop run, with its launches, CUDA-event
                time (median of 5), plain time and least-bytes bound; IC4,
                IC6 and IC12's kernel-over-plain ratios at W = 1 and 32
  8. dql features — the DQL-feature mix (tools/feature_mix.py) on a second
                store built from phase 6's SF1 graph (phase 7's store freed
                first): models/ldbc.SCHEMA plus first_name with trigram and
                fulltext indexes, one geo point per person and 16 password
                hashes. (a) the 13 templates (aggregates, math, @groupby at
                the root and per parent, @cascade, @normalize, regexp,
                match, anyoftext, near, within, checkpwd) through
                Engine(device="cuda") at device_threshold 512, each
                byte-equal to Engine(device="cpu", device_threshold=10**9);
                per template its cold time, the p50 of 3 warm requests, its
                route counts and its device time from one profiled pass;
                (b) one query_batch of 8 instances of each (104 queries, a
                distinct start person per uid template) on the card: the
                families formed (agg_minmax and math must be tree groups),
                the bucket_hop launches under the call (counts zeroed just
                before, read just after, at least one), cold and warm
                wall, and every response equal (sort_keys JSON) to
                Engine(device="cuda") on the same query; then one profiled
                warm batch: host and device time of the tree groups' run
                and rebuild and of the left-over queries, each beside the
                per-query engine's time for the same queries
  9. fused    — whole-block programs (engine/fused.py) and the native
                emitter on phase 6's SF1 store, run after phase 7 while
                that store lives: the 14 IC templates and config 3
                through Engine(device="cuda") at 512, each byte-equal to
                the numpy route; per template the fused blocks and their
                stage kinds, caps, captures and capture ms, cold ms, p50
                with programs on and off (requests interleaved), the
                render alone with the native emitter and the dict
                renderer, and for every captured program one replay
                bit-equal to an eager run of its plain function, its
                replay ms and the eager run's (CUDA events, median of 5)
                beside its least-bytes bound and its launches per replay
                (the plain function's, profiled), with profiled launches
                per template on and off, and ops/recurse.masked_hop alone
                at config 3's first hop. Fails on any fallback, a fused
                count below the eligible blocks, graphs holding more than
                fused.PROGRAM_BYTES or the phase leaving more than that
                reserved on the card, or an emitter that did not build or
                serve. Then the SF1 store built again with
                the numpy CSR builder (equal CSR, both build times) and
                the CSR builders alone on the store's shuffled pairs
  10. graphrag — GraphRAG retrieval and @msgpass (tools/graphrag_mix.py)
                on ONE SF1 store shared with phase 8 (built after phase 9:
                feature_mix's extension plus a 384-d `emb` per person and
                message, 1,009,892 rows, small integers from a seed).
                (a) segment_combine against segment_combine_plain on the
                card (integer features) and against numpy's host_combine
                (N(0,1) features; the live count as a 0-d device tensor
                and as an int), bit for bit: d in 1, 3, 8, 128, 384, each
                agg, sorted and unsorted seg, duplicates,
                non-participating neighbours, empty segments, a
                sentinel-padded tail, and 120,000-edge hubs of each agg;
                segments of exactly LONG_MIN - 1, LONG_MIN and LONG_MIN +
                1 edges, several hubs in one call, out-of-range slots,
                ragged column tiles (d 100, 1000), the scalar path (d 99,
                and d 384 with vecs misaligned), max over rows of +0, -0,
                NaN and +-inf; and one hub call and one featprop-shaped
                call captured in CUDA graphs, each replay bit-equal to
                the eager call;
                (b) the nine templates through Engine(device="cuda") at
                512, each byte-equal to the numpy route, planned as
                expected (knn → hop, knn → recurse, recurse → featprop,
                knn → recurse → featprop, staged @msgpass), with route
                counts, cold ms and the p50 of 3 warm requests, and every
                captured program held against an eager run of its plain
                function; (c) one query_batch of 32 knn_hop, 32
                knn_recurse and 8 of each featprop template: knn_recurse
                a recurse group, knn_hop a tree group, @msgpass per
                query, every response equal to Engine(device="cuda"); the
                bucket_hop and segment_combine launches of (b) and (c),
                counted from zero; (d) the device top-k and
                segment_combine alone at msgpass_hub's and featprop_mean's
                shapes (CUDA events, median of 5) beside their least-bytes
                bounds and plain versions; for segment_combine the whole
                call and its kernels alone, `index_add_` of the gathered
                rows, the FADD-chain floor of its longest segment at the
                SM's maximum clock, and its device launches per call
  11. alpha  — a single-node Alpha (server/api.py) on phase 6's SF1 graph,
                run after phase 9 in a temporary directory on local disk
                that it removes: (a) the port's checkpoint of phase 6's
                store at base_ts 1 (seconds, bytes), Alpha.open on the
                card, the opened base equal to phase 6's store tablet for
                tablet; (b) 1,000 update transactions of
                tools/write_mix.py (LDBC SNB Interactive IU1-IU8 shapes
                and two delete kinds in the tool's own proportions, a
                synthetic stream) through Alpha.mutate with the WAL's
                fsync on, commit p50/p99 and commits/s, then two
                transactions opened together on one person's first_name:
                the second raises TxnAborted; (c) the 14 IC templates and
                config 3 through query_raw at 512, byte-equal to phase 6
                at the ts before the writes and to the numpy route over
                the same view at the newest ts, three read-your-writes
                checks, ic_batch(copies=4; 8 before PR 11) through
                Alpha.query_batch
                (bucket_hop launches counted from zero, each response
                equal to Alpha.query, a repeated query asked once), the
                fold and first-read times and
                the warm IC-mix p50; (d) a child process (started during
                (c), waiting for its go) commits a second stream of 200
                with a marker each and is SIGKILLed after 100 acks: the
                reopened Alpha holds every acked marker (records
                replayed, replay seconds, tail bytes dropped), and a torn
                half record appended to wal.log is dropped with the state
                unchanged; (e) after a small ELL batch and four `likes`
                commits, Alpha.checkpoint_to truncates the WAL, hands the
                fold the view's ELL blocks and device tensors of every
                predicate the later commits left untouched (no build_ell),
                and rebuilds only `likes`; the reopened checkpoint equals
                the fold tablet for tablet and answers the IC mix in the
                same bytes; (f) Alpha.open out of core under a quarter of
                the tablet bytes: the same bytes, faults, evictions and a
                peak resident below the budget plus the largest tablet.
                Graph memory stays within fused.PROGRAM_BYTES. Its
                directory (the checkpoint of (e)) goes on to phase 12
  12. lifecycle — the request lifecycle and the operator's durability
                paths on phase 11's SF1 checkpoint, reopened on the card,
                in phase 11's directory, which it removes: a full
                backup_alpha first; (a) IC14 through Alpha.query with a
                20 ms budget raises DeadlineExceeded (its stage and
                seconds beside the uncancelled run), ic_batch(copies=8)
                through query_batch(deadline_ms=1) raises at a kernel or
                bfs checkpoint, a batch cancelled from another thread
                raises Cancelled, and after each the IC mix answers in
                phase 11's bytes with no read registered and no context
                left; (b) 40 get-or-create tag upserts (200 before
                phase 13 came, 100 before phase 15: the cuts that pay
                for them; tools/write_mix.tag_upserts, half on existing
                tags),
                each read back, p50/p99; (c) an incremental backup of
                the upserts, verify_chain clean, restore into a new
                directory, Alpha.open on the card: the base equal to the
                source's fold tablet for tablet, the 14 IC templates and
                config 3 in the same bytes, ic_batch(copies=4) equal to
                the source's with bucket_hop launches counted from zero
                and the kernel groups counted in the registry equal to
                the planned ones; a restore in a child process
                SIGKILLed after 6 tablets, resumed, bit-identical to the
                clean restore's files; (d) attach_maintenance (rollup
                after 4 layers, checkpoint every 1 s) while a reader
                thread serves IC2, IC8 and IC11 on the card, each read
                byte-equal to the numpy route at its ts, and a writer
                commits: rollup and checkpoint jobs finish ok, a job
                requested while paused waits, resume runs it, shutdown
                drains; (e) profile_start/profile_stop around the restored
                batch write a Chrome trace holding a bucket_hop kernel,
                the maintenance.job (rollup, checkpoint, restore) and
                maintenance.tablet spans seen, the fused routes of an IC
                pass equal its root blocks, METRICS.render() parses
                strictly, and the IC-mix p50 with tracing and metrics on
                and off (interleaved, printed); (f) at sf 0.1 (the cut):
                RDF and JSON export, run_bulk with worker processes and
                run_live into new Alphas, both answering the IC mix in
                the exported store's bytes (IC14, which reads edge
                facets that the export format omits, equal between the
                two reloads). Its directory goes on to phase 13
  13. memory and cost — the memory governor (utils/memgov.py) and the
                cost model (utils/costprofile.py, costprior.py) on phase
                12's SF1 Alpha, reopened on the card from its directory
                (removed at the end), and on phase 10's GraphRAG store,
                kept alive for it (its placed tablets evicted first).
                (a) the IC mix four times and one batch
                (ic_batch(copies=4) plus 8 `knows` @recurse(depth: 2)
                queries) cold, then eight times more with the priors
                on (each group teaches its launch shape's prior), then
                as two interleaved pairs with priors on and off (walls
                printed), every answer equal to the numpy route;
                the cost profile (merged with the history phases 11-12
                saved) names the recurse, tree and shortest shapes, and
                the bucket_hop launches it credits per family add up to
                the counter's delta (counted from zero); refit,
                checkpoint_to, a reopen with fresh process state: every
                group predicted by its own prior, above 0 µs, the one
                saved, and the launch order (printed with the µs and
                the pack imbalance both ways) not the plan's; (b) a
                device budget of half the warmed caches' bytes: the
                batch and the mix again, equal, resident bytes at or
                below the high watermark and the allocator's allocated
                bytes at or below their warm value after every request,
                evictions per cache and re-placements counted; (c) a
                real torch.cuda.OutOfMemoryError under
                set_per_process_memory_fraction, on an 8-deep `knows`
                recurse group: 1. the cap 1 MiB above the reserved bytes
                while the governed caches hold memory, one failure
                absorbed by the evict-and-retry (no degrade); 2. every
                cache evicted first: the retry fails too, the error
                raises out of query_batch with one warning, and no query
                is served from the host; 3. the cap lifted, the card
                route serves again at once (bucket_hop launches), as
                nothing stays degraded; 4. the one degraded route, a
                fused.program whose attempts both fail (injected): the
                staged torch ops serve it on the card, equal, with one
                warning, the next request goes straight to them, and
                after the governor's reset the program serves again; 5.
                one injected AllocFault at each of the six governed
                sites (bfs.ell_recurse, bfs.ell_step, fused.program,
                hop.gather_edges on the Alpha; vec.topk, feat.agg on the
                GraphRAG store), each one event, no degrade, the same
                answer. Each part's seconds printed
  14. front end — the HTTP front end (server/http.py) over real sockets
                on phase 13's SF1 directory, reopened on the card
                (removed at the end): make_http_server(alpha,
                "127.0.0.1", 0) driven by urllib. (a) 3 passes of the 14
                IC templates and config 3 on POST /query, each body's
                data byte-equal to the in-process query_raw (HTTP and
                in-process p50s from alternating requests), phase 13's
                batch on POST /query/batch equal to Alpha.query_batch,
                its bucket_hop launches counted from zero; (b) 6
                write_mix transactions through /mutate?commitNow=true and
                2 through /mutate then /commit (20 and 5 before phase 15
                came: each read-back folds SF1), one /alter and one
                upsert, each read back over HTTP equal to the in-process
                read; (c) attach_admission(2, 2) and 16 clients at once:
                every 200 equal, the 429s equal to shed_total's and
                /debug/admission's deltas, each Retry-After 1 s or more;
                ?timeout=5ms gives 504 naming its stage; a client that
                hangs up mid-batch is cancelled (request_cancelled_total
                {stage="disconnect"}), its token, read, cost record and
                program locks released within 1 s, the next batch
                answered; (d) the program memo cleared, 8 concurrent
                clients over the IC templates: equal answers, captures
                and no fallback; (e) AclManager.ensure_groot and a
                reader of some predicates: after one request of each
                kind, 20 ACL'd /query and /query/batch requests build no
                ELL, place no CSR, capture nothing, allocate no more
                device memory, equal the in-process acl_user answers and
                hold no hidden predicate; a write it may not make gives
                401; (f) every DEBUG_ENDPOINTS row answers, /debug/memory
                is GOVERNOR.status(), /debug/scheduler holds the batch's
                shapes and the admission lanes, and a /debug/profile
                start, a second start (409) and a stop around the batch
                write a trace holding bucket_hop kernels
  15. cluster — SF1 split by predicate over two groups of three port
                Alphas (start_cluster_alpha(..., device="cuda",
                wal_dir=...)) and one Zero (make_zero_server(ZeroState(
                replicas=3))), in this process over loopback gRPC, in a
                temporary directory it removes: the person side
                (first_name, last_name, city, birthday_year, knows,
                works_at, org_name) and the content side (the rest);
                each group's replicas share one immutable base holding
                its tablets over the whole uid vocabulary, and every
                node heartbeats Zero each second through the CLI's loop
                (cli.run_heartbeat_loop, one thread per node). The
                reference is a single-node Alpha over the whole SF1.
                (a) every node's local tablets are its group's and
                Groups.tablet_owner agrees everywhere (boot seconds,
                each node's placed device bytes); (b) 3 passes of the 14
                IC templates from one coordinator of each group, every
                answer byte-equal to the single node's, both remote
                routes (ServeTask hops, whole-tablet pulls) moving bytes,
                each coordinator's p50 beside the single node's; phase
                13's batch on a content-side coordinator (knows foreign)
                equal to the single node's, its bucket_hop launches
                counted from zero; a second run of it builds no ELL,
                places no CSR or ELL and pulls no tablet; (c) 25
                write_mix transactions (seed 21), 5 of them writing both
                groups at once, alternating coordinators of the two
                groups and mirrored into the single node, each read at
                its commit ts on every replica of each group it wrote,
                equal to the mirror; two coordinators writing one key at
                once: one commits, one raises TxnAborted; commit p50 and
                p99 beside phase 11's; (d) a person-side replica stopped
                during 10 commits (peers serve, commits reach the
                majority), restarted from its WAL, caught up through
                FetchLog and reading as its peers; every breaker to it
                closed again; a replica cut off from both peers
                (FaultyGroups) raises ReadUnavailable and NoQuorum, and
                after the heal reads as the single node; (e)
                move_tablet("likes") to the person side under 4 reader
                threads, every answer the single node's, after which the
                person side reads likes from its own card and fetches
                nothing; (f) make_http_server over a coordinator: /state
                lists both groups of three and the split, /debug/peers
                every breaker, /debug/fleet all six nodes; (g) the flight
                recorder armed on a person-side coordinator: a read of a
                fresh content-side write whose first wire attempt to the
                content side stalls 3 s is convicted (after 1 s at the
                least; a read before folds the new commit ts), the
                bundle names the content-side peer and holds its flight
                pulled over DebugFlight, and /debug/fleet/flight?peer=
                serves it.
                Each part's seconds printed
  16. observability — runs between phases 14 and 15, on phase 14's SF1
                Alpha and HTTP server, then stops that server and
                removes its directory. (a) utils/flightrec armed with
                the Alpha (device capture on), utils/timeseries armed at
                0.25 s with the forecast and an SLO engine (read
                latency, error rate, shed rate), a utils/push pusher to a
                collector in this process: the IC mix over /query in 5
                interleaved disarmed/armed passes (p50 of each, the
                armed/disarmed ratios; reported, not gated) and phase
                13's batch over /query/batch, answers equal to the
                in-process ones, its bucket_hop launches counted from
                zero; spans and cost records reach the collector,
                /debug/timeseries, /debug/slo and /debug/flightrecorder
                armed; (b) stall factor 2: an IC14 instance taught a
                400 µs prior is convicted while 3 clients, staggered by
                0.1 s from 0.05 s before IC14 is sent, loop /query/batch
                and a fourth loops phase 13's recurse group from the
                conviction on, until the bundle is written (the expected
                answers served before the recorder is armed); exactly one
                dump, holding the IC14
                request's query and stack, surfaces.memory with the
                governor's device bytes and timeseries.ring, and a
                device_profile naming bucket_hop (or, if DEVICE_WIDE
                stayed held past 1 s, the busy card), beside the
                batches' bucket_hop launch times against the capture
                window and its longest launch-free stretch
                (`hop_timeline`); (c) (2, 2)
                admission under 16 clients looping the batch for 4 s:
                forecast sheds counted, each an admission.shed event of
                reason forecast in the ring, every 200 answer equal;
                (d) one injected allocation failure at bfs.ell_recurse
                absorbed (memory.oom) and one at fused.program degrading
                (memory.degrade), answers equal, /debug/memory lists
                timeseries.ring, the governor reset after; (e) a child
                process started with DGRAPH_TPU_LOCK_SANITIZER=1 and
                DGRAPH_TPU_RACE_SANITIZER=1 opens a copy of the
                directory on the card and serves 8 concurrent /query
                clients over cold programs plus 4 writes: no lock-order
                cycle, no race, the long holds listed; beside (e)'s, a
                second copy of the directory and a copy of phase 12
                (f)'s sf 0.1 bulk directory go to phase 17
  17. cli      — runs last, `python -m dgraph_tpu_torch` in child
                processes on the card over a copy of phase 14's SF1
                directory that phase 16 hands on with the Alpha's
                in-process answers over it; each child's output is a
                file of the phase's temp dir, which it removes. (a)
                `alpha` (device left at its default) with phase 13's
                device budget, admission (4, 16) and a 0.25 s sampler:
                3 passes of the IC templates and config 3 over /query
                and phase 13's batch over /query/batch, byte-equal to
                the in-process answers, the batch between a
                /debug/profile start and stop whose trace's bucket_hop
                kernels are counted and `kernel_group_launches_total`
                rising; /debug/memory shows the flag's budget; 2
                write_mix transactions through /mutate?commitNow read
                back; (b) SIGUSR2 writes one bundle within 5 s;
                `diagnose` (trigger http) and `fleet` (self "local")
                exit 0; (c) SIGINT 0.2 s into a /query/batch from
                another client: "draining maintenance", exit 0 within
                60 s (the batch's outcome printed); `debug` shows a
                base_ts at or past the last acknowledged commit;
                `backup`, `backup verify` and `restore` of phase 12
                (f)'s sf 0.1 bulk directory, the restored one equal
                under `debug` (nodes, predicates, edges, indexes,
                schema) to the source; (d) `zero
                --liveness 3` and two `alpha --zero --heartbeat 0.5`
                with empty directories: test_cluster.py's two-process
                alter, mutate and cross-node read through the port's
                gRPC client, `fleet` over both nodes; the Zero killed,
                each alpha counts 3 or more liveness failures in
                /debug/prometheus_metrics and logs "zero link is likely
                dead"; both stopped by SIGINT with exit 0. Any other
                exit code, any differing answer or any child still
                running fails the phase. Each part's seconds printed
  18. static analysis against the card's run — (a) `python -m
                dgraph_tpu_torch.analysis --format=json` in a child
                process over the tree as shipped: exit 0, no unwaived
                finding, the waived count of each rule printed; (b) its
                facts hold what this process did in phases 1-17: every
                lock name `utils/locks` made, every metric name in
                METRICS and every span name the tracer recorded has a
                static site, the caches registered with memgov.GOVERNOR
                are the `governed_caches` inventory (both ways), and
                each kernel of KERNEL_SOURCES that launched has a launch
                site and its source; any miss fails the phase
  19. mesh     — mesh serving in one process (parallel/): a mesh of four
                shards of card 0 (`make_mesh(4, devices=[cuda:0] * 4)`),
                its parts run where their stores live, all before phase
                18, each under `reshard_guard` with the mesh programs
                wrapped (CUDA events and least bytes per call; every
                program's largest call replayed on the mesh and in its
                single-device form, ONE shard of the card, or the
                device top-k and segment_combine over the whole stack):
                (c) after phase 5, on the bench graph: 4 var-block
                `@recurse(depth: 4)` queries from 16 roots each through
                `_chain_recurse`, then `_fused_recurse`, each answer
                equal to the single-device engine's and each query's
                edges equal to cpu_recurse; (e) bitmap_recurse_sharded
                at 512 int8 lanes, depth 4, from make_seeds: every
                lane's visited set equal to make_ell_recurse's on the
                same seeds (the bucket_hop kernel), the per-lane edges
                to make_ell_count's; (a) after phase 12, on phase 6's SF1
                store: the IC mix and config 3 through `Engine(mesh=,
                device_threshold=0)`, each byte-equal to the numpy
                route, plus a root `orderasc` + `first:` (mesh_topk) and
                a child `orderdesc` (mesh_row_sort); (b) `has(has_creator)`
                (1M messages, past ring_threshold) expanded through
                ring_matrix_hop, the answer equal to the single-device
                route's and the edge matrix to its gather; (f) an
                `Alpha(mesh=)` over HTTP: 4 IC-mix requests,
                /debug/scheduler's `mesh.shard_cost_us`, the same
                requests under a device budget of half the sharded
                tablets' bytes (a store.sharded eviction and a
                re-placement counted; its CLI child moved to phase 20
                (c)); (d) after phase 10, on its
                GraphRAG store: the nine templates through `knn_mesh`
                and `feat_mesh` (segment_combine per shard): knn answers
                exact, @msgpass max exact, sum and mean to rtol=1e-5,
                atol=1e-6 against the single-device engine. Prints each
                part's seconds, the `mesh_*` counters and gauges, and per
                program its launches, device ms, bound and the
                single-device form's ms
  20. mesh across processes — right after phase 19 (d): two child
                processes, ranks 0 and 1, each with two shards of card
                0, one 4-shard mesh over a gloo process group
                (`mesh.init_distributed`, DGRAPH_TPU_LOCAL_SHARDS=2);
                each builds SF1 with the GraphRAG embeddings (phase 6's
                and 10's seeds) and serves (a) phase 19 (a)'s IC mix and
                orderings, (b)'s ring query and (d)'s nine templates at
                device_threshold 0, every answer byte-equal on both
                ranks to phase 19's on the single-process mesh, with
                segment_combine launched on each rank, no reshard, no
                route off the mesh and no allocation failure; then (b)
                a matrix_hop over has_creator slabs each rank alone
                holds (`assemble_sharded_rel`), its edges equal to the
                CSR walk. Per program each rank's calls and CUDA-event
                ms beside phase 19's. (c) two `alpha --jax-coordinator
                --mesh-devices -1` processes (two shards of card 0 each)
                on empty directories: the same alter and commit, one
                query to both at once, both equal to a plain Alpha's,
                `mesh.shard_cost_us` on each, exit 0 on SIGINT; then
                `alpha --mesh-devices <cards + 1>` exits non-zero,
                naming the device count, before its directory exists.
                (d) with two cards or more, (a)'s IC mix with one rank
                per card over NCCL; else the line says why not
  21. `route counters` (the run's totals and each phase's deltas), the
                `kernels` JSON line, then the device JSON line last

Phases 6 to 12, 14 and 15 fail if any block falls back from its
whole-block program to the staged route, and phases 2 to 12, phase 13
(a) and (b), phase 14, phase 16 beyond its two injected failures and
phases 15 and 19 fail if an allocation failure was counted or a shape
degraded (no degraded route may stand in for a kernel's result). Phases
19 and 20 fail on any answer that differs, any reshard, any expansion
off the mesh (device, whole-block program, host walk; a knn or feat
route other than the mesh's), a mesh route or program never taken.

It imports torch, numpy and dgraph_tpu_torch only.
"""

from __future__ import annotations

import contextlib
import gc
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_NODES = 1 << 20
AVG_DEG = 16.0
GRAPH_SEED = 42
SERVE_QUERIES = 32
SERVE_DEPTH = 3
LANES = 4096
DEPTH = 4
REPS = 5
CHECK_LANES = 64
BENCH_TOTAL_EDGES = 978_649_539    # the numpy walk over all 4096 lanes
# the first CUDA kernel's unfused full hop on this card (PERF.md)
FIRST_KERNEL_HOP_MS = 2.672
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak (NVIDIA data sheet)
# no int32 ALU peak is published; the float32 non-tensor peak (67 T/s,
# same data sheet) stands in for the bitwise-OR rate
ALU_OPS_PER_S = 67e12
LDBC_SF = 1.0
LDBC_SEED = 9
LDBC_REPS = 3
LDBC_THRESHOLD = 512
HOST_ONLY = 10**9                  # device_threshold of the pure numpy route
# the executor's profiler ranges, one per device op of the per-query path
LDBC_OPS = ("hop.gather_edges", "level.expand_level", "engine.to_device",
            "engine.to_host")
# the engine's host layers, one profiler range each
LDBC_LAYERS = ("engine.parse", "engine.query", "engine.render")
# phase 7: the mixed IC batch and the 1024-lane kernel-only programs
IC_BATCH_COPIES = 32
IC14_COPIES = 4
IC_BATCH_SEED = 5
KERNEL_LANES = 1024
KERNEL_TEMPLATES = ("IC3", "IC4", "IC6", "IC12", "config3")
# the tree groups whose heavy narrow rows lost to their plain runs before
# the slot-parallel bodies: timed over REPS at W = 1 and W = 32
HEAVY_TEMPLATES = ("IC4", "IC6", "IC12")
STEP_HOPS = 8
# the lane serving path's profiler ranges (engine/batch.py, treebatch.py)
BATCH_RANGES = ("batch.tree_run", "batch.tree_rebuild", "batch.step_run",
                "batch.shortest_rebuild", "batch.recurse_run",
                "batch.recurse_rebuild", "batch.leftover")
# phase 8: the DQL-feature mix
FEATURE_COPIES = 8
FEATURE_REPS = 3
# phase 9: whole-block programs and the native emitter
FUSED_REPS = 3        # interleaved fused-on / fused-off requests per template
REPLAY_REPS = 5       # CUDA-event replays per captured program
CSR_SEED = 3          # shuffle of the SF1 edge pairs fed to the CSR builders
KERNEL_SOURCES = {"bucket_hop": "dgraph_tpu_torch/csrc/bucket_hop.cu",
                  "segment_combine":
                      "dgraph_tpu_torch/csrc/segment_combine.cu"}
KERNEL_REPLACES = {"bucket_hop": "dgraph_tpu/ops/pallas_hop.py:108",
                   "segment_combine": "dgraph_tpu/ops/feat.py:41"}
GRAPHRAG_REPS = 3       # warm requests per GraphRAG template
GRAPHRAG_KNN_COPIES = 32
GRAPHRAG_FEAT_COPIES = 8
COMBINE_SEED = 13       # the random segment_combine cases
COMBINE_DIMS = (1, 3, 8, 128, 384)
COMBINE_EDGES = 8000
HUB_EDGES = 120_000
# phase 11: the Alpha write path (tools/write_mix.py)
ALPHA_TXNS = 1000          # update transactions of the main stream
ALPHA_CRASH_TXNS = 200     # the killed writer's stream
ALPHA_KILL_AFTER = 100     # acknowledgements before SIGKILL
ALPHA_BATCH_COPIES = 4     # ic_batch copies read after the writes (8 before PR 11)
ALPHA_REPS = 3             # warm IC-mix passes
ALPHA_SUFFIX_TXNS = 4      # likes committed between the ELL view and the fold
ALPHA_ELL_TEMPLATES = ("IC2", "IC7", "config3")   # knows, ~has_creator, ~likes
LIFECYCLE_UPSERTS = 40          # (b) tag upserts; 200 before phase 13, 100
#                                 before phase 15
LIFECYCLE_BATCH_COPIES = 8      # (a) the batch under a 1 ms budget
LIFECYCLE_RESTORED_COPIES = 4   # (c) the restored batch (MIN_BATCH)
LIFECYCLE_DEADLINE_MS = 20      # (a) IC14's budget
LIFECYCLE_CANCEL_AFTER_S = 0.05  # (a) the other thread's cancel
LIFECYCLE_KILL_AFTER = 6        # (c) tablets the killed restore writes
LIFECYCLE_SF = 0.1              # (f) export and loaders: the cut scale
MAINT_ROLLUP_AFTER = 4          # (d) rollup when this many layers pend
MAINT_CHECKPOINT_S = 1.0        # (d) periodic checkpoint
MAINT_WRITES = 80               # (d) the writer's commits at most
MAINT_WRITE_GAP_S = 0.02
MAINT_MAX_S = 60.0
MAINT_READ_TEMPLATES = ("IC2", "IC8", "IC11")
OBS_REPS = 4                    # (e) interleaved on/off IC-mix passes
LIVE_BATCH = 10_000             # (f) N-Quads per live-loader commit
FACET_TEMPLATES = ("IC14",)     # read edge facets, which exports omit
# phase 13: the memory governor and the cost model
MEMCOST_BATCH_COPIES = 4        # ic_batch copies of the phase's batch
MEMCOST_RECURSE = 8             # the `knows` @recurse group's queries
MEMCOST_RECURSE_DEPTH = 2       # (a) its depth
# (c): a depth whose hop masks ([depth, n+1, 1] int32, 33 MB at SF1) no
# cached block of the allocator can hold once it is emptied, so the run
# needs a new segment under the cap
MEMCOST_OOM_DEPTH = 8
MEMCOST_MIX_PASSES = 4          # (a) IC-mix passes: digests with n >= 4
MEMCOST_TEACH_PASSES = 7        # (a) batches after the cold one, priors on:
                                # 8 runs per group, costprior.SAMPLE_FLOOR
MEMCOST_CAP_MARGIN = 1 << 20    # (c) the cap above the reserved bytes


def say(phase: str, **kv) -> None:
    print(f"{phase}: " + json.dumps(kv, default=str), flush=True)


@contextlib.contextmanager
def fusion(on: bool):
    """Whole-block programs (engine/fused.py) on or off inside the block:
    the DGRAPH_TPU_FUSED switch, read per query."""
    was = os.environ.get("DGRAPH_TPU_FUSED")
    os.environ["DGRAPH_TPU_FUSED"] = "1" if on else "0"
    try:
        yield
    finally:
        if was is None:
            del os.environ["DGRAPH_TPU_FUSED"]
        else:
            os.environ["DGRAPH_TPU_FUSED"] = was


@contextlib.contextmanager
def no_fused_fallback(phase: str):
    """Fail `phase` if a block fell back from its whole-block program to
    the staged route inside it (on the card a failing program raises, so
    this holds the route to that)."""
    from dgraph_tpu_torch.engine import fused

    def seen():
        st = fused.status()
        return st["fallbacks"], st["routes"]["fallback"], len(st["disabled"])

    before = seen()
    yield
    if seen() != before:
        raise AssertionError(f"{phase}: whole-block program fallbacks "
                             f"{before} -> {seen()}")


def cpu_recurse(indptr, indices, seeds, depth):
    """bench.py's numpy loop=false walk for ONE query → edges traversed."""
    frontier = np.unique(seeds).astype(np.int64)
    seen_mask = np.zeros(indptr.shape[0] - 1, bool)
    seen_mask[frontier] = True
    edges = 0
    for _ in range(depth):
        if not len(frontier):
            break
        starts = indptr[frontier].astype(np.int64)
        deg = (indptr[frontier + 1] - indptr[frontier]).astype(np.int64)
        total = int(deg.sum())
        base = np.repeat(np.cumsum(deg) - deg, deg)
        pos = np.repeat(starts, deg) + (np.arange(total) - base)
        nbrs = indices[pos]
        edges += total
        nxt = np.unique(nbrs)
        nxt = nxt[~seen_mask[nxt]]
        seen_mask[nxt] = True
        frontier = nxt
    return edges


def cuda_ms(fn, reps: int, setup=None) -> list:
    """Per-rep device milliseconds of fn() by CUDA events; setup() runs
    before each rep outside the timed region."""
    out = []
    for _ in range(reps):
        arg = setup() if setup is not None else None
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn(arg)
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1))
    return out


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def random_frontier(rows: int, W: int, gen, device, density=0.5):
    """[rows + 1, W] int32 lane words with ~density bits set and an
    all-zero sentinel row last."""
    words = torch.randint(-2**31, 2**31, (rows + 1, W), dtype=torch.int64,
                          generator=gen, device=device).to(torch.int32)
    if density < 0.5:
        keep = torch.randint(-2**31, 2**31, (rows + 1, W),
                             dtype=torch.int64, generator=gen,
                             device=device).to(torch.int32)
        words &= keep
    words[rows] = 0
    return words


# -- phases -------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script measures the port on a GPU and has nothing to run",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("phase 1 device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, nvidia_smi=smi)
    return smi


def phase_build() -> dict:
    from dgraph_tpu_torch.utils import kbuild
    t0 = time.perf_counter()
    report = kbuild.build_all()
    cuda_s = time.perf_counter() - t0
    from dgraph_tpu_torch import native
    t0 = time.perf_counter()
    native.load()
    say("phase 2 build", seconds=round(cuda_s, 3),
        built={k: {"seconds": round(v["seconds"], 3), "ptxas": v["ptxas"]}
               for k, v in report.items()},
        native={"library": os.path.relpath(native.lib_path()),
                "seconds": round(time.perf_counter() - t0, 3)})
    return report


RANDOM_WIDTHS = (1, 2, 3, 8, 128, 256)
RANDOM_KS = (1, 3, 8, 32, 1024)
RANDOM_OCCUPANCY = (0.01, 0.2, 1.0)
# narrow rows of many slots: the slot-parallel bodies and rows split over
# blocks (ops/bucket_hop.py choose_body)
NARROW_WIDTHS = (1, 2, 3, 4, 8, 32)
NARROW_KS = (64, 1024, 2048, 4096, 16384, 131072)
NARROW_ROWS = (1, 3, 17)
# the has_tag-like graph of phase 3's grouped narrow check: in-degree of
# its hubs (K2 = 131072, 16384, 4096 x 4 after dedup and tiling)
HEAVY_HUBS = (1_000_000, 120_000, 30_000, 30_000, 30_000, 30_000)
HEAVY_WIDTHS = (1, 2, 3, 4, 8, 32)


def sparse_frontier(rows: int, W: int, occupancy: float, gen, device):
    """[rows + 1, W] int32 words, one bit in each occupied row (~occupancy
    of them) and a zero sentinel row last: an OR over many slots stays
    far from all ones, so a slot lost or read twice shows."""
    fr = torch.zeros((rows + 1, W), dtype=torch.int32, device=device)
    occ = (torch.rand(rows + 1, generator=gen, device=device)
           < occupancy).nonzero().flatten()
    word = torch.randint(0, W, (len(occ),), generator=gen, device=device)
    bit = torch.randint(0, 32, (len(occ),), generator=gen, device=device)
    fr[occ, word] = (1 << bit).to(torch.int32)
    fr[rows] = 0
    return fr


def held_bucket(nbr, fr, flags, seen0, fused: bool) -> bool:
    """bucket_hop against bucket_hop_plain on one bucket written at row 2
    of a larger output: out, seen and both flag arrays compared whole,
    the rows outside the bucket's slice untouched."""
    from dgraph_tpu_torch.ops.bucket_hop import bucket_hop, bucket_hop_plain

    n_b, W = nbr.shape[0], fr.shape[1]
    got, want = [], []
    for hop, res in ((bucket_hop, got), (bucket_hop_plain, want)):
        out = torch.full((n_b + 3, W), -1, dtype=torch.int32,
                         device=fr.device)
        of = torch.full((n_b + 3,), 7, dtype=torch.uint8, device=fr.device)
        seen = seen0.clone()
        hop(nbr, fr, out, 2, flags=flags, out_flags=of,
            seen=seen if fused else None)
        res += [out, of, seen]
    torch.cuda.synchronize()
    out, of, seen = got
    ok = (all(torch.equal(a, b) for a, b in zip(got, want))
          and bool((out[:2] == -1).all())
          and bool((out[2 + n_b:] == -1).all())
          and bool((of[:2] == 7).all())
          and bool((of[2 + n_b:] == 7).all())
          and torch.equal(seen[:2], seen0[:2])
          and torch.equal(seen[2 + n_b:], seen0[2 + n_b:]))
    return ok and (fused or torch.equal(seen, seen0))


def phase_random_buckets(device) -> dict:
    """bucket_hop (a one-entry launch table) vs bucket_hop_plain on
    random buckets, bit-exact: every W x K x row count x frontier row
    occupancy, with exact and all-ones flags, plain and fused mode; then
    narrow rows of 64 to 131,072 slots at W 1-32 over one-bit rows and
    20 %-occupied words. A bucket's two modes share its cached table, so
    the second launch also proves the split rows' tickets came back to
    0."""
    from dgraph_tpu_torch.ops.bfs import row_flags
    from dgraph_tpu_torch.ops.bucket_hop import bucket_hop

    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    cases = narrow_cases = 0
    rows = 100_003

    def seen_for(n_b, W):
        seen0 = random_frontier(n_b + 2, W, gen, device, density=0.25)
        seen0[torch.rand(n_b + 3, generator=gen, device=device) < 0.5] = 0
        return seen0

    def bucket(n_b, K):
        nbr = torch.randint(0, rows + 1, (n_b, K), generator=gen,
                            dtype=torch.int64, device=device).to(torch.int32)
        nbr[:, -1] = rows      # every row touches the sentinel
        return nbr

    for W in RANDOM_WIDTHS:
        for occ in RANDOM_OCCUPANCY:
            fr = random_frontier(rows, W, gen, device)
            fr[torch.rand(rows + 1, generator=gen, device=device) >= occ] = 0
            fr[rows] = 0
            exact = row_flags(fr)
            for flags in (exact, torch.ones_like(exact)):
                for K in RANDOM_KS:
                    for n_b in ((1, 37, 3001) if K < 1024 else (1, 517, 1500)):
                        nbr = bucket(n_b, K)
                        seen0 = seen_for(n_b, W)
                        for fused in (False, True):
                            if not held_bucket(nbr, fr, flags, seen0, fused):
                                raise AssertionError(
                                    f"bucket_hop != plain at W={W} K={K} "
                                    f"n_b={n_b} occupancy={occ} fused={fused} "
                                    f"exact_flags={flags is exact}")
                            cases += 1
    for W in NARROW_WIDTHS:
        for K in NARROW_KS:
            for occ in ("one bit", 0.2):
                if occ == "one bit":
                    fr = sparse_frontier(rows, W, min(1.0, 16 / K), gen,
                                         device)
                else:
                    fr = random_frontier(rows, W, gen, device)
                    fr[torch.rand(rows + 1, generator=gen,
                                  device=device) >= occ] = 0
                    fr[rows] = 0
                exact = row_flags(fr)
                for flags in (exact, torch.ones_like(exact)):
                    for n_b in NARROW_ROWS:
                        nbr = bucket(n_b, K)
                        seen0 = seen_for(n_b, W)
                        for fused in (False, True):
                            if not held_bucket(nbr, fr, flags, seen0, fused):
                                raise AssertionError(
                                    f"narrow bucket_hop != plain at W={W} "
                                    f"K={K} n_b={n_b} occupancy={occ} "
                                    f"fused={fused} exact_flags="
                                    f"{flags is exact}")
                            narrow_cases += 1
    empty = torch.zeros((0, 4), dtype=torch.int32, device=device)
    bucket_hop(empty, random_frontier(10, 4, gen, device))
    return {"cases": cases, "narrow_cases": narrow_cases, "max_abs_err": 0}


def heavy_graph(n: int, seed: int = 5):
    """A has_tag-like relation: a powerlaw graph over n nodes plus hubs
    of HEAVY_HUBS in-degree (drawn with repeats, so fewer after dedup);
    the hubs' combines are the narrow rows of thousands of slots."""
    from dgraph_tpu_torch.models.synthetic import powerlaw_edges
    from dgraph_tpu_torch.store.store import _csr_from_pairs

    src, dst = powerlaw_edges(n, 4.0, seed)
    rng = np.random.default_rng(seed)
    hub_src = [rng.integers(0, n, d) for d in HEAVY_HUBS]
    hub_dst = [np.full(d, n - 1 - i) for i, d in enumerate(HEAVY_HUBS)]
    return _csr_from_pairs(np.concatenate([src, *hub_src]).astype(np.int32),
                           np.concatenate([dst, *hub_dst]).astype(np.int32),
                           n)


def phase_heavy_hops(device) -> dict:
    """The grouped launches on narrow masks: one hop of the has_tag-like
    graph at W in HEAVY_WIDTHS, plain and fused, with exact flags and
    none, each run twice (the split rows' tickets reset between them),
    bit-exact against the plain table walk; its launches counted (one
    per level)."""
    from dgraph_tpu_torch.ops import bfs
    from dgraph_tpu_torch.ops.bucket_hop import (LAUNCHES, BODIES, F,
                                                 bucket_hop_plain)

    rel = heavy_graph(N_NODES)
    g = bfs.build_ell(rel.indptr, rel.indices)
    prep = bfs.prepare_parts(bfs.device_ell(g, device))
    gen = torch.Generator(device=device)
    gen.manual_seed(99)
    cases, launches, split_rows = 0, set(), {}
    for W in HEAVY_WIDTHS:
        fr = sparse_frontier(g.n, W, 0.02, gen, device)
        seen0 = random_frontier(g.n, W, gen, device, density=0.25)
        tab = bfs.hop_table(prep, fr, seen0, seen0)
        split_rows[W] = {BODIES[int(r[F["body"]])]: int(r[F["parts"]])
                         for lv in tab.levels for r in lv.rows
                         if r[F["parts"]] > 1}
        for flags in (bfs.row_flags(fr), None):
            for fused in (False, True):
                want_seen = seen0.clone()
                want_f = torch.empty(g.n + 1, dtype=torch.uint8,
                                     device=device)
                want = bfs._ell_hop(prep, fr, bucket_hop_plain, flags=flags,
                                    seen=want_seen if fused else None,
                                    out_flags=want_f)
                for _ in range(2):
                    s = seen0.clone()
                    of = torch.empty(g.n + 1, dtype=torch.uint8,
                                     device=device)
                    n0 = LAUNCHES["bucket_hop"]
                    got = bfs._ell_hop(prep, fr, flags=flags,
                                       seen=s if fused else None,
                                       out_flags=of)
                    torch.cuda.synchronize()
                    launches.add(LAUNCHES["bucket_hop"] - n0)
                    if not (torch.equal(got, want) and torch.equal(of, want_f)
                            and torch.equal(s, want_seen if fused
                                            else seen0)):
                        raise AssertionError(
                            f"heavy-graph hop != plain table walk at W={W} "
                            f"fused={fused} flags={flags is not None}")
                    cases += 1
    return {"nodes": g.n, "lvl2_k": [int(t.shape[1]) for t in g.lvl2],
            "cases": cases, "launches_per_hop": sorted(launches),
            "split_rows_parts": split_rows, "max_abs_err": 0}


def hop_bound(g, W: int, occupied_rows: int, nxt_rows: int,
              fresh_rows: int, occupied_slots: int) -> dict:
    """The least time one fused hop could take on this run's data: every
    index once (level 1 and 2), each occupied frontier row once, the
    frontier's and the result's flags, seen read where the hop's OR has
    bits, the fresh mask written whole, seen written where fresh has
    bits — over the HBM rate; the ORs (one per occupied slot and lane
    word) over the ALU rate. The larger of the two."""
    row = 4 * W
    idx_bytes = 4 * (g.padded_edges + sum(int(t.size) for t in g.lvl2))
    nbytes = (idx_bytes + occupied_rows * row + 2 * (g.n + 1)
              + nxt_rows * row + (g.n + 1) * row + fresh_rows * row)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = occupied_slots * W / ALU_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes": nbytes,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def per_level(run, levels: int, tries: int = 3):
    """Device µs of each bucket_hop launch of run() (one per launch-table
    level), or None when the profiler's trace misses launches `tries`
    times over (its device events come back asynchronously and can be
    dropped)."""
    from dgraph_tpu_torch.tools.hop_profile import device_events

    for _ in range(tries):
        us = [round(us, 3) for name, us in device_events(run)
              if "bucket_hop" in name]
        if len(us) == levels:
            return us
    return None


def per_bucket(prep, frontier, run, tries: int = 3):
    """[what, K, rows, body, us] per bucket of the launch table, each
    bucket launched alone as a one-entry table by run() (a hop walked
    with hop_profile.one_bucket), or None when the trace misses
    launches `tries` times over."""
    from dgraph_tpu_torch.tools.hop_profile import (bodies, device_events,
                                                    launch_plan)

    plan = launch_plan(prep)
    names = bodies(prep, frontier)
    for _ in range(tries):
        us = [us for name, us in device_events(run) if "bucket_hop" in name]
        if len(us) == len(plan):
            return [[what, K, rows, body, round(u, 3)]
                    for (what, K, rows), body, u in zip(plan, names, us)]
    return None


def host_us_per_hop(prep, frontier, flags, seen, calls: int = 100) -> float:
    """Host microseconds per fused hop: the wrapper's per-hop checks, the
    cached table and the two launches, issued back to back (the card
    runs behind)."""
    from dgraph_tpu_torch.ops import bfs

    n = prep["n"]
    out = torch.empty_like(seen)
    out_flags = torch.empty(n + 1, dtype=torch.uint8, device=seen.device)

    def call():
        bfs._ell_hop(prep, frontier, flags=flags, seen=seen,
                     out_flags=out_flags, out=out)

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def phase_bench_hops(g, device, mask0: np.ndarray) -> dict:
    """The four real hops of the bench run (4096 lanes, depth 4), each
    from the frontier, flags and seen of the run up to the hop before:
    the fused hop (its launch table's two grouped launches) bit-exact
    against the plain fused table walk (fresh, seen, flags) and against
    the unfused kernel hop; each hop's launches (2 asserted), time,
    per-level device time, occupancy and least-bytes bound; per-bucket
    times (one-entry tables) and host µs per hop of hops 1 and 4."""
    from dgraph_tpu_torch.ops import bfs
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES, bucket_hop_plain
    from dgraph_tpu_torch.tools.hop_profile import one_bucket

    prep = bfs.prepare_parts(bfs.device_ell(g, device))
    levels = len(prep["levels"])
    W = mask0.shape[1]
    n = g.n
    seen = bfs.put_mask(mask0, device)
    frontier = seen.clone()
    flags = bfs.row_flags(frontier)
    level1 = [e for kind, e, _rows, _r0 in prep["parts"] if kind == "hop"]
    if prep["tiles"] is not None:
        level1.append(prep["tiles"])
    hops = []
    for h in range(1, DEPTH + 1):
        res = {}
        for name, hop in (("kernel", None), ("plain", bucket_hop_plain)):
            s = seen.clone()
            fl = torch.empty(n + 1, dtype=torch.uint8, device=device)
            kw = {} if hop is None else {"hop": hop}
            n0 = LAUNCHES["bucket_hop"]
            res[name] = (bfs._ell_hop(prep, frontier, flags=flags, seen=s,
                                      out_flags=fl, **kw), s, fl)
            if hop is None:
                launches = LAUNCHES["bucket_hop"] - n0
        if torch.device(device).type == "cuda" and (launches != levels
                                                    or levels != 2):
            raise AssertionError(f"bench hop {h}: {launches} bucket_hop "
                                 f"launches, want 2 (one per level of "
                                 f"{levels})")
        nxt_flags = torch.empty(n + 1, dtype=torch.uint8, device=device)
        nxt = bfs._ell_hop(prep, frontier, flags=flags, out_flags=nxt_flags)
        torch.cuda.synchronize()
        fresh, s_new, fl_new = res["kernel"]
        if not all(torch.equal(a, b) for a, b in zip(res["kernel"],
                                                     res["plain"])):
            raise AssertionError(f"bench hop {h}: fused kernel != plain, "
                                 f"err {max_abs_err(fresh, res['plain'][0])}")
        if (not torch.equal(fresh, nxt & ~seen)
                or not torch.equal(s_new, seen | fresh)
                or not torch.equal(nxt_flags, bfs.row_flags(nxt))):
            raise AssertionError(f"bench hop {h}: fused kernel != unfused "
                                 f"kernel + torch update")
        fl_scratch = torch.empty(n + 1, dtype=torch.uint8, device=device)
        ms = cuda_ms(lambda s: bfs._ell_hop(prep, frontier, flags=flags,
                                            seen=s, out_flags=fl_scratch),
                     REPS, setup=seen.clone)
        plain_ms = cuda_ms(
            lambda s: bfs._ell_hop(prep, frontier, hop=bucket_hop_plain,
                                   flags=flags, seen=s,
                                   out_flags=fl_scratch),
            1, setup=seen.clone)
        occupied_rows = int(flags[:n].sum())
        occupied_slots = sum(int(flags[e.long()].sum()) for e in level1)
        bound = hop_bound(g, W, occupied_rows, int(nxt_flags.sum()),
                          int(fl_new.sum()), occupied_slots)
        s = seen.clone()
        levels_us = per_level(lambda: bfs._ell_hop(
            prep, frontier, flags=flags, seen=s, out_flags=fl_scratch),
            levels)
        rec = {"hop": h, "launches": launches,
               "occupied_rows": occupied_rows,
               "row_occupancy": occupied_rows / n,
               "occupied_level1_slots": occupied_slots,
               "slot_occupancy": occupied_slots / g.padded_edges,
               "ms": ms, "median_ms": float(np.median(ms)),
               "levels_us": levels_us,
               "events_over_device": (float(np.median(ms)) * 1e3
                                      / sum(levels_us) if levels_us
                                      else None),
               "plain_ms": plain_ms[0], **bound}
        if h in (1, DEPTH):
            s = seen.clone()
            rec["buckets_us"] = per_bucket(
                prep, frontier, lambda: bfs._ell_hop(
                    prep, frontier, hop=one_bucket, flags=flags, seen=s,
                    out_flags=fl_scratch))
            rec["host_us_per_hop"] = host_us_per_hop(prep, frontier, flags,
                                                     seen.clone())
        hops.append(rec)
        del res, nxt
        frontier, flags, seen = fresh, fl_new, s_new
    return {"hops": hops, "prep": prep}


def phase_unfused_hop(g, device, prep) -> dict:
    """The first kernel's measurement, for comparison: one full hop
    without the epilogue or flags on a random frontier of ~0.25 bit
    density (every row occupied), kernel vs plain."""
    from dgraph_tpu_torch.ops import bfs
    from dgraph_tpu_torch.ops.bucket_hop import bucket_hop_plain

    gen = torch.Generator(device=device)
    gen.manual_seed(4321)
    W = LANES // 32
    fr = random_frontier(g.n, W, gen, device, density=0.25)
    got = bfs._ell_hop(prep, fr)
    want = bfs._ell_hop(prep, fr, hop=bucket_hop_plain)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"unfused ELL hop: kernel != plain, err {err}")
    ms = cuda_ms(lambda _: bfs._ell_hop(prep, fr), REPS)
    plain_ms = cuda_ms(lambda _: bfs._ell_hop(prep, fr,
                                              hop=bucket_hop_plain), 3)
    return {"ms": ms, "median_ms": float(np.median(ms)),
            "plain_ms": plain_ms, "first_kernel_ms": FIRST_KERNEL_HOP_MS}


def host_us_per_launch(device, calls: int = 2000) -> float:
    """Host microseconds per fused one-bucket bucket_hop call on a
    one-row bucket at W = 128: the wrapper's checks, the cached
    one-entry table, the ctypes call and the launch."""
    from dgraph_tpu_torch.ops.bfs import row_flags
    from dgraph_tpu_torch.ops.bucket_hop import bucket_hop

    fr = torch.zeros((1001, 128), dtype=torch.int32, device=device)
    out, seen = torch.zeros_like(fr), torch.zeros_like(fr)
    nbr = torch.zeros((1, 1), dtype=torch.int32, device=device)
    flags = row_flags(fr)
    out_flags = torch.zeros(1001, dtype=torch.uint8, device=device)

    def call():
        bucket_hop(nbr, fr, out, 0, flags=flags, out_flags=out_flags,
                   seen=seen)

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def device_ratio(a, b):
    """Device time of launch list a over that of b (None: not measured)."""
    if a is None or b is None:
        return None
    return sum(a) / sum(b)


def phase_kernels(g, device, mask0: np.ndarray) -> dict:
    """Every kernel against its plain version on the card: random
    buckets, the grouped launches on a has_tag-like graph, the four bench
    hops, the unfused full hop. Returns the kernel record for the
    `kernels` line."""
    t0 = time.perf_counter()
    rnd = phase_random_buckets(device)
    t_random = time.perf_counter() - t0
    heavy = phase_heavy_hops(device)
    t_heavy = time.perf_counter() - t0 - t_random
    bench = phase_bench_hops(g, device, mask0)
    hops = bench["hops"]
    unfused = phase_unfused_hop(g, device, bench["prep"])
    ms = sum(r["median_ms"] for r in hops)
    bytes_ms = sum(r["bytes_ms"] for r in hops)
    ops_ms = sum(r["ops_ms"] for r in hops)
    say("phase 3 kernels", seconds=time.perf_counter() - t0,
        random_and_narrow_s=t_random, heavy_graph_s=t_heavy,
        random_cases=rnd["cases"],
        narrow_cases=rnd["narrow_cases"], random_max_abs_err=0,
        heavy_graph=heavy,
        bench_hops=[{k: v for k, v in r.items() if k != "buckets_us"}
                    for r in hops],
        four_hops_ms=ms,
        hop1_over_hop4=hops[0]["median_ms"] / hops[-1]["median_ms"],
        hop1_over_hop4_device=device_ratio(hops[0]["levels_us"],
                                           hops[-1]["levels_us"]),
        launches_per_hop=sorted({r["launches"] for r in hops}),
        hop1_buckets_us=hops[0]["buckets_us"],
        hop4_buckets_us=hops[-1]["buckets_us"],
        unfused_random_hop=unfused,
        host_us_per_launch=host_us_per_launch(device))
    return {"ms": ms, "plain_ms": sum(r["plain_ms"] for r in hops),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": 0}


def build_store(n_nodes: int):
    """The serving store: powerlaw `follows` edges (uid = rank + 1) and an
    exact-indexed name "p<rank>" on every node."""
    from dgraph_tpu_torch.models.synthetic import powerlaw_edges
    from dgraph_tpu_torch.store.schema import parse_schema
    from dgraph_tpu_torch.store.store import StoreBuilder

    src, dst = powerlaw_edges(n_nodes, AVG_DEG, seed=GRAPH_SEED)
    b = StoreBuilder(parse_schema(
        "name: string @index(exact) .\nfollows: [uid] ."))
    b.add_edges("follows", src + 1, dst + 1)
    for i in range(n_nodes):
        b.add_value(i + 1, "name", f"p{i}")
    return b.finalize()


def serve_queries(n_nodes: int, nq: int, depth: int) -> list:
    rng = np.random.default_rng(11)
    return ['{ q(func: eq(name, "p%d")) @recurse(depth: %d) '
            '{ name follows } }' % (i, depth)
            for i in rng.integers(0, n_nodes, nq).tolist()]


def phase_serve(store, device, n_nodes: int, nq: int, depth: int) -> dict:
    from dgraph_tpu_torch.engine.batch import query_batch
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES

    qs = serve_queries(n_nodes, nq, depth)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    got = query_batch(store, qs, device=device)
    cold_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    t0 = time.perf_counter()
    again = query_batch(store, qs, device=device)
    warm_s = time.perf_counter() - t0
    prof = kernel_share(lambda: query_batch(store, qs, device=device))
    t0 = time.perf_counter()
    want = query_batch(store, qs, device="cpu")
    cpu_s = time.perf_counter() - t0
    body = json.dumps(got).encode()
    if body != json.dumps(want).encode() or json.dumps(again).encode() != body:
        raise AssertionError("GPU responses differ from the CPU run")
    if len(got) != nq or not all(r["q"] for r in got):
        raise AssertionError("a query returned no root object")
    for k, v in launches.items():
        if v < 1:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 f"serving path")
    say("phase 4 serve", queries=nq, depth=depth,
        cold_latency_s=cold_s, warm_latency_s=warm_s, cpu_latency_s=cpu_s,
        response_bytes=len(body), launches=launches, byte_equal=True,
        warm_profile=prof)
    return launches


def phase_bench(store, device, n_nodes: int, lanes: int, depth: int,
                check_lanes: int, bound_ms: float) -> dict:
    """The bench run; `bound_ms` is the sum of phase 3's per-hop bounds
    of these same four hops."""
    from dgraph_tpu_torch.engine.batch import _dev_for
    from dgraph_tpu_torch.ops import bfs
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES
    from dgraph_tpu_torch.tools.hop_profile import make_seeds

    g, dev = _dev_for(store, "follows", False, device)
    rel = store.rel("follows")
    seeds = make_seeds(n_nodes, lanes)
    mask0 = bfs.pack_seed_masks(g, seeds)
    W = mask0.shape[1]
    fn = bfs.make_ell_recurse(dev, g.outdeg, g.n, W, count_edges=False)
    count = bfs.make_ell_count(g.outdeg, g.n, device)
    out = fn(bfs.put_mask(mask0, device), depth)          # warm-up
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    holder = {}
    ms = cuda_ms(lambda m: holder.__setitem__("out", fn(m, depth)), REPS,
                 setup=lambda: bfs.put_mask(mask0, device))
    launches = {k: v // REPS for k, v in LAUNCHES.items()}
    last, seen, _ = holder["out"]
    edges = count(last, seen).cpu().numpy()
    step = max(1, lanes // check_lanes)
    check = list(range(0, lanes, step))[:check_lanes]
    want = [cpu_recurse(rel.indptr, rel.indices, seeds[q], depth)
            for q in check]
    if edges[check].tolist() != want:
        raise AssertionError("device edge counts differ from the numpy walk")
    m = bfs.put_mask(mask0, device)
    share = kernel_share(lambda: fn(m, depth))
    run_ms = float(np.median(ms))
    if share is not None:
        share["share_of_median_run"] = share["bucket_hop_us"] / 1e3 / run_ms
        if share["mask_update_us"]:
            raise AssertionError("the run launched torch bitwise kernels "
                                 "for the first-visit update")
    total = int(edges.sum())
    if lanes == LANES and depth == DEPTH and total != BENCH_TOTAL_EDGES:
        raise AssertionError(f"{total} edges, the numpy walk counts "
                             f"{BENCH_TOTAL_EDGES}")
    say("phase 5 bench", lanes=lanes, depth=depth, run_ms=ms,
        median_ms=run_ms, total_edges=total,
        edges_per_s=total / (run_ms / 1e3), bound_ms=bound_ms,
        bound_share=bound_ms / run_ms,
        padded_edges=g.padded_edges, launches_per_run=launches,
        kernel_share=share, checked_lanes=len(check))
    del out
    return {"run_ms": run_ms, "launches": launches}


def kernel_share(run):
    """Device time of one run by kernel, from torch.profiler: the
    bucket_hop kernels' microseconds, torch's bitwise kernels'
    microseconds, all kernels' microseconds, and the
    run's wall microseconds under the profiler (device busy share =
    device_us / wall_us). None when the profiler records no device
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
    total = sum(by_name.values())
    if total <= 0:
        return None
    hop = sum(us for name, us in by_name.items() if "bucket_hop" in name)
    # torch's bitwise &, |, ~ kernels: the unfused first-visit update
    update = sum(us for name, us in by_name.items()
                 if "itwise" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"bucket_hop_us": hop, "mask_update_us": update,
            "device_us": total, "wall_us": wall_us,
            "device_busy_share": total / wall_us,
            "share_of_device_time": hop / total,
            "top_kernels_us": {name[:80]: us for name, us in top}}


def config3_edges(body: bytes) -> int:
    """Edges of a config-3 response, counted as bench_baseline.py counts
    them: every `knows` child below every root, recursively."""
    def count(node):
        kids = node.get("knows", [])
        return len(kids) + sum(count(k) for k in kids)
    return sum(count(r) for r in json.loads(body)["q"])


def lat_ms(fn, reps: int) -> list:
    """Host milliseconds of each of reps warm runs of fn() (each ends
    with its response bytes on the host)."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def device_launches(ev) -> int:
    """Device kernels and copies launched under one profiler event."""
    return len(ev.kernels) + sum(device_launches(c) for c in ev.cpu_children)


def ldbc_profile(engine, queries: dict) -> dict | None:
    """One pass of the mix under torch.profiler, each query in a range
    of its own: device and wall time, the top kernels, per template its
    wall and device time, and per template and range (the engine's
    layers, the executor's ops) the calls, device launches, host and
    device microseconds. None when the profiler records no device
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for name, q in queries.items():
            with record_function("ldbc." + name):
                engine.query_bytes(q)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    kernels: dict = {}
    for ev in events:
        if (ev.device_type == DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            kernels[ev.name] = (kernels.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
    device_us = sum(kernels.values())
    if device_us <= 0:
        return None
    per: dict = {}
    for ev in events:
        if ev.device_type != DeviceType.CPU:
            continue
        if ev.name.startswith("ldbc."):
            rec = per.setdefault(ev.name[5:], {})
            rec["wall_us"] = ev.cpu_time_total
            rec["device_us"] = ev.device_time_total
            continue
        if ev.name not in LDBC_OPS + LDBC_LAYERS:
            continue
        parent = ev.cpu_parent
        while parent is not None and not parent.name.startswith("ldbc."):
            parent = parent.cpu_parent
        tmpl = parent.name[5:] if parent is not None else "?"
        rec = per.setdefault(tmpl, {}).setdefault(
            ev.name, {"calls": 0, "launches": 0, "host_us": 0.0,
                      "device_us": 0.0})
        rec["calls"] += 1
        rec["launches"] += device_launches(ev)
        rec["host_us"] += ev.cpu_time_total
        rec["device_us"] += ev.device_time_total
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"device_us": device_us, "wall_us": wall_us,
            "device_busy_share": device_us / wall_us,
            "top_kernels_us": {k[:80]: v for k, v in top},
            "per_template": per}


def seg_map_ab(store, frontiers: dict, device, reps: int = 20) -> dict:
    """The edge→row map of `gather_edges` two ways on the card, at real
    `knows` frontiers: the reference's scatter-max of row starts plus
    `torch.cummax`, and the port's search of the rows' inclusive ends.
    Both must give the same map; the device microseconds of each
    (CUDA events, median of `reps`)."""
    from dgraph_tpu_torch.engine.execute import _bucket
    from dgraph_tpu_torch.ops.hop import frontier_degrees
    from dgraph_tpu_torch.ops.uidalgebra import pad_to

    indptr, _indices = store.device_rel("knows", False, device)
    out = {}
    for name, ranks in frontiers.items():
        fr = pad_to(ranks, _bucket(len(ranks)), device)
        deg = frontier_degrees(indptr, fr)
        ends = torch.cumsum(deg, 0, dtype=torch.int32)
        total = deg.sum(dtype=torch.int32)
        cap = _bucket(max(int(total), 1))
        j = torch.arange(cap, dtype=torch.int32, device=fr.device)
        rows = torch.arange(fr.shape[0], dtype=torch.int32, device=fr.device)

        def by_cummax(_):
            starts = torch.where(deg > 0, ends - deg, cap).long()
            marks = torch.zeros(cap + 1, dtype=torch.int32, device=fr.device)
            marks.scatter_reduce_(0, starts.clamp_(max=cap), rows, "amax")
            return torch.cummax(marks[:cap], 0).values

        def by_search(_):
            seg = torch.searchsorted(ends, j, right=True)
            last = torch.searchsorted(
                ends, (total - 1).clamp(min=0).reshape(1), right=True)
            return torch.minimum(seg, torch.where(total > 0, last, 0))

        if not torch.equal(by_cummax(None), by_search(None).to(torch.int32)):
            raise AssertionError(f"edge→row maps differ at {name}")
        out[name] = {"rows": len(ranks), "edges": int(total), "slots": cap,
                     "cummax_us": 1e3 * float(np.median(cuda_ms(by_cummax,
                                                                reps))),
                     "search_us": 1e3 * float(np.median(cuda_ms(by_search,
                                                                reps)))}
    return out


def build_ldbc(sf: float = LDBC_SF) -> dict:
    """The LDBC SNB store of phases 6 and 7: the generated graph, the
    port's store, and the seconds each took."""
    from dgraph_tpu_torch.models import ldbc
    from dgraph_tpu_torch.store.store import StoreBuilder

    t0 = time.perf_counter()
    g = ldbc.generate(sf=sf, seed=LDBC_SEED)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = StoreBuilder()
    ldbc.load_into(b, g)
    return {"sf": sf, "g": g, "store": b.finalize(), "generate_s": gen_s,
            "build_s": time.perf_counter() - t0}


def phase_ldbc(device, sf: float = LDBC_SF, reps: int = LDBC_REPS,
               built: dict | None = None) -> dict:
    """Per-query serving of the LDBC IC mix and config 3 (phase 6)."""
    from dgraph_tpu_torch.engine import Engine
    from dgraph_tpu_torch.models import ldbc

    built = built or build_ldbc(sf)
    g, store = built["g"], built["store"]
    sf = built["sf"]
    gen_s, build_s = built["generate_s"], built["build_s"]
    queries = dict(ldbc.ic_templates(g))
    queries["config3"] = ldbc.config3_query(g)

    host = Engine(store, device="cpu", device_threshold=HOST_ONLY)
    with fusion(False):     # the pure numpy route
        want = {k: host.query_bytes(q) for k, q in queries.items()}
    built["ldbc_bytes"] = want       # phase 11 reads the store again
    routes, p50 = {}, {}
    engines = {"host": host}
    for thr in (LDBC_THRESHOLD, 0):
        eng = engines[f"card{thr}"] = Engine(store, device=device,
                                             device_threshold=thr)
        per_q = {}
        for k, q in queries.items():
            before = dict(eng.routes.expansions)
            got = eng.query_bytes(q)
            if got != want[k]:
                raise AssertionError(f"{k} at device_threshold {thr}: the "
                                     f"card's response differs from the "
                                     f"numpy route")
            per_q[k] = {r: n - before[r]
                        for r, n in eng.routes.expansions.items()
                        if n - before[r]}
        routes[f"card{thr}"] = {"per_query": per_q,
                                "expansions": dict(eng.routes.expansions),
                                "edges": dict(eng.routes.edges),
                                "least_bytes": dict(eng.routes.least_bytes)}
    on_card = routes[f"card{LDBC_THRESHOLD}"]["per_query"]

    def device_served(q):
        return sum(on_card[q].get(r, 0) for r in ("device", "fused",
                                                  "program"))
    if not device_served("config3"):
        raise AssertionError("config 3 took no device expansion at "
                             f"device_threshold {LDBC_THRESHOLD}")
    if not sum(device_served(k) for k in queries if k != "config3"):
        raise AssertionError("the IC mix took no device expansion at "
                             f"device_threshold {LDBC_THRESHOLD}")
    mix_p50 = {}
    for route, eng in engines.items():
        with fusion(route != "host"):
            lat = {k: lat_ms(lambda q=q: eng.query_bytes(q), reps)
                   for k, q in queries.items()}
        p50[route] = {k: float(np.median(v)) for k, v in lat.items()}
        # the IC mix's p50: the median over every request of the 14
        # templates, each template weighted equally
        mix_p50[route] = float(np.median(
            [x for k, v in lat.items() if k != "config3" for x in v]))
    edges3 = config3_edges(want["config3"])
    seg_ab = None
    if torch.device(device).type == "cuda":
        with fusion(False):
            city = host.query(
                '{ q(func: eq(city, "%s")) { uid } }' % g.city[0])["q"]
        seg_ab = seg_map_ab(store, {
            "config3_hop1": store.rank_of([int(o["uid"], 16) for o in city]),
            "all_persons": store.rank_of(g.person_uids)}, device)
    card = p50[f"card{LDBC_THRESHOLD}"]
    prof = (ldbc_profile(engines[f"card{LDBC_THRESHOLD}"], queries)
            if torch.device(device).type == "cuda" else None)
    ops = None
    if prof is not None:
        ops = {}
        for per in prof["per_template"].values():
            for op, rec in per.items():
                if not isinstance(rec, dict):
                    continue
                o = ops.setdefault(op, {"calls": 0, "launches": 0,
                                        "host_us": 0.0, "device_us": 0.0})
                for k in o:
                    o[k] += rec[k]
        lb = routes[f"card{LDBC_THRESHOLD}"]["least_bytes"]
        # least-bytes bound of the two compute ops over this mix pass
        for op, route in (("hop.gather_edges", "device"),
                          ("level.expand_level", "fused")):
            if op in ops:
                ops[op]["bound_us"] = lb[route] / HBM_BYTES_PER_S * 1e6
    out = {"sf": sf, "seed": LDBC_SEED, "nodes": store.n_nodes,
           "edges": sum(store.rel(p).nnz for p in store.preds),
           "generator_edges": int(g.n_edges),
           "persons": int(g.n_persons), "generate_s": gen_s,
           "build_s": build_s, "byte_equal": True, "routes": routes,
           "p50_ms": p50, "ic_mix_p50_ms": mix_p50,
           "ic_mix_p50_ms_sum": {r: sum(v[k] for k in queries
                                        if k != "config3")
                                 for r, v in p50.items()},
           "config3_p50_ms": card["config3"], "config3_edges": edges3,
           "config3_edges_per_s": edges3 / (card["config3"] / 1e3),
           "profile": prof, "ops": ops, "seg_map_ab": seg_ab}
    return out


def batch_profile(run) -> dict | None:
    """One run under torch.profiler: device and wall time, the top
    kernels, and per lane-serving range (BATCH_RANGES) its calls, device
    launches, host and device microseconds. None when the profiler
    records no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    kernels: dict = {}
    for ev in events:
        if (ev.device_type == DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            kernels[ev.name] = (kernels.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
    device_us = sum(kernels.values())
    if device_us <= 0:
        return None
    ranges: dict = {}
    for ev in events:
        if ev.device_type != DeviceType.CPU or ev.name not in BATCH_RANGES:
            continue
        rec = ranges.setdefault(ev.name, {"calls": 0, "launches": 0,
                                          "host_us": 0.0, "device_us": 0.0})
        rec["calls"] += 1
        rec["launches"] += device_launches(ev)
        rec["host_us"] += ev.cpu_time_total
        rec["device_us"] += ev.device_time_total
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"device_us": device_us, "wall_us": wall_us,
            "device_busy_share": device_us / wall_us,
            "bucket_hop_us": sum(us for k, us in kernels.items()
                                 if "bucket_hop" in k),
            "top_kernels_us": {k[:80]: v for k, v in top},
            "ranges": ranges}


def flat(out) -> list:
    """A program's outputs (tensors, tuples of tensors) as one list."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in flat(o)]


def same_masks(got, want) -> bool:
    a, b = flat(got), flat(want)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def tree_program(store, plan, device) -> dict:
    """One tree group's run on the kernel and on bucket_hop_plain, from
    the inputs serving would give it (engine/treebatch.py)."""
    from dgraph_tpu_torch.engine import treebatch
    from dgraph_tpu_torch.ops.bfs import make_ell_tree
    from dgraph_tpu_torch.ops.bucket_hop import bucket_hop_plain

    inputs = treebatch._tree_inputs(store, plan, device, LDBC_THRESHOLD)
    if inputs is None:
        raise AssertionError("a tree group has no kernel inputs")
    rels, seed_lists, filt_lists, _sidx, _disp = inputs
    n, lanes = store.n_nodes, treebatch._lanes(plan)
    W = lanes // 32
    fn, descs = treebatch._tree_kernel_for(store, plan, rels, n, W, device)
    seeds, filts = treebatch._tree_masks(n, lanes, seed_lists, filt_lists,
                                         device)
    row = 4 * W
    # least bytes: every seed and filter mask and each graph's index
    # blocks and two permutation vectors read once; every stage output
    # (a recurse stage's per-hop masks too) written once
    nbytes = ((len(seeds) + len(filts)) * (n + 1) * row
              + sum(4 * (g.padded_edges + sum(int(t.size) for t in g.lvl2))
                    + 16 * (n + 1) for g in rels.values())
              + sum((n + 1) * row * (1 + (s.depth if s.keep_hops else 0))
                    for s in plan.stages))
    return {"run": lambda: fn(seeds, filts),
            "plain": lambda: make_ell_tree(descs, n, W,
                                           hop=bucket_hop_plain)(seeds,
                                                                 filts),
            "W": W, "stages": [s.kind for s in plan.stages],
            "bytes": nbytes}


def step_program(store, device, seeds_uids, first_visit: bool,
                 hops: int) -> dict:
    """One make_ell_step stage over `knows` from one person per lane, on
    the kernel and on bucket_hop_plain, with fresh carries per call."""
    from dgraph_tpu_torch.engine.batch import _dev_for, _lane_count
    from dgraph_tpu_torch.ops.bfs import (make_ell_step, pack_seed_masks,
                                          put_mask)
    from dgraph_tpu_torch.ops.bucket_hop import bucket_hop_plain

    g, dev = _dev_for(store, "knows", False, device)
    ranks = store.rank_of(np.asarray(seeds_uids, np.int64))
    lanes = _lane_count(len(ranks))
    lists = [[r] for r in ranks] + [[]] * (lanes - len(ranks))
    mask0 = pack_seed_masks(g, lists)
    W = mask0.shape[1]
    step = make_ell_step(dev, g.n, W, first_visit=first_visit)
    plain = make_ell_step(dev, g.n, W, first_visit=first_visit,
                          hop=bucket_hop_plain)

    def carries():
        return put_mask(mask0, device), put_mask(mask0, device)

    row = 4 * W
    # least bytes: frontier and seen read once, the index blocks once,
    # the per-hop masks written once (and seen, when first-visit)
    nbytes = (2 * (g.n + 1) * row
              + 4 * (g.padded_edges + sum(int(t.size) for t in g.lvl2))
              + hops * (g.n + 1) * row
              + ((g.n + 1) * row if first_visit else 0))
    return {"run": lambda fs: step(*fs, hops),
            "plain": lambda fs: plain(*fs, hops), "carries": carries,
            "W": W, "bytes": nbytes}


def held(name: str, prog, reps: int, with_carries: bool = False) -> dict:
    """Run a program once on the kernel (its launches counted) and once
    on the plain hop, equal mask for mask; then its CUDA-event time
    (median of reps), the plain run's time and the least-bytes bound."""
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES

    def arg():
        return prog["carries"]() if with_carries else None

    def call(which, a):
        return prog[which](a) if with_carries else prog[which]()

    setup = arg if with_carries else None
    before = LAUNCHES["bucket_hop"]
    got = call("run", arg())
    torch.cuda.synchronize()
    launches = LAUNCHES["bucket_hop"] - before
    box = {}
    plain_ms = cuda_ms(lambda a: box.__setitem__("out", call("plain", a)),
                       1, setup=setup)
    if not same_masks(got, box.pop("out")):
        raise AssertionError(f"{name}: kernel run != plain-hop run")
    del got
    ms = cuda_ms(lambda a: call("run", a), reps, setup=setup)
    bound_ms = prog["bytes"] / HBM_BYTES_PER_S * 1e3
    return {"W": prog["W"], "launches": launches, "ms": ms,
            "median_ms": float(np.median(ms)), "plain_ms": plain_ms[0],
            "bytes": prog["bytes"], "bound_ms": bound_ms,
            "bound_by": "bytes", "equal_to_plain": True}


def phase_ic_batch(device, built: dict, copies: int = IC_BATCH_COPIES,
                   ic14: int = IC14_COPIES,
                   kernel_lanes: int = KERNEL_LANES,
                   reps: int = REPS) -> dict:
    """Lane-kernel serving of the LDBC IC mix (phase 7)."""
    from dgraph_tpu_torch.engine import Engine, batch
    from dgraph_tpu_torch.models import ldbc
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES

    g, store = built["g"], built["store"]
    pairs = ldbc.ic_batch(g, copies=copies, seed=IC_BATCH_SEED,
                          ic14_copies=ic14)
    names = [nm for nm, _q in pairs]
    qs = [q for _nm, q in pairs]
    plans, leftover = batch.plan_batch_groups_cached(store, qs)
    family = {"TreePlan": "tree", "_ShortestPlan": "shortest",
              "_BatchPlan": "recurse"}
    groups = [{"family": family[type(p).__name__],
               "templates": sorted({names[i] for i in idxs}),
               "queries": len(idxs), "lanes": batch._lane_count(len(idxs))}
              for p, idxs in plans]
    want_family = {**{f"IC{i}": "tree" for i in range(1, 13)},
                   "IC13": "shortest", "config3": "tree"}
    got_family = {gr["templates"][0]: gr["family"] for gr in groups
                  if len(gr["templates"]) == 1 and gr["queries"] == copies}
    if got_family != want_family or len(groups) != len(want_family):
        raise AssertionError(f"IC batch groups {groups} != {want_family}")
    if sorted({names[i] for i in leftover}) != ["IC14"]:
        raise AssertionError(f"left to the per-query engine: {leftover}")

    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    got = batch.query_batch(store, qs, device=device)
    cold_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    # on the card; a CPU rehearsal runs the plain hop, which counts none
    if torch.device(device).type == "cuda" and launches["bucket_hop"] < 1:
        raise AssertionError("the IC batch launched no bucket_hop")
    # one warm run, profiled on the card (one repetition serves both)
    held_out: dict = {}

    def warm():
        held_out["again"] = batch.query_batch(store, qs, device=device)

    t0 = time.perf_counter()
    prof = (batch_profile(warm) if torch.device(device).type == "cuda"
            else warm())
    warm_s = time.perf_counter() - t0
    again = held_out["again"]
    eng = Engine(store, device=device, device_threshold=LDBC_THRESHOLD)
    t0 = time.perf_counter()
    want = [eng.query(q) for q in qs]
    per_query_s = time.perf_counter() - t0
    bad = sorted({names[i] for i in range(len(qs))
                  if json.dumps(got[i], sort_keys=True)
                  != json.dumps(want[i], sort_keys=True)
                  or json.dumps(again[i], sort_keys=True)
                  != json.dumps(want[i], sort_keys=True)})
    if bad:
        raise AssertionError(f"batch responses differ from the per-query "
                             f"engine for {bad}")
    if any("errors" in r for r in got):
        raise AssertionError("a batch response is an error object")

    # every program of the batch against its plain-hop run, mask for mask
    t0 = time.perf_counter()
    serving = {}
    for (plan, idxs), gr in zip(plans, groups):
        tname = gr["templates"][0]
        if gr["family"] == "tree":
            serving[tname] = held(tname, tree_program(store, plan, device),
                                  reps if tname in HEAVY_TEMPLATES else 1)
        elif gr["family"] == "shortest":
            serving[tname] = held(
                tname, step_program(store, device, plan.src_uids,
                                    plan.first_visit, STEP_HOPS), 1, True)

    serving_s = time.perf_counter() - t0

    # kernel-only at kernel_lanes
    t0 = time.perf_counter()
    big = ldbc.ic_batch(g, copies=kernel_lanes, seed=IC_BATCH_SEED + 1,
                        ic14_copies=0)
    kernel_only = {}
    for tname in KERNEL_TEMPLATES:
        tq = [q for nm, q in big if nm == tname]
        (plan, _idxs), = batch.plan_batch_groups_cached(store, tq)[0]
        kernel_only[tname] = held(tname, tree_program(store, plan, device),
                                  reps)
    starts = [int(q.split("from: ")[1].split(",")[0], 16)
              for nm, q in big if nm == "IC13"]
    for fv in (True, False):
        kernel_only[f"step_first_visit_{fv}"] = held(
            f"step first_visit={fv}",
            step_program(store, device, starts, fv, STEP_HOPS), reps, True)

    kernel_only_s = time.perf_counter() - t0
    # kernel against plain in this run: median kernel ms over plain ms
    heavy_vs_plain = {
        t: {f"W{r['W']}": r["median_ms"] / r["plain_ms"]
            for r in (serving[t], kernel_only[t])}
        for t in HEAVY_TEMPLATES}
    ranges = prof["ranges"] if prof else {}
    return {"queries": len(qs), "groups": groups,
            "leftover": len(leftover), "bucket_hop_launches": launches,
            "equal_to_per_query_engine": True, "cold_s": cold_s,
            "warm_s": warm_s, "per_query_engine_s": per_query_s,
            "warm_over_per_query": warm_s / per_query_s,
            "profile": prof,
            "tree_run_device_ms": ranges.get("batch.tree_run", {}).get(
                "device_us", 0.0) / 1e3,
            "step_run_device_ms": ranges.get("batch.step_run", {}).get(
                "device_us", 0.0) / 1e3,
            "serving_programs": serving, "serving_programs_s": serving_s,
            "kernel_only": kernel_only, "kernel_only_s": kernel_only_s,
            "heavy_kernel_over_plain": heavy_vs_plain}


def phase_features(device, g, store) -> dict:
    """Per-query and batched serving of the DQL-feature mix (phase 8) on
    `store`, a store of `g` holding at least feature_mix's schema and
    values (main passes build_graphrag_store's, timed there)."""
    from dgraph_tpu_torch.engine import Engine, batch
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES
    from dgraph_tpu_torch.tools import feature_mix

    queries = feature_mix.templates(g)
    host = Engine(store, device="cpu", device_threshold=HOST_ONLY)
    t0 = time.perf_counter()
    with fusion(False):     # the pure numpy route
        want = {k: host.query_bytes(q) for k, q in queries.items()}
    host_pass_s = time.perf_counter() - t0
    eng = Engine(store, device=device, device_threshold=LDBC_THRESHOLD)
    per = {}
    for k, q in queries.items():
        before = dict(eng.routes.expansions)
        t0 = time.perf_counter()
        got = eng.query_bytes(q)
        cold_ms = (time.perf_counter() - t0) * 1e3
        if got != want[k]:
            raise AssertionError(f"{k}: the card's response differs from "
                                 f"the numpy route")
        warm = lat_ms(lambda q=q: eng.query_bytes(q), FEATURE_REPS)
        per[k] = {"cold_ms": cold_ms, "p50_ms": float(np.median(warm)),
                  "response_bytes": len(got),
                  "expansions": {r: n - before[r]
                                 for r, n in eng.routes.expansions.items()
                                 if n - before[r]}}
    prof = (ldbc_profile(eng, queries)
            if torch.device(device).type == "cuda" else None)
    if prof is not None:
        for k, rec in prof["per_template"].items():
            if k in per:
                per[k]["profiled_wall_us"] = rec.get("wall_us")
                per[k]["device_us"] = rec.get("device_us")
        prof = {k: v for k, v in prof.items() if k != "per_template"}

    pairs = feature_mix.batch(g, copies=FEATURE_COPIES)
    names = [nm for nm, _q in pairs]
    qs = [q for _nm, q in pairs]
    plans, leftover = batch.plan_batch_groups_cached(store, qs)
    family = {"TreePlan": "tree", "_ShortestPlan": "shortest",
              "_BatchPlan": "recurse"}
    families: dict = {"tree": [], "recurse": [], "shortest": [],
                      "left over": sorted({names[i] for i in leftover})}
    for p, idxs in plans:
        families[family[type(p).__name__]].append(
            sorted({names[i] for i in idxs}))
    in_tree = {nm for grp in families["tree"] for nm in grp}
    if not {"agg_minmax", "math"} <= in_tree:
        raise AssertionError(f"agg_minmax and math must run as tree "
                             f"groups: {families}")
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    got = batch.query_batch(store, qs, device=device)
    cold_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    t0 = time.perf_counter()
    again = batch.query_batch(store, qs, device=device)
    warm_s = time.perf_counter() - t0
    if torch.device(device).type == "cuda" and launches["bucket_hop"] < 1:
        raise AssertionError("the feature batch launched no bucket_hop")
    card = Engine(store, device=device, device_threshold=LDBC_THRESHOLD)
    per_query, per_query_ms = [], []
    for q in qs:
        t0 = time.perf_counter()
        per_query.append(card.query(q))
        per_query_ms.append((time.perf_counter() - t0) * 1e3)
    per_query_s = sum(per_query_ms) / 1e3
    bad = sorted({names[i] for i in range(len(qs))
                  if json.dumps(got[i], sort_keys=True)
                  != json.dumps(per_query[i], sort_keys=True)
                  or json.dumps(again[i], sort_keys=True)
                  != json.dumps(per_query[i], sort_keys=True)})
    if bad:
        raise AssertionError(f"feature batch responses differ from the "
                             f"per-query engine for {bad}")
    if any("errors" in r for r in got):
        raise AssertionError("a feature batch response is an error object")
    # a third, profiled warm batch: the tree groups' run and rebuild and
    # the left-over queries, each beside the per-query engine's time for
    # the same queries
    t0 = time.perf_counter()
    batch_prof = (batch_profile(lambda: batch.query_batch(store, qs,
                                                          device=device))
                  if torch.device(device).type == "cuda" else None)
    batch_profile_s = time.perf_counter() - t0
    in_groups = {i for _p, idxs in plans for i in idxs}
    split = {"tree groups": {"per_query_engine_ms": sum(
                 ms for i, ms in enumerate(per_query_ms) if i in in_groups)},
             "left over": {"per_query_engine_ms": sum(
                 ms for i, ms in enumerate(per_query_ms)
                 if i not in in_groups)}}
    if batch_prof is not None:
        rng = batch_prof["ranges"]
        for part, keys in (("tree groups", ("batch.tree_run",
                                            "batch.tree_rebuild")),
                           ("left over", ("batch.leftover",))):
            for key in keys:
                rec = rng.get(key, {})
                split[part][key] = {"host_ms": rec.get("host_us", 0.0) / 1e3,
                                    "device_ms":
                                        rec.get("device_us", 0.0) / 1e3}
    return {"nodes": store.n_nodes,
            "host_pass_s": host_pass_s, "byte_equal": True,
            "templates": per,
            "p50_ms_median": float(np.median([r["p50_ms"]
                                              for r in per.values()])),
            "profile": prof, "batch_queries": len(qs),
            "batch_families": families, "bucket_hop_launches": launches,
            "batch_equal_to_per_query_engine": True,
            "batch_cold_s": cold_s, "batch_warm_s": warm_s,
            "per_query_engine_s": per_query_s,
            "warm_over_per_query": warm_s / per_query_s,
            "batch_profile": batch_prof, "batch_profile_s": batch_profile_s,
            "batch_split": split}


def template_launches(eng, queries: dict, on: bool) -> dict | None:
    """One pass of the templates under torch.profiler with whole-block
    programs on or off: per template the device launches (kernels and
    copies) and device microseconds the profiler attributes to it. The
    profiler sees no kernel inside a graph replay, so with programs on
    these are the launches outside the graphs. None when the profiler
    records no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with fusion(on), profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
        for name, q in queries.items():
            with record_function("ldbc." + name):
                eng.query_bytes(q)
        torch.cuda.synchronize()
    events = prof.events()
    if not any(ev.device_type == DeviceType.CUDA for ev in events):
        return None
    return {ev.name[5:]: {"launches": device_launches(ev),
                          "device_us": ev.device_time_total}
            for ev in events
            if ev.device_type == DeviceType.CPU
            and ev.name.startswith("ldbc.")}


def eager_launches(fn) -> int:
    """Device launches (kernels, copies, fills) of one eager fn() under
    torch.profiler: for a captured program's plain function, the nodes
    its graph replays. One profiled run of config 3's masked hop once
    counted 19 launches against 106-109 in every other run, so it takes
    the larger count of two runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for ev in prof.events()
                          if ev.device_type == DeviceType.CUDA
                          and not getattr(ev, "is_user_annotation", False)))
    return max(counts)


def csr_ab(store, seed: int = CSR_SEED) -> dict:
    """The CSR builder two ways on every uid predicate of the store, both
    directions, from its edge pairs in a seeded shuffled order: the
    native builder (native/csr.cpp) and the numpy one. Equal arrays
    asserted; host seconds of each, summed."""
    from dgraph_tpu_torch.store.store import (_csr_from_pairs,
                                              _csr_from_pairs_np)

    rng = np.random.default_rng(seed)
    n = store.n_nodes
    native_s = numpy_s = 0.0
    pairs = 0
    for pred, pd in store.preds.items():
        if pd.fwd is None:
            continue
        deg = np.diff(pd.fwd.indptr)
        src = np.repeat(np.arange(n, dtype=np.int32), deg)
        dst = pd.fwd.indices
        perm = rng.permutation(len(src))
        for s, o in ((src[perm], dst[perm]), (dst[perm], src[perm])):
            t0 = time.perf_counter()
            a = _csr_from_pairs(s, o, n)
            native_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            b = _csr_from_pairs_np(s, o, n)
            numpy_s += time.perf_counter() - t0
            if not (np.array_equal(a.indptr, b.indptr)
                    and np.array_equal(a.indices, b.indices)):
                raise AssertionError(f"native CSR of {pred} != numpy CSR")
            pairs += len(s)
    return {"pairs": pairs, "native_s": native_s, "numpy_s": numpy_s,
            "equal": True}


def program_least_bytes(p, n_nodes: int) -> int:
    """Least bytes of a whole-block program's last call: each stage's
    input frontier, its rows' indptr pairs, the edges' indices and its
    allowed set read once; every output slot written once (and a recurse
    stage's seen bitmap cleared once)."""
    split, n_roots = p.last
    f_cap, a_caps = p.layout
    total = 4 * (f_cap + sum(a_caps))         # the packed input
    fcap = {-1: f_cap}
    nfront = {-1: n_roots}
    for i, (st, sz) in enumerate(zip(p.stages, split)):
        a = 4 * a_caps[i] if st.has_filter else 0
        if st.kind == "hop":
            ecap = p.caps[i][0]
            _n_kept, n_unique, edges = (int(v) for v in sz)
            total += (4 * fcap[st.parent] + 8 * nfront[st.parent]
                      + 4 * edges + a + 16 * ecap + 12)
            fcap[i], nfront[i] = ecap, n_unique
        elif st.kind == "recurse":
            ecap, ocap = p.caps[i]
            _kept_h, uniq_h, tot_h = sz
            fronts = [nfront[st.parent]] + [int(u) for u in uniq_h[:-1]]
            total += n_nodes + 1
            for h in range(st.depth):
                total += (4 * ocap + 8 * fronts[h] + 4 * int(tot_h[h]) + a
                          + 8 * ecap + 4 * ocap + 12)
        elif st.kind == "knn":
            # the tablet, its ranks and the query read once, the seeds
            # written once
            subj, vecs = p.rels[i]
            k = min(st.k, int(subj.shape[0]))
            total += 4 * vecs.numel() + 4 * subj.numel() + 4 * p.caps[i][0]
            fcap[i], nfront[i] = p.caps[i][0], k
        elif st.kind == "featprop":
            # per hop: its kept edges' (nbr, seg), each fresh node's row
            # (every kept edge ends in the hop's fresh set) and the
            # outputs; a lower bound when a neighbour has no row
            d = int(p.rels[i][1].shape[1])
            kept_h, uniq_h, _tot_h = split[st.parent]
            ocap = p.caps[st.parent][1]
            for h in range(len(kept_h)):
                total += (8 * int(kept_h[h]) + 4 * d * int(uniq_h[h])
                          + (4 * d + 8) * ocap)
        else:
            total += (4 * fcap[st.parent] + 8 * nfront[st.parent]
                      + 4 * fcap[st.parent])
    return total


def masked_hop_row(store, q: str, device) -> dict:
    """ops/recurse.masked_hop alone at config 3's first hop (its roots,
    its filter's allowed set, the caps its program settled on): launches,
    device ms (CUDA events, median of REPLAY_REPS) and the least-bytes
    bound (frontier, the rows' indptr pairs, the edges' indices, the
    allowed set and the seen bitmap read once; kept edges, rows and the
    next frontier written once)."""
    from dgraph_tpu_torch.dql.parser import parse
    from dgraph_tpu_torch.engine import fused
    from dgraph_tpu_torch.engine.execute import Executor, _bucket
    from dgraph_tpu_torch.ops.recurse import masked_hop, seen_bitmap
    from dgraph_tpu_torch.ops.uidalgebra import pad_to

    sg = parse(q)[0]
    plan = fused.plan_block(store, sg)
    st, esg = plan.stages[0], plan.stage_sgs[0]
    ex = Executor(store, device=device)
    roots = np.unique(ex.root_display(sg)).astype(np.int32)
    allowed = ex.filter_set(esg.filters)
    rel = store.rel(st.attr, st.reverse)
    caps = fused._estimate_caps(plan, [rel], roots)[0]
    ecap = max(caps[0], _bucket(int(rel.degree(roots).sum())))
    ocap = caps[1]
    indptr, indices = store.device_rel(st.attr, st.reverse, device)
    fr = pad_to(roots, ocap, device)
    a_d = pad_to(allowed, _bucket(max(len(allowed), 1)), device)
    seen = seen_bitmap(store.n_nodes, fr)

    def run(_a=None):
        # each run marks more of `seen`; every op keeps its fixed shape
        return masked_hop(indptr, indices, fr, a_d, seen, ecap, ocap, True)

    total = int(run()[6])
    ms = cuda_ms(run, REPLAY_REPS)
    nbytes = (4 * ocap + 8 * len(roots) + 4 * total + 4 * a_d.shape[0]
              + (store.n_nodes + 1) + 8 * ecap + 4 * ocap)
    return {"roots": len(roots), "edges": total, "edge_cap": ecap,
            "out_cap": ocap, "launches": eager_launches(run),
            "ms": float(np.median(ms)), "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def replay_rows(programs: dict, per: dict, n_nodes: int) -> int:
    """Each captured program of each template: one replay held bit for
    bit against an eager run of its plain function on the same inputs,
    then replay and eager ms (CUDA events), launches per replay and the
    least-bytes bound, into per[template]["programs"]. Returns the
    number checked."""
    checked = 0
    for k, progs in programs.items():
        rows = []
        for p in progs:
            with p.lock:
                p.graph.replay()
                got = [t.clone() for t in flat(p.static_out)]
                ref = flat(p.fn(p.rels, p.static_in))
                if len(got) != len(ref) or not all(
                        torch.equal(a, b) for a, b in zip(got, ref)):
                    raise AssertionError(f"{k}: a graph replay differs "
                                         f"from its eager run")
                ms = cuda_ms(lambda _a, p=p: p.graph.replay(), REPLAY_REPS)
                eager = cuda_ms(lambda _a, p=p: p.fn(p.rels, p.static_in),
                                REPLAY_REPS)
                launches = eager_launches(
                    lambda p=p: p.fn(p.rels, p.static_in))
            checked += 1
            nbytes = program_least_bytes(p, n_nodes)
            rows.append({"replay_ms": float(np.median(ms)),
                         "eager_ms": float(np.median(eager)),
                         "launches_per_replay": launches,
                         "graph_bytes": p.graph_bytes,
                         "least_bytes": nbytes,
                         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                         "bound_by": "bytes", "equal_to_eager": True})
        per[k]["programs"] = rows
    return checked


def phase_fused(device, built: dict) -> dict:
    """Whole-block programs and the native emitter on the SF1 store of
    phase 6 (phase 9)."""
    from dgraph_tpu_torch import native
    from dgraph_tpu_torch.dql.parser import parse
    from dgraph_tpu_torch.engine import Engine, emit, fused
    from dgraph_tpu_torch.models import ldbc
    from dgraph_tpu_torch.store.store import StoreBuilder

    on_card = torch.device(device).type == "cuda"
    g, store = built["g"], built["store"]
    queries = dict(ldbc.ic_templates(g))
    queries["config3"] = ldbc.config3_query(g)
    host = Engine(store, device="cpu", device_threshold=HOST_ONLY)
    with fusion(False):
        want = {k: host.query_bytes(q) for k, q in queries.items()}

    fused.reset()
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved() if on_card else 0
    emitted = dict(emit.COUNTS)
    eng = Engine(store, device=device, device_threshold=LDBC_THRESHOLD)
    per, programs = {}, {}
    eligible_total = 0
    for k, q in queries.items():
        plans = [fused.plan_block(store, sg) for sg in parse(q)]
        eligible = sum(p is not None for p in plans)
        eligible_total += eligible
        before, had = fused.status(), set(map(id, fused.captured()))
        t0 = time.perf_counter()
        with fusion(True):
            got = eng.query_bytes(q)
        cold_ms = (time.perf_counter() - t0) * 1e3
        after = fused.status()
        if got != want[k]:
            raise AssertionError(f"{k}: fused response differs from the "
                                 f"numpy route")
        served = after["routes"]["fused"] - before["routes"]["fused"]
        if served < eligible:
            raise AssertionError(f"{k}: {served} blocks fused of "
                                 f"{eligible} eligible")
        programs[k] = [p for p in fused.captured() if id(p) not in had]
        per[k] = {"blocks": [[s.kind for s in p.stages] if p else None
                             for p in plans],
                  "fused_blocks": served,
                  "caps": [list(fused._caps_memo.get(p.sig, ()))
                           for p in plans if p is not None],
                  "captures": after["captures"] - before["captures"],
                  "capture_ms": after["capture_ms"] - before["capture_ms"],
                  "cold_ms": cold_ms}
    # p50 with whole-block programs on and off, requests interleaved
    lat = {k: {"on": [], "off": []} for k in queries}
    for _ in range(FUSED_REPS):
        for k, q in queries.items():
            for arm in ("on", "off"):
                with fusion(arm == "on"):
                    t0 = time.perf_counter()
                    got = eng.query_bytes(q)
                    lat[k][arm].append((time.perf_counter() - t0) * 1e3)
                if got != want[k]:
                    raise AssertionError(f"{k}: fused {arm} differs from "
                                         f"the numpy route")
    for k in queries:
        per[k]["p50_ms_on"] = float(np.median(lat[k]["on"]))
        per[k]["p50_ms_off"] = float(np.median(lat[k]["off"]))
    # render alone: the native emitter against the dict renderer on the
    # same executed tree, equal bytes
    for k, q in queries.items():
        roots, ex = eng._run(q)
        for arm in ("native", "dict"):
            native.HAVE_EMIT = arm == "native"
            try:
                ms = []
                for _ in range(FUSED_REPS):
                    t0 = time.perf_counter()
                    got = emit.to_json_bytes(ex, roots)
                    ms.append((time.perf_counter() - t0) * 1e3)
            finally:
                native.HAVE_EMIT = True
            if got != want[k]:
                raise AssertionError(f"{k}: {arm} render differs")
            per[k][f"render_ms_{arm}"] = float(np.median(ms))
    mix = [k for k in queries if k != "config3"]
    status = fused.status()
    if status["fallbacks"] or status["routes"]["fallback"] \
            or status["disabled"]:
        raise AssertionError(f"fused fallbacks: {status}")
    if status["routes"]["fused"] < eligible_total * (1 + FUSED_REPS):
        raise AssertionError(f"fused route served {status['routes']} of "
                             f"{eligible_total} eligible blocks per pass")

    # every captured program: one replay against an eager run of its
    # plain function on the same inputs, bit for bit; its replay time
    checked = 0
    if on_card:
        checked = replay_rows(programs, per, store.n_nodes)
        programs.clear()      # reset() below may then free the graphs
        if checked != status["captures"] or not checked:
            raise AssertionError(f"{checked} captured programs checked of "
                                 f"{status['captures']} captures")
        for arm in ("on", "off"):
            prof = template_launches(eng, queries, arm == "on")
            for k, rec in (prof or {}).items():
                per[k][f"launches_{arm}"] = rec["launches"]
                per[k][f"device_us_{arm}"] = rec["device_us"]
    hop_row = masked_hop_row(store, queries["config3"], device) \
        if on_card else None
    n_native = emit.COUNTS["native"] - emitted["native"]
    if not (native.HAVE_EMIT and native.built()) or n_native < 1:
        raise AssertionError(f"the native emitter served {n_native} blocks "
                             f"(HAVE_EMIT {native.HAVE_EMIT}, built "
                             f"{native.built()})")
    # device memory the phase leaves behind: the graphs' pools (within
    # PROGRAM_BYTES) and nothing else; after reset() the pools go back
    memory = {"reserved_before": reserved0, "limit": fused.PROGRAM_BYTES,
              "program_bytes": status["program_bytes"],
              "programs": status["programs"],
              "evictions": status["evictions"]}
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        memory["reserved_after"] = torch.cuda.memory_reserved()
        grown = memory["reserved_after"] - reserved0
        if grown > fused.PROGRAM_BYTES or \
                status["program_bytes"] > fused.PROGRAM_BYTES:
            raise AssertionError(f"phase 9 left {grown} bytes reserved on "
                                 f"the card: {memory}")
    fused.reset()
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        memory["reserved_after_reset"] = torch.cuda.memory_reserved()
    # the store build: native CSR (phase 6's) against the numpy builder
    t0 = time.perf_counter()
    native.HAVE_NATIVE = False
    try:
        b = StoreBuilder()
        ldbc.load_into(b, g)
        numpy_store = b.finalize()
    finally:
        native.HAVE_NATIVE = True
    numpy_build_s = time.perf_counter() - t0
    for pred, pd in store.preds.items():
        for d in ("fwd", "rev"):
            a, b2 = getattr(pd, d), getattr(numpy_store.preds[pred], d)
            if (a is None) != (b2 is None) or (a is not None and not (
                    np.array_equal(a.indptr, b2.indptr)
                    and np.array_equal(a.indices, b2.indices))):
                raise AssertionError(f"{pred} {d}: native and numpy "
                                     f"builders differ")
    del numpy_store
    return {"byte_equal": True, "eligible_blocks_per_pass": eligible_total,
            "status": status,
            "programs_checked": checked, "templates": per,
            "mix_p50_ms_on": float(np.median(
                [x for k in mix for x in lat[k]["on"]])),
            "mix_p50_ms_off": float(np.median(
                [x for k in mix for x in lat[k]["off"]])),
            "render_ms_sum": {arm: sum(r[f"render_ms_{arm}"]
                                       for r in per.values())
                              for arm in ("native", "dict")},
            "memory": memory,
            "masked_hop_config3_hop1": hop_row,
            "native": {"have_emit": native.HAVE_EMIT,
                       "built": native.built(),
                       "blocks_emitted": n_native,
                       "blocks_dict": emit.COUNTS["dict"] - emitted["dict"],
                       "store_build_s_native": built["build_s"],
                       "store_build_s_numpy": numpy_build_s,
                       "csr": csr_ab(store)}}


# -- phase 11: a single-node Alpha on the card ---------------------------------

ALPHA_CHILD = r"""
import json, sys
from dgraph_tpu_torch.server.api import Alpha
p_dir, stream = sys.argv[1], sys.argv[2]
sys.stdin.readline()        # the parent's go: its writer has closed
with open(stream) as f:
    txns = json.load(f)
a = Alpha.open(p_dir, device="cpu")
print("ready", flush=True)
for i, tx in enumerate(txns):
    r = a.mutate(**tx)
    print("ack", r["txn"]["commit_ts"], i, flush=True)
"""


def same_tablets(got, want, what: str) -> None:
    """Fail unless two stores hold the same uids and, tablet for tablet,
    the same CSR arrays, value columns, facets and token indexes."""
    from dgraph_tpu_torch.store.store import store_diff
    diff = store_diff(got, want)
    if diff is not None:
        raise AssertionError(f"phase 11 {what}: {diff}")


def mount_type(path: str) -> str:
    """The file system type of the mount holding `path` (/proc/mounts)."""
    best, kind = "", "unknown"
    path = os.path.realpath(path)
    with open("/proc/mounts") as f:
        for line in f:
            fields = line.split()
            if len(fields) > 2 and (path == fields[1] or path.startswith(
                    fields[1].rstrip("/") + "/")) and len(fields[1]) > len(best):
                best, kind = fields[1], fields[2]
    return kind


def ic_mix_bytes(alpha, queries: dict, read_ts=None) -> dict:
    return {k: alpha.query_raw(q, read_ts=read_ts)
            for k, q in queries.items()}


def phase_alpha(device, built: dict, txns: int = ALPHA_TXNS,
                crash_txns: int = ALPHA_CRASH_TXNS,
                kill_after: int = ALPHA_KILL_AFTER,
                copies: int = ALPHA_BATCH_COPIES,
                handoff: dict | None = None) -> dict:
    """A single-node Alpha on phase 6's SF1 graph (phase 11): boot from
    a checkpoint, commit an update stream through the WAL, read on the
    card at two timestamps, crash a writer, fold and checkpoint, and
    reopen out of core. Works in a temporary directory, which it removes
    unless `handoff` is given: then it fills `handoff` (the directory,
    the checkpoint's dir and its IC-mix bytes) for phase 12, which
    removes it."""
    import shutil
    import signal
    import subprocess
    import tempfile

    from dgraph_tpu_torch.engine import Engine, fused
    from dgraph_tpu_torch.models import ldbc
    from dgraph_tpu_torch.ops import bfs
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES
    from dgraph_tpu_torch.server.api import Alpha, TxnAborted
    from dgraph_tpu_torch.store import checkpoint
    from dgraph_tpu_torch.store import wal as walmod
    from dgraph_tpu_torch.store.outofcore import _pd_nbytes
    from dgraph_tpu_torch.tools import write_mix

    on_card = torch.device(device).type == "cuda"
    g, store = built["g"], built["store"]
    queries = dict(ldbc.ic_templates(g))
    queries["config3"] = ldbc.config3_query(g)
    out: dict = {}
    prog_bytes = [0]

    def graphs():
        prog_bytes[0] = max(prog_bytes[0], fused.status()["program_bytes"])

    def open_alpha(**kw):
        return Alpha.open(p_dir, device=device,
                          device_threshold=LDBC_THRESHOLD, **kw)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_alpha_")
    out["tmp_fs"] = mount_type(tmp)
    p_dir = os.path.join(tmp, "p")
    wal_path = os.path.join(p_dir, "wal.log")
    alphas = []
    child = None
    parts = out["parts_s"] = {}
    t_part = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    try:
        # (a) boot: the port's checkpoint of phase 6's store, reopened
        t0 = time.perf_counter()
        checkpoint.save_versioned(store, p_dir, base_ts=1)
        out["save_s"] = time.perf_counter() - t0
        out["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(d, f))
            for d, _dirs, files in os.walk(p_dir) for f in files)
        t0 = time.perf_counter()
        a = open_alpha()
        alphas.append(a)
        out["open_s"] = time.perf_counter() - t0
        same_tablets(a.mvcc.base, store, "(a) opened base")
        part("a_boot")

        # (b) the update stream, every commit fsync'd before it returns
        if not a.wal.sync:
            raise AssertionError("phase 11: the WAL does not fsync")
        mix = write_mix.make_mix(g, n=txns)
        ts_before = a.oracle.read_only_ts()
        lat = []
        t0 = time.perf_counter()
        for tx in mix.txns:
            t1 = time.perf_counter()
            a.mutate(**tx.kwargs())
            lat.append(time.perf_counter() - t1)
        wall = time.perf_counter() - t0
        out["commits"] = {"txns": len(lat), "kinds": mix.counts(),
                          "p50_ms": 1e3 * float(np.median(lat)),
                          "p99_ms": 1e3 * float(np.percentile(lat, 99)),
                          "per_s": len(lat) / wall}
        person = int(g.person_uids[1])
        t1, t2 = a.new_txn(), a.new_txn()
        t1.mutate(set_nquads=f'<{person:#x}> <first_name> "Won" .')
        t2.mutate(set_nquads=f'<{person:#x}> <first_name> "Lost" .')
        t1.commit()
        try:
            t2.commit()
            raise AssertionError("phase 11: the second of two conflicting "
                                 "transactions committed")
        except TxnAborted:
            out["conflict_aborted"] = True
        part("b_writes")

        # the second writer of (d) starts now and waits for its go, so
        # its interpreter and imports load while (c) reads
        stream = write_mix.make_mix(g, n=crash_txns,
                                    seed=write_mix.WRITE_SEED + 1, tag="c")
        docs = []
        for i, tx in enumerate(stream.txns):
            kw = tx.kwargs()
            kw["set_nquads"] = (kw.get("set_nquads", "") +
                                f'\n_:mk <forum_title> "marker_{i}" .')
            docs.append(kw)
        stream_path = os.path.join(tmp, "stream.json")
        with open(stream_path, "w") as f:
            json.dump(docs, f)
        child = subprocess.Popen(
            [sys.executable, "-c", ALPHA_CHILD, p_dir, stream_path],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))

        # (c) reads on the card: snapshot isolation below the stream,
        # the fold above it held to the numpy route over the same view
        with fusion(True):
            got = ic_mix_bytes(a, queries, read_ts=ts_before)
        bad = [k for k in queries if got[k] != built["ldbc_bytes"][k]]
        if bad:
            raise AssertionError(f"phase 11 (c): {bad} at the ts before "
                                 f"the writes differ from phase 6")
        graphs()
        part("c_snapshot")
        ts_new = a.oracle.read_only_ts()
        t0 = time.perf_counter()
        view = a.mvcc.read_view(ts_new)
        out["fold_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        first = a.query_raw(queries["IC1"], read_ts=ts_new)
        out["first_read_ms"] = 1e3 * (time.perf_counter() - t0)
        after = ic_mix_bytes(a, queries, read_ts=ts_new)
        host = Engine(view, device="cpu", device_threshold=HOST_ONLY)
        with fusion(False):
            want = {k: host.query_bytes(q) for k, q in queries.items()}
        bad = [k for k in queries if after[k] != want[k]]
        if bad or first != want["IC1"]:
            raise AssertionError(f"phase 11 (c): {bad} at the newest ts "
                                 f"differ from the numpy route")
        graphs()
        part("c_newest")
        p, q = mix.checks["friends"][0]
        got = a.query('{ q(func: uid(%#x)) { knows { uid } } }' % p,
                      read_ts=ts_new)
        if f"{q:#x}" not in json.dumps(got):
            raise AssertionError("phase 11 (c): an IU8 friend is missing")
        p, m = mix.checks["unliked"][0]
        lq = '{ q(func: uid(%#x)) { likes { uid } } }' % p
        if f"{m:#x}" not in json.dumps(a.query(lq, read_ts=ts_before)) or \
                f"{m:#x}" in json.dumps(a.query(lq, read_ts=ts_new)):
            raise AssertionError("phase 11 (c): a deleted like is visible")
        name = mix.checks["names"][0]
        got = a.query('{ q(func: eq(first_name, "%s")) { first_name } }'
                      % name, read_ts=ts_new)
        if got != {"q": [{"first_name": name}]}:
            raise AssertionError(f"phase 11 (c): IU1 person {name} not "
                                 f"found: {got}")
        batch = [qq for _n, qq in ldbc.ic_batch(g, copies=copies)]
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        t0 = time.perf_counter()
        results = a.query_batch(batch, read_ts=ts_new)
        out["batch_s"] = time.perf_counter() - t0
        out["bucket_hop_launches"] = LAUNCHES["bucket_hop"]
        if on_card and out["bucket_hop_launches"] < 1:
            raise AssertionError("phase 11 (c): query_batch launched no "
                                 "bucket_hop")
        part("c_batch")
        per_query: dict = {}          # a repeated query is asked once
        for qq, r in zip(batch, results):
            if qq not in per_query:
                per_query[qq] = a.query(qq, read_ts=ts_new)
            if r != per_query[qq]:
                raise AssertionError(f"phase 11 (c): query_batch differs "
                                     f"from query on {qq}")
        out["batch_queries"] = len(batch)
        out["batch_distinct"] = len(per_query)
        part("c_recheck")
        mix_lat = []
        for _ in range(ALPHA_REPS):
            for k, qq in queries.items():
                if k != "config3":
                    t0 = time.perf_counter()
                    a.query_raw(qq, read_ts=ts_new)
                    mix_lat.append(time.perf_counter() - t0)
        out["ic_mix_p50_ms"] = 1e3 * float(np.median(mix_lat))
        graphs()
        del view, host, per_query
        part("c_warm")

        # (d) a second writer, killed after `kill_after` acknowledgements
        a.wal.close()
        t0 = time.perf_counter()
        child.stdin.write("go\n")
        child.stdin.flush()
        acked = []
        try:
            for line in child.stdout:
                fields = line.split()
                if fields[:1] == ["ack"]:
                    acked.append((int(fields[1]), int(fields[2])))
                    if len(acked) >= kill_after:
                        break
        finally:
            child.send_signal(signal.SIGKILL)
            child.wait()
        out["child_s"] = time.perf_counter() - t0
        if len(acked) < kill_after:
            raise AssertionError(f"phase 11 (d): the child acked "
                                 f"{len(acked)} commits")
        size = os.path.getsize(wal_path)
        records = sum(1 for _ in walmod.replay(wal_path))
        del a
        alphas.clear()
        gc.collect()
        t0 = time.perf_counter()
        a2 = open_alpha()
        alphas.append(a2)
        out["replay"] = {"records": records,
                         "seconds": time.perf_counter() - t0,
                         "tail_bytes_dropped":
                             size - os.path.getsize(wal_path)}
        layers = {l.commit_ts for l in a2.mvcc.layers}
        lost = [ts for ts, _i in acked if ts not in layers]
        blocks = " ".join('m%d(func: eq(forum_title, "marker_%d")) '
                          '{ uid }' % (i, i) for _ts, i in acked)
        seen = a2.query("{ " + blocks + " }")
        lost += [i for _ts, i in acked if not seen.get(f"m{i}")]
        if lost:
            raise AssertionError(f"phase 11 (d): acknowledged commits lost "
                                 f"after SIGKILL: {lost[:10]}")
        out["acked"] = len(acked)
        docs_before = [(l.commit_ts, walmod._mut_doc(l.mut))
                       for l in a2.mvcc.layers]
        a2.wal.close()
        frame = walmod.WAL._frame({"ts": 10**12, "m": {
            "es": [], "ed": [], "vs": [], "vd": []}}, records)
        half = frame[:len(frame) // 2]
        with open(wal_path, "ab") as f:
            f.write(half)
        size = os.path.getsize(wal_path)
        del a2
        alphas.clear()
        gc.collect()
        a3 = open_alpha()
        alphas.append(a3)
        dropped = size - os.path.getsize(wal_path)
        if dropped != len(half) or docs_before != [
                (l.commit_ts, walmod._mut_doc(l.mut))
                for l in a3.mvcc.layers]:
            raise AssertionError(f"phase 11 (d): replay past a torn half "
                                 f"record ({dropped} of {len(half)} bytes "
                                 f"dropped) changed the state")
        out["torn_bytes_dropped"] = dropped
        part("d_crash")

        # (e) fold and checkpoint; untouched predicates keep their ELL
        # a batch whose groups lay out ELL blocks of several predicates
        small = [qq for n_, qq in ldbc.ic_batch(g, copies=4, ic14_copies=0)
                 if n_ in ALPHA_ELL_TEMPLATES]
        ts_e = a3.oracle.read_only_ts()
        a3.query_batch(small, read_ts=ts_e)
        view = a3.mvcc.read_view(ts_e)
        ell = dict(view.__dict__.get("_ell_cache", {}))
        devs = dict(view.__dict__.get("_ell_devs", {}))
        suffix = [tx for tx in write_mix.make_mix(
            g, n=100, seed=write_mix.WRITE_SEED + 2, tag="e").txns
            if tx.kind in ("IU2", "IU3")][:ALPHA_SUFFIX_TXNS]
        for tx in suffix:
            a3.mutate(**tx.kwargs())
        touched = {"likes"}
        built_ell = []
        real_build = bfs.build_ell

        def counted(*args, **kw):
            built_ell.append(1)
            return real_build(*args, **kw)

        bfs.build_ell = counted
        try:
            t0 = time.perf_counter()
            ts_ck = a3.checkpoint_to(p_dir)
            out["checkpoint_s"] = time.perf_counter() - t0
            builds_in_checkpoint = len(built_ell)
            new = a3.mvcc.base
            carried, checked = 0, 0
            for key, gval in ell.items():
                if gval is None:
                    continue
                checked += 1
                got = new.__dict__.get("_ell_cache", {}).get(key)
                if key[0] in touched:
                    if got is gval:
                        raise AssertionError(f"phase 11 (e): {key} was "
                                             f"carried though touched")
                    continue
                if got is not gval:
                    raise AssertionError(f"phase 11 (e): {key} not carried")
                for dkey, dev in devs.items():
                    if dkey[:2] != key:
                        continue
                    ndev = new.__dict__["_ell_devs"].get(dkey)
                    if ndev is not dev:
                        raise AssertionError(f"phase 11 (e): device blocks "
                                             f"of {key} not carried")
                    for ta, tb in zip(tensors_of(ndev), tensors_of(dev)):
                        if ta.data_ptr() != tb.data_ptr():
                            raise AssertionError(
                                f"phase 11 (e): {key} tensors moved")
                carried += 1
            if builds_in_checkpoint or not carried:
                raise AssertionError(f"phase 11 (e): {builds_in_checkpoint} "
                                     f"build_ell calls in the checkpoint, "
                                     f"{carried} entries carried")
            a3.query_batch(small)
            rebuilt = len(built_ell)
        finally:
            bfs.build_ell = real_build
        relaid = sorted(k for k in new.__dict__.get("_ell_cache", {})
                        if k not in ell or k[0] in touched)
        if not rebuilt or any(k[0] not in touched for k in relaid):
            raise AssertionError(f"phase 11 (e): after the checkpoint "
                                 f"{rebuilt} ELL builds, for {relaid}")
        out["ell"] = {"entries": checked, "carried": carried,
                      "rebuilt": rebuilt, "rebuilt_keys": relaid}
        if list(walmod.replay(wal_path)):
            raise AssertionError("phase 11 (e): the WAL was not truncated")
        e_bytes = ic_mix_bytes(a3, queries)
        graphs()
        del view
        fold = a3.mvcc.base
        a3.wal.close()
        t0 = time.perf_counter()
        a4 = open_alpha()
        alphas.append(a4)
        out["reopen_s"] = time.perf_counter() - t0
        same_tablets(a4.mvcc.base, fold, "(e) reopened checkpoint")
        if a4.mvcc.base_ts != ts_ck or ic_mix_bytes(a4, queries) != e_bytes:
            raise AssertionError("phase 11 (e): the reopened checkpoint "
                                 "answers differently")
        largest = max(_pd_nbytes(pd) for pd in fold.preds.values())
        part("e_checkpoint")
        del a3, fold, new, ell, devs
        a4.wal.close()
        alphas.clear()
        del a4
        gc.collect()

        # (f) out of core under a quarter of the tablet bytes
        manifest, _d = checkpoint.read_manifest(p_dir)
        tablet_bytes = sum(m["nbytes"]
                           for m in manifest["predicates"].values())
        budget = tablet_bytes // 4
        a5 = open_alpha(memory_budget=budget)
        alphas.append(a5)
        if ic_mix_bytes(a5, queries) != e_bytes:
            raise AssertionError("phase 11 (f): out-of-core answers differ")
        st = a5.mvcc.base.preds.stats()
        if st["peak_resident_bytes"] > budget + largest:
            raise AssertionError(f"phase 11 (f): peak resident "
                                 f"{st['peak_resident_bytes']} above budget "
                                 f"{budget} + largest tablet {largest}")
        out["out_of_core"] = {"budget_bytes": budget,
                              "tablet_bytes": tablet_bytes,
                              "largest_tablet_bytes": largest, **st}
        graphs()
        a5.wal.close()
        part("f_out_of_core")
        if handoff is not None:
            handoff.update(tmp=tmp, p_dir=p_dir, ic_bytes=e_bytes)
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        for al in alphas:
            if al.wal is not None:
                al.wal.close()
        if handoff is None or "tmp" not in handoff:
            shutil.rmtree(tmp, ignore_errors=True)
    out["program_bytes_peak"] = prog_bytes[0]
    if prog_bytes[0] > fused.PROGRAM_BYTES:
        raise AssertionError(f"phase 11: graphs held {prog_bytes[0]} bytes, "
                             f"above {fused.PROGRAM_BYTES}")
    return out


RESTORE_CHILD = r"""
import sys
from dgraph_tpu_torch.server.backup import restore
dest, p_dir = sys.argv[1], sys.argv[2]


def pace():
    print("tablet", flush=True)


restore(dest, p_dir, pace=pace)
print("done", flush=True)
"""

_PROM_LINE = (r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)(\{(?P<labels>.*)\})? '
              r'(?P<value>[0-9.eE+-]+|\+Inf)$')
_PROM_LABEL = r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:\\.|[^"\\])*)"'


def check_prometheus(text: str) -> dict:
    """Strict parse of the Prometheus text format: every sample line
    well formed, under a TYPE line; every histogram with ascending `le`
    buckets, non-decreasing cumulative counts, +Inf equal to _count, and
    a _sum. Returns {kind: series count}; raises on any fault."""
    import re
    types: dict = {}
    hists: dict = {}
    kinds: dict = {}
    line_re, label_re = re.compile(_PROM_LINE), re.compile(_PROM_LABEL)
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            _h, _t, name, kind = line.split(" ")
            if name in types or kind not in ("counter", "gauge",
                                             "histogram"):
                raise AssertionError(f"bad TYPE line {line!r}")
            types[name] = kind
            continue
        m = line_re.match(line)
        if m is None:
            raise AssertionError(f"malformed sample {line!r}")
        raw = m.group("labels") or ""
        labels = {x.group("k"): x.group("v")
                  for x in label_re.finditer(raw)}
        if raw and ",".join(f'{k}="{v}"' for k, v in labels.items()) != raw:
            raise AssertionError(f"malformed labels {line!r}")
        name = m.group("name")
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        kind = types.get(name) or types.get(base)
        if kind is None:
            raise AssertionError(f"no TYPE for {name}")
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind == "histogram" and base in types:
            key = (base, tuple(sorted((k, v) for k, v in labels.items()
                                      if k != "le")))
            h = hists.setdefault(key, {"b": [], "sum": None, "n": None})
            value = float(m.group("value"))
            if name.endswith("_bucket"):
                le = labels["le"]
                h["b"].append((float("inf") if le == "+Inf" else float(le),
                               value))
            elif name.endswith("_sum"):
                h["sum"] = value
            else:
                h["n"] = value
    for key, h in hists.items():
        les = [le for le, _c in h["b"]]
        counts = [c for _le, c in h["b"]]
        if (h["sum"] is None or h["n"] is None or les != sorted(les)
                or not les or les[-1] != float("inf")
                or counts != sorted(counts) or counts[-1] != h["n"]):
            raise AssertionError(f"inconsistent histogram {key}")
    return kinds


def counter_totals(prefixes) -> dict:
    """The registry's counters whose names start with `prefixes`."""
    from dgraph_tpu_torch.utils.metrics import METRICS
    return {k: v for k, v in METRICS.snapshot()["counters"].items()
            if k.startswith(prefixes)}


ROUTE_COUNTERS = ("fused_route_total", "knn_route_total", "feat_route_total",
                  "edges_traversed_total", "kernel_group_launches_total")


def counter_delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _dirs, files in os.walk(path) for f in files)


def dir_files(path: str) -> dict:
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


def phase_lifecycle(device, built: dict, handoff: dict,
                    upserts: int = LIFECYCLE_UPSERTS,
                    copies: int = LIFECYCLE_BATCH_COPIES,
                    restored_copies: int = LIFECYCLE_RESTORED_COPIES,
                    kill_after: int = LIFECYCLE_KILL_AFTER,
                    sf: float = LIFECYCLE_SF,
                    deadline_ms: float = LIFECYCLE_DEADLINE_MS,
                    keep: dict | None = None) -> dict:
    """Phase 12: the request lifecycle and the operator's durability
    paths on phase 11's SF1 Alpha and directory, which it removes unless
    `keep` is given: then it fills `keep` (the directory and the Alpha's
    p_dir) for phase 13, which removes it."""
    import glob
    import shutil
    import signal
    import tempfile
    import threading

    from dgraph_tpu_torch.dql.parser import parse
    from dgraph_tpu_torch.engine import Engine
    from dgraph_tpu_torch.engine.batch import plan_batch_groups_cached
    from dgraph_tpu_torch.loader.bulk import run_bulk
    from dgraph_tpu_torch.loader.live import run_live
    from dgraph_tpu_torch.models import ldbc
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES
    from dgraph_tpu_torch.server.api import Alpha
    from dgraph_tpu_torch.server.backup import (backup_alpha, restore,
                                                verify_chain)
    from dgraph_tpu_torch.store import checkpoint
    from dgraph_tpu_torch.store.store import StoreBuilder
    from dgraph_tpu_torch.store.schema import parse_schema
    from dgraph_tpu_torch.tools import write_mix
    from dgraph_tpu_torch.utils import deadline as dl
    from dgraph_tpu_torch.utils import tracing
    from dgraph_tpu_torch.utils.metrics import METRICS

    on_card = torch.device(device).type == "cuda"
    g = built["g"]
    queries = dict(ldbc.ic_templates(g))
    queries["config3"] = ldbc.config3_query(g)
    tmp, p_dir = handoff["tmp"], handoff["p_dir"]
    want_mix = handoff["ic_bytes"]
    out: dict = {}
    alphas: list = []
    parts = out["parts_s"] = {}
    t_part = [time.perf_counter()]
    spans: dict = {}

    def part(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    def sink(s):
        if s.name.startswith("maintenance."):
            key = f"{s.name}:{s.attrs.get('job', '')}"
            spans[key] = spans.get(key, 0) + 1

    def open_alpha(path, **kw):
        a = Alpha.open(path, device=device,
                       device_threshold=LDBC_THRESHOLD, **kw)
        alphas.append(a)
        return a

    def settled(a, what):
        if a._active_reads or dl.current() is not None:
            raise AssertionError(f"phase 12 {what}: reads "
                                 f"{a._active_reads} or a request context "
                                 f"left registered")
        if ic_mix_bytes(a, queries) != want_mix:
            raise AssertionError(f"phase 12 {what}: the next IC-mix pass "
                                 f"differs from phase 11's checkpoint")

    tracing.add_sink(sink)
    child = None
    try:
        t0 = time.perf_counter()
        src = open_alpha(p_dir)
        out["open_s"] = time.perf_counter() - t0
        if ic_mix_bytes(src, queries) != want_mix:
            raise AssertionError("phase 12: the reopened Alpha answers the "
                                 "IC mix differently from phase 11")
        dest = os.path.join(tmp, "backups")
        t0 = time.perf_counter()
        m_full = backup_alpha(src, p_dir, dest)
        out["backup_full"] = {"seconds": time.perf_counter() - t0,
                              "bytes": dir_bytes(dest), **m_full}
        part("c_full_backup")

        # (a) deadlines: a pathological query, a batch, a cancel
        ic14 = queries["IC14"]
        t0 = time.perf_counter()
        full = src.query(ic14)
        uncancelled_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            src.query(ic14, deadline_ms=deadline_ms)
            raise AssertionError("phase 12 (a): IC14 beat its budget")
        except dl.DeadlineExceeded as e:
            out["ic14_deadline"] = {
                "stage": e.stage, "budget_ms": deadline_ms,
                "seconds": time.perf_counter() - t0,
                "uncancelled_s": uncancelled_s,
                "paths": len(full.get("_path_", []))}
        settled(src, "(a) IC14")
        batch = [qq for _n, qq in ldbc.ic_batch(g, copies=copies)]
        t0 = time.perf_counter()
        try:
            src.query_batch(batch, deadline_ms=1)
            raise AssertionError("phase 12 (a): the batch beat 1 ms")
        except dl.DeadlineExceeded as e:
            if e.stage not in ("kernel", "bfs"):
                raise AssertionError(f"phase 12 (a): the batch stopped at "
                                     f"{e.stage!r}, not a kernel or bfs "
                                     f"checkpoint") from e
            out["batch_deadline"] = {"stage": e.stage, "budget_ms": 1,
                                     "queries": len(batch),
                                     "seconds": time.perf_counter() - t0}
        settled(src, "(a) batch")
        ctx = dl.RequestContext()
        caught: list = []

        def cancelled_batch():
            try:
                with dl.activate(ctx):
                    src.query_batch(batch)
                caught.append(None)
            except dl.Cancelled as e:
                caught.append(e)

        t0 = time.perf_counter()
        th = threading.Thread(target=cancelled_batch)
        th.start()
        time.sleep(LIFECYCLE_CANCEL_AFTER_S)
        ctx.cancel()
        th.join(120)
        if th.is_alive() or not caught or caught[0] is None:
            raise AssertionError("phase 12 (a): the cancelled batch ran "
                                 "to its end")
        out["cancel"] = {"stage": caught[0].stage,
                         "after_s": LIFECYCLE_CANCEL_AFTER_S,
                         "seconds": time.perf_counter() - t0}
        settled(src, "(a) cancel")
        part("a_deadlines")

        # (b) get-or-create tag upserts, each read back
        ops = write_mix.tag_upserts(g, upserts)
        lat = []
        for op in ops:
            t0 = time.perf_counter()
            r = src.upsert(op.src)
            lat.append(time.perf_counter() - t0)
            if r["applied"] != 1 or bool(r["uids"]) != op.creates:
                raise AssertionError(f"phase 12 (b): upsert of {op.tag} "
                                     f"gave {r}")
        lost = [op.tag for op in ops
                if not write_mix.upsert_took(src.query(op.check), op)]
        if lost:
            raise AssertionError(f"phase 12 (b): upserts not read back: "
                                 f"{lost[:5]}")
        out["upserts"] = {"n": len(ops),
                          "creates": sum(op.creates for op in ops),
                          "p50_ms": 1e3 * float(np.median(lat)),
                          "p99_ms": 1e3 * float(np.percentile(lat, 99))}
        part("b_upserts")

        # (c) incremental backup, verify, restore, reopen on the card
        t0 = time.perf_counter()
        m_incr = backup_alpha(src, p_dir, dest)
        out["backup_incr"] = {"seconds": time.perf_counter() - t0,
                              **m_incr}
        if m_incr["type"] != "incr" or m_incr["records"] < len(ops):
            raise AssertionError(f"phase 12 (c): not an incremental of "
                                 f"the upserts: {m_incr}")
        t0 = time.perf_counter()
        report = verify_chain(dest)
        out["verify_s"] = time.perf_counter() - t0
        if not report["ok"]:
            raise AssertionError(f"phase 12 (c): verify_chain: "
                                 f"{report['errors'][:3]}")
        r_dir = os.path.join(tmp, "restored")
        t0 = time.perf_counter()
        r_ts = restore(dest, r_dir)
        out["restore"] = {"seconds": time.perf_counter() - t0,
                          "bytes": dir_bytes(r_dir), "ts": r_ts}
        t0 = time.perf_counter()
        rst = open_alpha(r_dir)
        out["restored_open_s"] = time.perf_counter() - t0
        same_tablets(rst.mvcc.base, src.mvcc.rollup(),
                     "(c) restored base")
        src_mix = ic_mix_bytes(src, queries)
        if ic_mix_bytes(rst, queries) != src_mix:
            raise AssertionError("phase 12 (c): the restored Alpha answers "
                                 "the IC mix differently")
        small = [qq for _n, qq in ldbc.ic_batch(g, copies=restored_copies)]
        view = rst.mvcc.read_view(rst.oracle.read_only_ts())
        plans, _left = plan_batch_groups_cached(view, small)
        k0 = counter_totals(("kernel_group_launches_total",))
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        t0 = time.perf_counter()
        got = rst.query_batch(small)
        out["restored_batch_s"] = time.perf_counter() - t0
        out["bucket_hop_launches"] = LAUNCHES["bucket_hop"]
        groups = sum(counter_delta(
            k0, counter_totals(("kernel_group_launches_total",))).values())
        if groups != len(plans):
            raise AssertionError(f"phase 12 (c): {groups} kernel groups "
                                 f"counted, {len(plans)} planned")
        if on_card and out["bucket_hop_launches"] < 1:
            raise AssertionError("phase 12 (c): the restored batch "
                                 "launched no bucket_hop")
        if got != src.query_batch(small):
            raise AssertionError("phase 12 (c): the restored batch differs "
                                 "from the source's")
        out["restored_batch"] = {"queries": len(small), "groups": groups}
        del view
        part("c_restore")

        # a restore in a child, SIGKILLed after `kill_after` tablets,
        # then resumed here: the same files as the clean restore
        k_dir = os.path.join(tmp, "killed")
        child = subprocess.Popen(
            [sys.executable, "-c", RESTORE_CHILD, dest, k_dir],
            stdout=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        written = 0
        try:
            for line in child.stdout:
                if line.startswith("tablet"):
                    written += 1
                    if written >= kill_after:
                        break
        finally:
            child.send_signal(signal.SIGKILL)
            child.wait()
        child = None
        if written < kill_after or not os.path.exists(
                os.path.join(k_dir, "restore.journal")):
            raise AssertionError(f"phase 12 (c): the killed restore wrote "
                                 f"{written} tablets and no journal")
        r0 = METRICS.get("restore_resumed_total")
        t0 = time.perf_counter()
        restore(dest, k_dir)
        out["resumed_restore"] = {
            "killed_after_tablets": written,
            "seconds": time.perf_counter() - t0,
            "resumed": METRICS.get("restore_resumed_total") - r0}
        if out["resumed_restore"]["resumed"] != 1 or dir_files(
                checkpoint.resolve(k_dir)) != dir_files(
                checkpoint.resolve(r_dir)):
            raise AssertionError("phase 12 (c): the resumed restore is not "
                                 "bit-identical to the clean one")
        part("c_killed_restore")

        # (d) maintenance under a reader on the card and a writer
        ok0 = {j: METRICS.get("maintenance_jobs_total", job=j, outcome="ok")
               for j in ("rollup", "checkpoint")}
        sched = src.attach_maintenance(p_dir, rollup_after=MAINT_ROLLUP_AFTER,
                                       checkpoint_every_s=MAINT_CHECKPOINT_S)
        stop = threading.Event()
        reads, errors = [], []
        read_qs = [queries[k] for k in MAINT_READ_TEMPLATES]

        def reader():
            i = 0
            while not stop.is_set():
                q = read_qs[i % len(read_qs)]
                i += 1
                try:
                    ts = src.oracle.read_only_ts()
                    with src._reading(ts):
                        card = src.query_raw(q, read_ts=ts)
                        host = Engine(src.mvcc.read_view(ts), device="cpu",
                                      device_threshold=HOST_ONLY)
                        with fusion(False):
                            want = host.query_bytes(q)
                    reads.append(ts)
                    if card != want:
                        errors.append((ts, q[:60]))
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(repr(e))

        rd = threading.Thread(target=reader)
        rd.start()
        stream = write_mix.make_mix(g, n=MAINT_WRITES,
                                    seed=write_mix.WRITE_SEED + 3, tag="m")
        t0 = time.perf_counter()
        done_jobs = {}
        for tx in stream.txns:
            src.mutate(**tx.kwargs())
            done_jobs = {j: METRICS.get("maintenance_jobs_total", job=j,
                                        outcome="ok") - ok0[j] for j in ok0}
            if all(done_jobs.values()) and len(reads) >= 2:
                break
            time.sleep(MAINT_WRITE_GAP_S)
        while not (all(done_jobs.values()) and len(reads) >= 2) and \
                time.perf_counter() - t0 < MAINT_MAX_S:
            time.sleep(0.05)
            done_jobs = {j: METRICS.get("maintenance_jobs_total", job=j,
                                        outcome="ok") - ok0[j] for j in ok0}
        stop.set()
        rd.join(120)
        if errors or not all(done_jobs.values()) or len(reads) < 2:
            raise AssertionError(f"phase 12 (d): jobs {done_jobs}, "
                                 f"{len(reads)} reads, errors {errors[:3]}")
        sched.pause()
        job = sched.request_checkpoint()
        try:
            job.wait(timeout=0.3)
            raise AssertionError("phase 12 (d): a job ran while paused")
        except TimeoutError:
            pass
        paused_status = sched.status()
        sched.resume()
        job.wait(timeout=120)
        t1 = time.perf_counter()
        src.shutdown()
        out["maintenance"] = {
            "jobs_ok": done_jobs, "reads": len(reads),
            "writes": sum(1 for _ in stream.txns), "seconds": t1 - t0,
            "paused_queue": len(paused_status["queued"]),
            "drain_s": time.perf_counter() - t1,
            "jobs_done": sched.status()["jobs_done"]}
        if sched._thread.is_alive():
            raise AssertionError("phase 12 (d): shutdown did not drain")
        part("d_maintenance")

        # (e) observability: a device profile, spans, the exposition
        prof_dir = os.path.join(tmp, "profile")
        tracing.profile_start(prof_dir)
        try:
            rst.query_batch(small)
        finally:
            tracing.profile_stop()
        files = glob.glob(os.path.join(prof_dir, "trace-*.json"))
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        hop_events = [e for e in events if e.get("cat") == "kernel"
                      and "bucket_hop" in e.get("name", "")]
        if on_card and not hop_events:
            raise AssertionError("phase 12 (e): the device trace holds no "
                                 "bucket_hop kernel")
        need = ("maintenance.job:rollup", "maintenance.job:checkpoint",
                "maintenance.job:restore", "maintenance.tablet:restore")
        if any(not spans.get(k) for k in need):
            raise AssertionError(f"phase 12 (e): spans {spans}")
        blocks = sum(1 for q in queries.values() for sg in parse(q)
                     if sg.shortest is None)
        f0 = counter_totals(("fused_route_total",))
        ic_mix_bytes(rst, queries)
        routed = sum(counter_delta(
            f0, counter_totals(("fused_route_total",))).values())
        if routed != blocks:
            raise AssertionError(f"phase 12 (e): {routed} blocks routed, "
                                 f"the IC mix has {blocks}")
        kinds = check_prometheus(METRICS.render())
        lat = {True: [], False: []}
        try:
            for rep in range(OBS_REPS):
                for flag in ((True, False) if rep % 2 else (False, True)):
                    tracing.set_enabled(flag)
                    METRICS.set_enabled(flag)
                    for k, qq in queries.items():
                        if k not in ("IC14", "config3"):
                            t1 = time.perf_counter()
                            rst.query_raw(qq)
                            lat[flag].append(time.perf_counter() - t1)
        finally:
            tracing.set_enabled(True)
            METRICS.set_enabled(True)
        out["observability"] = {
            "trace_file_bytes": os.path.getsize(files[0]),
            "trace_events": len(events),
            "bucket_hop_events": len(hop_events),
            "spans": spans, "fused_routed_blocks": routed,
            "exposition_series": kinds,
            "ic_mix_p50_ms_on": 1e3 * float(np.median(lat[True])),
            "ic_mix_p50_ms_off": 1e3 * float(np.median(lat[False]))}
        part("e_observability")
        for a in alphas:
            if a.wal is not None:
                a.wal.close()
        del src, rst
        alphas.clear()
        gc.collect()

        # (f) export and the loaders, at a cut scale
        g2 = ldbc.generate(sf=sf, seed=LDBC_SEED)
        b = StoreBuilder(parse_schema(ldbc.SCHEMA))
        ldbc.load_into(b, g2)
        exp = Alpha(base=b.finalize(), device=device,
                    device_threshold=LDBC_THRESHOLD)
        q2 = dict(ldbc.ic_templates(g2))
        q2["config3"] = ldbc.config3_query(g2)
        want2 = {k: exp.query_raw(q) for k, q in q2.items()}
        rdf_path = os.path.join(tmp, "export.rdf")
        t0 = time.perf_counter()
        n_rdf = exp.export_to(rdf_path)
        rdf_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_json = exp.export_to(os.path.join(tmp, "export.json"),
                               format="json")
        json_s = time.perf_counter() - t0
        with open(rdf_path) as f:
            rdf = f.read()
        t0 = time.perf_counter()
        bst = run_bulk(rdf, os.path.join(tmp, "bulk"),
                       schema_text=ldbc.SCHEMA, n_mappers=4)
        bulk_s = time.perf_counter() - t0
        bulked = open_alpha(os.path.join(tmp, "bulk"))
        live = Alpha(device=device, device_threshold=LDBC_THRESHOLD)
        live.alter(ldbc.SCHEMA)
        t0 = time.perf_counter()
        lst = run_live(live, rdf, batch_size=LIVE_BATCH, concurrency=1)
        live_s = time.perf_counter() - t0
        bad = []
        for k, q in q2.items():
            gb, gl = bulked.query_raw(q), live.query_raw(q)
            # the export carries no facets (the reference's format): a
            # facet-reading template is held between the two reloads
            if gb != gl or (k not in FACET_TEMPLATES and gb != want2[k]):
                bad.append(k)
        if bad or bst.nquads != n_rdf or lst.nquads != n_rdf:
            raise AssertionError(f"phase 12 (f): reloads differ on {bad} "
                                 f"({bst.nquads}/{lst.nquads} of {n_rdf})")
        out["export"] = {"sf": sf, "nodes": g2.n_nodes,
            "rdf_statements": n_rdf,
            "rdf_bytes": len(rdf), "rdf_s": rdf_s, "json_nodes": n_json,
            "json_s": json_s, "bulk_s": bulk_s, "bulk_nodes": bst.nodes,
            "live_s": live_s, "live_txns": lst.txns,
            "facet_templates": sorted(FACET_TEMPLATES)}
        part("f_export_loaders")
        if keep is not None:
            keep.update(tmp=tmp, p_dir=p_dir)
    finally:
        tracing.remove_sink(sink)
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        for a in alphas:
            if a.wal is not None:
                a.wal.close()
        if not keep:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def tensors_of(obj) -> list:
    """The tensors a DeviceEll holds, in attribute order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in tensors_of(x)]
    if hasattr(obj, "__dict__") and not isinstance(obj, torch.device):
        return [t for v in vars(obj).values() for t in tensors_of(v)]
    return []


# -- phase 10: GraphRAG retrieval and @msgpass -----------------------------------

def combine_case(rng, d: int, n_seg: int, n_edges: int, sort: bool,
                 integer: bool, hub: bool = False):
    """One random segment_combine input on the host: a tablet of 3000
    rows over a 12000-rank space (a quarter of the neighbours have a
    row), duplicate edges, a quarter of the segments empty, one segment
    whose neighbours all lack a row, a sentinel-padded tail of 37 dead
    slots; `hub` puts ~97 % of the edges in segment 0."""
    rows, space = 3000, 12000
    subj = np.sort(rng.choice(space, rows, replace=False)).astype(np.int32)
    vecs = (rng.integers(-3, 4, (rows, d)) if integer
            else rng.standard_normal((rows, d))).astype(np.float32)
    # half the neighbours from the tablet, half from the whole space
    nbrs = np.where(rng.random(n_edges) < 0.5,
                    rng.choice(subj, n_edges),
                    rng.integers(0, space, n_edges)).astype(np.int32)
    tenth = n_edges // 10
    nbrs[:tenth] = nbrs[tenth:2 * tenth]          # duplicate edges
    live = rng.choice(n_seg, max(n_seg * 3 // 4, 1), replace=False)
    seg = live[rng.integers(0, len(live), n_edges)].astype(np.int32)
    if hub:
        seg = np.where(rng.random(n_edges) < 0.97, 0, seg).astype(np.int32)
    nbrs[seg == live[-1]] = space + 1             # no row for these
    if sort:
        order = np.argsort(seg, kind="stable")
        nbrs, seg = nbrs[order], seg[order]
    snt = np.iinfo(np.int32).max
    nbrs = np.concatenate([nbrs, np.full(37, snt, np.int32)])
    seg = np.concatenate([seg, np.zeros(37, np.int32)])
    return subj, vecs, nbrs, seg, n_edges, n_seg


def bits_equal(a, b) -> bool:
    a = torch.as_tensor(a).contiguous().view(torch.int32).cpu()
    b = torch.as_tensor(b).contiguous().view(torch.int32).cpu()
    return a.shape == b.shape and torch.equal(a, b)


def sized_case(rng, d: int, lens, sort: bool, values: str = "normal"):
    """A segment_combine input with segments of exactly `lens` live edges
    (rows from a 3000-row tablet over a 12000-rank space: half the
    neighbours have a row), out-of-range seg slots among them (-1 and
    n_seg + 2: dropped), unsorted edges shuffled, and a sentinel-padded
    tail of 37 dead slots. `values`: "normal" N(0,1), or "signed" +0,
    -0, NaN, +-1 and +-inf (for max)."""
    rows, space = 3000, 12000
    n_seg = len(lens)
    subj = np.sort(rng.choice(space, rows, replace=False)).astype(np.int32)
    if values == "normal":
        vecs = rng.standard_normal((rows, d)).astype(np.float32)
    else:
        vecs = rng.choice(np.array([0.0, -0.0, np.nan, 1.0, -1.0, np.inf,
                                    -np.inf], np.float32), (rows, d))
    seg = np.repeat(np.arange(n_seg), lens)
    drop = rng.choice(np.array([-1, n_seg + 2]), 41)
    if sort:
        seg = np.concatenate([drop[drop < 0], seg, drop[drop >= 0]])
    else:
        seg = np.concatenate([seg, drop])[rng.permutation(len(seg) + 41)]
    seg = seg.astype(np.int32)
    n_edges = len(seg)
    nbrs = np.where(rng.random(n_edges) < 0.5, rng.choice(subj, n_edges),
                    rng.integers(0, space, n_edges)).astype(np.int32)
    snt = np.iinfo(np.int32).max
    nbrs = np.concatenate([nbrs, np.full(37, snt, np.int32)])
    seg = np.concatenate([seg, np.zeros(37, np.int32)])
    return subj, vecs, nbrs, seg, n_edges, n_seg


def host_want(subj, vecs, nbrs, seg, n: int, k: int, agg: str):
    """host_combine over the live slots whose seg lies in [0, k) (the
    dropped ones have no segment to go to)."""
    from dgraph_tpu_torch.engine.feat import host_combine

    nb, sg = nbrs[:n], seg[:n]
    ok = (sg >= 0) & (sg < k)
    return host_combine(subj, vecs, nb[ok], sg[ok], k, agg)


def device_case(subj, vecs, nbrs, seg, device, misalign: bool = False):
    """The case's tensors on the card; `misalign` puts vecs 4 bytes past a
    16-byte boundary (the scalar path at any d)."""
    t = [torch.from_numpy(a).to(device) for a in (subj, vecs, nbrs, seg)]
    if misalign:
        buf = torch.empty(vecs.size + 1, dtype=torch.float32, device=device)
        t[1] = buf[1:].view(vecs.shape)
        t[1].copy_(torch.from_numpy(vecs))
    return t


def graph_replays_equal(fn, replays: int = 2) -> bool:
    """Capture fn() in a CUDA graph (after a side-stream warm-up) and hold
    each replay's outputs bit-equal to an eager run."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    eager = fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn()
    ok = True
    for _ in range(replays):
        for o in outs:
            o.fill_(-7)
        graph.replay()
        torch.cuda.synchronize()
        ok &= all(bits_equal(a, b) for a, b in zip(outs, eager))
    del graph
    return ok


def phase_combine_cases(device) -> dict:
    """segment_combine against its plain version and host_combine on the
    card (phase 10 a). Integer-valued features: bit-exact against
    segment_combine_plain (order-free sums). N(0,1) features: bit-exact
    against engine/feat.host_combine (numpy, edge order) and against a
    second run of the kernel. Sorted seg runs with seg_sorted=True; the
    live count is a 0-d device tensor in the first run and an int in the
    second."""
    from dgraph_tpu_torch.ops.feat import (AGGS, LONG_MIN, segment_combine,
                                           segment_combine_plain)

    rng = np.random.default_rng(COMBINE_SEED)
    cases = [(d, agg, sort, integer, False, COMBINE_EDGES, 300)
             for d in COMBINE_DIMS for agg in AGGS
             for sort in (False, True) for integer in (True, False)]
    cases += [(384, agg, sort, True, True, HUB_EDGES, 4)
              for agg in AGGS for sort in (False, True)]
    cases += [(384, agg, False, False, True, HUB_EDGES, 4) for agg in AGGS]
    # exact-length segments around the long path's threshold, several
    # hubs beside short segments, ragged column tiles (d 100, 1000), the
    # scalar path (d 99; d 384 with vecs misaligned), and max over rows
    # of +0, -0, NaN and +-inf
    L = LONG_MIN
    sized = [(384, agg, sort, [L - 1, L, L + 1, 3, 0, L], "normal", False)
             for agg in AGGS for sort in (False, True)]
    sized += [(384, agg, sort, [30_000, 2, 0, 20_000, 517, 7, 12_000, 1],
               "normal", False) for agg in AGGS for sort in (False, True)]
    sized += [(d, agg, sort, [L + 1, 5, 3 * L, 0, 40], "normal", mis)
              for d, mis in ((100, False), (1000, False), (99, False),
                             (384, True))
              for agg in AGGS for sort in (False, True)]
    sized += [(d, "max", sort, [L + 3, 9, 2 * L, 1], "signed", False)
              for d in (8, 384) for sort in (False, True)]
    checked = 0

    def check(t, n, k, agg, sort, want, what):
        live = torch.tensor(n, dtype=torch.int32, device=device)
        got = segment_combine(*t, live, k, agg, seg_sorted=sort)
        again = segment_combine(*t, n, k, agg, seg_sorted=sort)
        if not all(bits_equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"segment_combine {what}: the runs with a "
                                 f"device and a host live count differ")
        if not all(bits_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"segment_combine {what}: differs from "
                                 f"its reference")
        return got

    for d, agg, sort, integer, hub, n_edges, n_seg in cases:
        subj, vecs, nbrs, seg, n, k = combine_case(
            rng, d, n_seg, n_edges, sort, integer, hub)
        t = device_case(subj, vecs, nbrs, seg, device)
        want = (segment_combine_plain(*t, n, k, agg) if integer
                else host_want(subj, vecs, nbrs, seg, n, k, agg))
        got = check(t, n, k, agg, sort, want,
                    f"d={d} {agg} sorted={sort} integer={integer} hub={hub}")
        if not torch.isfinite(got[0]).all():
            raise AssertionError(f"segment_combine d={d} {agg}: non-finite")
        checked += 1
    for d, agg, sort, lens, values, mis in sized:
        subj, vecs, nbrs, seg, n, k = sized_case(rng, d, lens, sort, values)
        t = device_case(subj, vecs, nbrs, seg, device, mis)
        check(t, n, k, agg, sort, host_want(subj, vecs, nbrs, seg, n, k, agg),
              f"d={d} {agg} sorted={sort} lens={lens} {values} "
              f"misaligned={mis}")
        checked += 1
    # one hub call and one featprop-shaped call captured in CUDA graphs
    graphs = 0
    for d, agg, lens, e_cap in ((384, "sum", [HUB_EDGES], HUB_EDGES + 2048),
                                (384, "mean", list(rng.integers(0, 4, 1024)),
                                 4096)):
        subj, vecs, nbrs, seg, n, k = sized_case(rng, d, lens, True)
        pad = e_cap - len(nbrs)
        nbrs = np.concatenate([nbrs, np.full(pad, nbrs[-1], np.int32)])
        seg = np.concatenate([seg, np.zeros(pad, np.int32)])
        t = device_case(subj, vecs, nbrs, seg, device)
        live = torch.tensor(n, dtype=torch.int32, device=device)
        want = host_want(subj, vecs, nbrs, seg, n, k, agg)
        if not all(bits_equal(a, b) for a, b in zip(
                segment_combine(*t, live, k, agg, seg_sorted=True), want)):
            raise AssertionError(f"segment_combine graph case {lens[:3]}: "
                                 f"differs from host_combine")
        if not graph_replays_equal(lambda: segment_combine(
                *t, live, k, agg, seg_sorted=True)):
            raise AssertionError(f"segment_combine graph case {lens[:3]}: a "
                                 f"replay differs from the eager run")
        graphs += 1
    torch.cuda.synchronize()
    return {"cases": checked, "graph_cases": graphs,
            "dims": sorted({c[0] for c in cases} | {c[0] for c in sized}),
            "hub_edges": HUB_EDGES, "long_min": LONG_MIN,
            "max_abs_err": 0.0}


def build_graphrag_store(g):
    """Phase 8's feature store with tools/graphrag_mix.py's `emb`
    predicate: one SF1 build serves phases 8 and 10."""
    from dgraph_tpu_torch.store.store import StoreBuilder
    from dgraph_tpu_torch.tools import feature_mix, graphrag_mix

    t0 = time.perf_counter()
    b = StoreBuilder()
    feature_mix.load_into(b, g)
    graphrag_mix.load_into(b, g)
    store = b.finalize()
    t = store.vec_tablet("emb")
    return store, {"build_s": time.perf_counter() - t0, "rows": t.rows,
                   "dim": t.dim, "tablet_bytes": int(t.vecs.nbytes)}


def sm_clocks_mhz() -> dict:
    """The SM clock now and its maximum, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.splitlines()[0]
    now, top = (float(x) for x in out.split(","))
    return {"sm_mhz": now, "max_sm_mhz": top}


def call_profile(fn, calls: int = 32, tries: int = 3) -> dict:
    """One call's device launches (kernels, copies, fills) and their
    device µs by kernel, from phase 3's profiler helper, and the host µs
    of one call enqueued without a synchronise (mean of `calls`). On the
    card machine the profiler can drop a session's ctypes launches (all
    of them when the session holds nothing else), so the call runs
    between two torch fills (the anchors, whose events are dropped), and
    a profile that still shows none of the call's launches is taken
    again, `tries` times at most."""
    from dgraph_tpu_torch.tools.hop_profile import device_events

    def anchor():
        torch.zeros(1, device="cuda")

    skip = len(device_events(anchor))
    evs = []
    for _ in range(tries):
        evs = device_events(lambda: (anchor(), fn(None), anchor()))
        evs = evs[skip:len(evs) - skip]
        if evs:
            break
    device_us: dict = {}
    for name, us in evs:
        short = name.replace("(anonymous namespace)::", "")
        short = short.split("(")[0].split("<")[0].split("::")[-1][-48:]
        device_us[short] = device_us.get(short, 0.0) + us
    fn(None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(None)
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return {"device_launches_per_call": len(evs), "device_us": device_us,
            "host_us_per_call": host_us}


def combine_timing(store, device, nbrs, seg, n_seg: int, agg: str,
                   seg_sorted: bool = False) -> dict:
    """segment_combine alone at one real shape (host arrays of the live
    edges), CUDA events, median of REPLAY_REPS: the whole call, the
    kernels alone (grouping sort, allocations and plan set up outside the
    events: ops/feat.Prepared), the plain version, and `index_add_` of the
    already gathered participating rows (the sum alone, a yardstick).
    Least bytes: each edge's (nbr, seg) and each distinct participating
    row read once, the outputs written once. Chain floor: the longest
    segment's participating edges x 4 cycles (one dependent FADD each) at
    the SM's maximum clock."""
    from dgraph_tpu_torch.ops.feat import (Prepared, segment_combine,
                                           segment_combine_plain)

    subj_d, vecs_d = store.vec_device("emb", device)
    t = store.vec_tablet("emb")
    d = t.dim
    nb = torch.from_numpy(np.ascontiguousarray(nbrs, np.int32)).to(device)
    sg = torch.from_numpy(np.ascontiguousarray(seg, np.int32)).to(device)
    n = len(nbrs)
    idx = np.minimum(np.searchsorted(t.subj, nbrs), t.rows - 1)
    has = t.subj[idx] == nbrs
    rows = vecs_d[torch.from_numpy(idx[has]).to(device).long()]
    tgt = torch.from_numpy(seg[has].astype(np.int64)).to(device)
    acc = torch.zeros((n_seg, d), dtype=torch.float32, device=device)
    nbytes = 8 * n + 4 * d * len(np.unique(nbrs[has])) + (4 * d + 8) * n_seg
    longest = int(np.bincount(seg[has], minlength=1).max()) if n else 0
    clocks = sm_clocks_mhz()

    def fn(_a):
        return segment_combine(subj_d, vecs_d, nb, sg, n, n_seg, agg,
                               seg_sorted=seg_sorted)

    def plain(_a):
        return segment_combine_plain(subj_d, vecs_d, nb, sg, n, n_seg, agg)

    call = Prepared(subj_d, vecs_d, nb, sg, n, n_seg, agg, seg_sorted)

    def kernels(_a):
        call.launch()

    # small-integer features: exact sums, so bit for bit in any order
    got, want = fn(None), plain(None)
    kernels(None)
    for name, out in (("call", got), ("kernels alone", call.outputs)):
        if not all(bits_equal(a, b) for a, b in zip(out, want)):
            raise AssertionError(f"segment_combine {agg} ({name}) at {n} "
                                 f"edges into {n_seg} segments differs from "
                                 f"its plain version")

    def library(_a):
        return acc.index_add_(0, tgt, rows)

    library(None)
    timed = {k: float(np.median(cuda_ms(f, REPLAY_REPS))) for k, f in
             (("ms", fn), ("kernels_ms", kernels), ("plain_ms", plain),
              ("library_ms", library))}
    return {**timed, "least_bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "chain_floor_ms": longest * 4 / (clocks["max_sm_mhz"] * 1e3),
            **clocks,
            **call_profile(fn),
            "max_abs_err": float((got[0] - want[0]).abs().max())
            if got[0].numel() else 0.0, "edges": n,
            "participating": int(has.sum()), "segments": n_seg,
            "largest_segment": int(np.bincount(seg, minlength=1).max())
            if n else 0, "longest_participating": longest,
            "dim": d, "agg": agg}


def knn_timing(store, device, q: np.ndarray, k: int) -> dict:
    """The device top-k alone on the whole tablet: torch.mv + keyed
    torch.topk (store/vec.device_topk) beside its plain version (the
    reference's shape: the same keys fully sorted, the first k taken)
    and the least-bytes bound (the tablet and its ranks read once)."""
    from dgraph_tpu_torch.store.vec import device_topk, topk_keys

    subj_d, vecs_d = store.vec_device("emb", device)
    q_d = torch.from_numpy(q).to(device)

    def plain(_a):
        keys = topk_keys(torch.mv(vecs_d, q_d), subj_d)
        return torch.sort(subj_d[torch.sort(keys).indices[:k]]).values

    got = device_topk(subj_d, vecs_d, q_d, k)
    if not torch.equal(got, plain(None)):
        raise AssertionError("device top-k differs from its plain version")
    nbytes = int(vecs_d.numel() * 4 + subj_d.numel() * 4 + q_d.numel() * 4
                 + 4 * min(k, subj_d.numel()))
    return {"ms": float(np.median(cuda_ms(
                lambda _a: device_topk(subj_d, vecs_d, q_d, k), REPLAY_REPS))),
            "plain_ms": float(np.median(cuda_ms(plain, REPLAY_REPS))),
            "least_bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "rows": int(subj_d.numel()), "k": k,
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def route_counts(name: str) -> dict:
    """A route counter of the metrics registry, per route label."""
    from dgraph_tpu_torch.utils.metrics import METRICS
    return {r: METRICS.get(name, route=r)
            for r in ("host", "device", "fused")}


def phase_graphrag(device, g, store) -> dict:
    """Per-query and batched serving of the GraphRAG mix (phase 10 b-d)."""
    from dgraph_tpu_torch.dql.parser import parse
    from dgraph_tpu_torch.engine import Engine, batch, fused
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES as HOP
    from dgraph_tpu_torch.ops.feat import LAUNCHES as COMBINE
    from dgraph_tpu_torch.store import vec
    from dgraph_tpu_torch.tools import graphrag_mix

    on_card = torch.device(device).type == "cuda"
    if on_card and torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on: the knn scores must be "
                             "full float32")
    queries = graphrag_mix.templates(g)
    host = Engine(store, device="cpu", device_threshold=HOST_ONLY)
    t0 = time.perf_counter()
    with fusion(False):     # the pure numpy route
        want = {k: host.query_bytes(q) for k, q in queries.items()}
    host_pass_s = time.perf_counter() - t0
    fused.reset()
    knn0, feat0 = route_counts("knn_route_total"), \
        route_counts("feat_route_total")
    for d in (HOP, COMBINE):
        for k in d:
            d[k] = 0
    eng = Engine(store, device=device, device_threshold=LDBC_THRESHOLD)
    per, programs = {}, {}
    expect = {"knn_hop": ["knn", "hop"], "knn_uid": ["knn", "hop"],
              "knn_recurse": ["knn", "recurse"],
              "featprop_sum": ["recurse", "featprop"],
              "featprop_mean": ["recurse", "featprop"],
              "featprop_max": ["recurse", "featprop"],
              "knn_featprop": ["knn", "recurse", "featprop"],
              "msgpass_author": None, "msgpass_hub": None}
    for k, q in queries.items():
        kinds = [[st.kind for st in p.stages] if p else None
                 for p in (fused.plan_block(store, sg) for sg in parse(q))]
        if kinds != [expect[k]]:
            raise AssertionError(f"{k}: planned {kinds}, want "
                                 f"{[expect[k]]}")
        before = (fused.status(), route_counts("knn_route_total"),
                  route_counts("feat_route_total"),
                  dict(eng.routes.expansions), COMBINE["segment_combine"])
        had = set(map(id, fused.captured()))
        t0 = time.perf_counter()
        got = eng.query_bytes(q)
        cold_ms = (time.perf_counter() - t0) * 1e3
        if got != want[k]:
            raise AssertionError(f"{k}: the card's response differs from "
                                 f"the numpy route")
        warm = lat_ms(lambda q=q: eng.query_bytes(q), GRAPHRAG_REPS)
        after = fused.status()
        programs[k] = [p for p in fused.captured() if id(p) not in had]
        fused_blocks = after["routes"]["fused"] - before[0]["routes"]["fused"]
        per[k] = {"stages": kinds[0],
                  "fused_blocks": after["routes"]["fused"]
                  - before[0]["routes"]["fused"],
                  "captures": after["captures"] - before[0]["captures"],
                  "knn_routes": {r: n - before[1][r] for r, n in
                                 route_counts("knn_route_total").items()
                                 if n - before[1][r]},
                  "feat_routes": {r: n - before[2][r] for r, n in
                                  route_counts("feat_route_total").items()
                                  if n - before[2][r]},
                  "expansions": {r: n - before[3][r] for r, n in
                                 eng.routes.expansions.items()
                                 if n - before[3][r]},
                  "segment_combine_launches":
                      COMBINE["segment_combine"] - before[4],
                  "segment_combine_per_replay":
                      [p.combines for p in programs[k]],
                  "cold_ms": cold_ms, "p50_ms": float(np.median(warm)),
                  "response_bytes": len(got)}
        if on_card and expect[k] is not None and not per[k]["fused_blocks"]:
            raise AssertionError(f"{k}: no block fused")
        if on_card and "featprop" in (expect[k] or ()):
            # one captured program serves every request of the
            # template: each fused block is one replay of its `combines`
            # launches; the rest are whole eager warm-up runs (one per
            # caps tried)
            p, = programs[k]
            replay = p.combines * fused_blocks
            eager = per[k]["segment_combine_launches"] - replay
            per[k]["segment_combine_replay_launches"] = replay
            if not p.combines or eager < p.combines or eager % p.combines:
                raise AssertionError(
                    f"{k}: {per[k]['segment_combine_launches']} "
                    f"segment_combine launches for {fused_blocks} replays "
                    f"of {p.combines} and whole warm-up runs")
    # the main path's launches in (b), read before the checks and
    # timings below launch the kernel themselves
    staged = sum(per[k]["segment_combine_launches"]
                 for k in ("msgpass_author", "msgpass_hub"))
    replayed = sum(r.get("segment_combine_replay_launches", 0)
                   for r in per.values())
    combine_b = COMBINE["segment_combine"]
    checked = 0
    if on_card:
        checked = replay_rows(programs, per, store.n_nodes)
        want_checked = sum(1 for k in programs for p in programs[k]
                           if any(st.kind in ("knn", "featprop")
                                  for st in p.stages))
        if not want_checked or checked < want_checked:
            raise AssertionError(f"{checked} captured programs checked, "
                                 f"{want_checked} with knn or featprop")
    fp_prog = (programs.get("featprop_mean") or [None])[0]
    if on_card and fp_prog is None:
        raise AssertionError("featprop_mean captured no program")
    programs.clear()

    # (c) one query_batch of knn_hop, knn_recurse and featprop_* queries
    pairs = graphrag_mix.batch(g, GRAPHRAG_KNN_COPIES, GRAPHRAG_FEAT_COPIES)
    names = [nm for nm, _q in pairs]
    qs = [q for _nm, q in pairs]
    plans, leftover = batch.plan_batch_groups_cached(store, qs)
    family = {"TreePlan": "tree", "_ShortestPlan": "shortest",
              "_BatchPlan": "recurse"}
    families: dict = {"tree": [], "recurse": [], "shortest": [],
                      "left over": sorted({names[i] for i in leftover})}
    for p, idxs in plans:
        families[family[type(p).__name__]].append(
            sorted({names[i] for i in idxs}))
    if (families["recurse"] != [["knn_recurse"]]
            or families["tree"] != [["knn_hop"]]
            or families["left over"] != ["featprop_max", "featprop_mean",
                                         "featprop_sum"]):
        raise AssertionError(f"GraphRAG batch planned {families}")
    for d in (HOP, COMBINE):
        for k in d:
            d[k] = 0
    t0 = time.perf_counter()
    got = batch.query_batch(store, qs, device=device)
    cold_s = time.perf_counter() - t0
    batch_hops = HOP["bucket_hop"]
    combine_c = COMBINE["segment_combine"]
    t0 = time.perf_counter()
    again = batch.query_batch(store, qs, device=device)
    warm_s = time.perf_counter() - t0
    if on_card and batch_hops < 1:
        raise AssertionError("the GraphRAG batch launched no bucket_hop")
    card = Engine(store, device=device, device_threshold=LDBC_THRESHOLD)
    t0 = time.perf_counter()
    per_query = [card.query(q) for q in qs]
    per_query_s = time.perf_counter() - t0
    bad = sorted({names[i] for i in range(len(qs))
                  if json.dumps(got[i], sort_keys=True)
                  != json.dumps(per_query[i], sort_keys=True)
                  or json.dumps(again[i], sort_keys=True)
                  != json.dumps(per_query[i], sort_keys=True)})
    if bad or any("errors" in r for r in got):
        raise AssertionError(f"GraphRAG batch responses differ from the "
                             f"per-query engine for {bad}")
    by_path = {"staged @msgpass (phase 10 b)": staged,
               "featprop program replays (phase 10 b)": replayed,
               "featprop program warm-ups (phase 10 b)":
                   combine_b - staged - replayed,
               "query_batch @msgpass, per query (phase 10 c)": combine_c}
    if on_card and not (batch_hops and staged and replayed and combine_c):
        raise AssertionError(f"phase 10 launched a kernel no time on a "
                             f"path: bucket_hop {batch_hops}, "
                             f"segment_combine {by_path}")
    status = fused.status()
    if status["fallbacks"] or status["routes"]["fallback"]:
        raise AssertionError(f"fused fallbacks: {status}")

    # (d) the device top-k and segment_combine alone at real shapes
    timing = {}
    if on_card:
        sg = parse(queries["knn_hop"])[0]
        timing["device_topk"] = knn_timing(
            store, device, vec.resolve_query(store, sg.func)[2],
            int(sg.func.args[0]))
        roots, _ex = eng._run(queries["msgpass_hub"])
        node = roots[0]
        timing["segment_combine_msgpass_hub"] = combine_timing(
            store, device,
            np.concatenate([c.matrix_child for c in node.children]),
            np.concatenate([c.matrix_seg for c in node.children]),
            len(node.nodes), "sum")
        # the template's own program, its inputs set by one more request
        prog = fp_prog
        eng.query_bytes(queries["featprop_mean"])
        with prog.lock:
            outs, _sz = prog.fn(prog.rels, prog.static_in)
        nbrs_h, seg_h, kept_h, fr_h, _t, _u = (t.cpu().numpy()
                                               for t in outs[0])
        hops = [combine_timing(store, device, nbrs_h[h][:kept_h[h]],
                               seg_h[h][:kept_h[h]], fr_h.shape[1], "mean",
                               seg_sorted=True)
                for h in range(len(kept_h))]
        timing["segment_combine_featprop_mean"] = {
            "per_hop": hops,
            **{key: sum(h[key] for h in hops)
               for key in ("ms", "kernels_ms", "plain_ms", "library_ms",
                           "least_bytes", "bound_ms", "chain_floor_ms",
                           "device_launches_per_call", "host_us_per_call")},
            "bound_by": "bytes",
            "max_abs_err": max(h["max_abs_err"] for h in hops)}
    return {"store": {"nodes": store.n_nodes}, "host_pass_s": host_pass_s,
            "byte_equal": True, "templates": per,
            "p50_ms": {k: r["p50_ms"] for k, r in per.items()},
            "programs_checked": checked, "status": status,
            "knn": {r: n - knn0[r] for r, n in
                    route_counts("knn_route_total").items()},
            "feat": {r: n - feat0[r] for r, n in
                     route_counts("feat_route_total").items()},
            "batch_queries": len(qs), "batch_families": families,
            "batch_bucket_hop_launches": batch_hops,
            "batch_cold_s": cold_s, "batch_warm_s": warm_s,
            "per_query_engine_s": per_query_s,
            "batch_equal_to_per_query_engine": True,
            "segment_combine_launches_by_path": by_path,
            "timing": timing}


# -- phase 13: the memory governor and the cost model --------------------------

def oom_events() -> float:
    return sum(counter_totals(("oom_events_total",)).values())


def no_oom(phase: str, since: float = 0.0) -> None:
    """Fail `phase` if the run so far (past `since` allocation failures:
    phase 13 counts its own) counted an allocation failure or degraded a
    shape: outside phase 13's own pressure, no degraded route may stand
    in for a kernel's result."""
    from dgraph_tpu_torch.utils import memgov
    from dgraph_tpu_torch.utils.metrics import METRICS
    events = oom_events() - since
    degraded = METRICS.snapshot()["gauges"].get("oom_degraded", 0.0)
    st = memgov.GOVERNOR.oom_stats()
    if events or degraded or st["events"] or st["degraded"]:
        raise AssertionError(f"{phase}: allocation failures {events} "
                             f"counted, {degraded} shapes degraded "
                             f"({st})")


class _Records(logging.Handler):
    """Keeps the messages of the records it is handed."""

    def __init__(self, level):
        super().__init__(level)
        self.messages: list = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def family_launches(run):
    """(run(), bucket_hop launches per kernel family, all launches): each
    family's cost-profile record (`costprofile.add_kernel`, called once
    per group after its run) is credited the launches since the record
    before it."""
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES
    from dgraph_tpu_torch.utils import costprofile

    real = costprofile.add_kernel
    start = last = LAUNCHES["bucket_hop"]
    per: dict = {}

    def probe(family, compile_us=0.0, execute_us=0.0):
        nonlocal last
        now = LAUNCHES["bucket_hop"]
        per[family] = per.get(family, 0) + now - last
        last = now
        real(family, compile_us=compile_us, execute_us=execute_us)

    costprofile.add_kernel = probe
    try:
        out = run()
    finally:
        costprofile.add_kernel = real
    return out, per, LAUNCHES["bucket_hop"] - start


def prior_source(plan) -> str:
    """Where `plan_cost_us` takes a group's prediction from."""
    from dgraph_tpu_torch.engine import batch
    from dgraph_tpu_torch.engine.treebatch import TreePlan
    from dgraph_tpu_torch.utils import costprior
    if costprior.PRIORS.predict_shape(batch._plan_shape(plan)) is not None:
        return "prior"
    n = batch._plan_queries(plan)
    depth = (len(plan.stages) if isinstance(plan, TreePlan)
             else plan.depth)
    feats = {"lanes": batch._lane_count(n), "depth": depth, "queries": n}
    if costprior.PRIORS.predict_features(feats) is not None:
        return "fit"
    return "count"


def phase_memory_cost(device, g, handoff: dict, rag,
                      keep: dict | None = None) -> dict:
    """Phase 13: the memory governor and the cost model on phase 12's
    SF1 Alpha (its directory, which this phase removes unless `keep` is
    given: then it hands the directory on through `keep`) and on phase
    10's GraphRAG store."""
    import shutil

    from dgraph_tpu_torch.engine import Engine, batch
    from dgraph_tpu_torch.models import ldbc
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES
    from dgraph_tpu_torch.server.api import Alpha
    from dgraph_tpu_torch.tools import graphrag_mix
    from dgraph_tpu_torch.utils import costprior, costprofile, memgov
    from dgraph_tpu_torch.utils.metrics import METRICS

    on_card = torch.device(device).type == "cuda"
    GOV = memgov.GOVERNOR
    tmp, p_dir = handoff["tmp"], handoff["p_dir"]
    out: dict = {}
    parts = out["parts_s"] = {}
    t_part = [time.perf_counter()]
    alphas: list = []

    def part(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    def open_alpha():
        a = Alpha.open(p_dir, device=device, device_threshold=LDBC_THRESHOLD)
        alphas.append(a)
        return a

    def oom():
        return {**GOV.oom_stats(),
                "events_total": sum(counter_totals(
                    ("oom_events_total",)).values()),
                "degraded_gauge": METRICS.snapshot()["gauges"].get(
                    "oom_degraded", 0.0)}

    def canon(results) -> list:
        return [json.dumps(r, sort_keys=True) for r in results]

    queries = dict(ldbc.ic_templates(g))
    queries["config3"] = ldbc.config3_query(g)
    rng = np.random.default_rng(LDBC_SEED)
    persons = rng.choice(g.person_uids, MEMCOST_RECURSE, replace=False)

    def recurse_group(depth):
        return ["{ q(func: uid(%s)) @recurse(depth: %d) { uid knows } }"
                % (hex(int(p)), depth) for p in persons]

    ic = [q for _n, q in ldbc.ic_batch(g, copies=MEMCOST_BATCH_COPIES)]
    work = ic + recurse_group(MEMCOST_RECURSE_DEPTH)
    deep = recurse_group(MEMCOST_OOM_DEPTH)
    shortest = [q for n, q in ldbc.ic_batch(g, copies=MEMCOST_BATCH_COPIES)
                if n == "IC13"]
    try:
        # phase 10's placed tablets go first: the budget below is over
        # this Alpha's caches
        GOV.set_budgets(device_bytes=1)
        GOV.evict_to_low("device")
        GOV.reset()
        costprofile.reset()
        costprior.reset()
        torch.cuda.empty_cache()
        a = open_alpha()
        ts = a.oracle.read_only_ts()
        host = Engine(a.mvcc.read_view(ts), device="cpu",
                      device_threshold=HOST_ONLY)
        with fusion(False):
            want_mix = {k: host.query_bytes(q) for k, q in queries.items()}
            want_work = canon(host.query(q) for q in work)
            want_deep = canon(host.query(q) for q in deep)
        part("reference_answers")

        # (a) the cost model: the mix 4 times; the batch cold, then with
        # the priors on until every group's launch shape has its prior,
        # then as two interleaved pairs with priors on and off
        for _ in range(MEMCOST_MIX_PASSES):
            if ic_mix_bytes(a, queries) != want_mix:
                raise AssertionError("phase 13 (a): the IC mix differs "
                                     "from the numpy route")
        walls = {True: [], False: []}
        fam_total: dict = {}
        hop_total = 0
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        # a cold run (ELL builds, program captures), the teaching runs,
        # then the two pairs
        for on in ((None,) + ("teach",) * MEMCOST_TEACH_PASSES
                   + (True, False, False, True)):
            costprior.set_enabled(on is not False)
            t0 = time.perf_counter()
            got, per, hops = family_launches(lambda: a.query_batch(work))
            walls.setdefault(on, []).append(time.perf_counter() - t0)
            if canon(got) != want_work:
                raise AssertionError(f"phase 13 (a): the batch (priors "
                                     f"{on}) differs from the numpy route")
            for k, v in per.items():
                fam_total[k] = fam_total.get(k, 0) + v
            hop_total += hops
        out["bucket_hop_launches"] = LAUNCHES["bucket_hop"]
        costprior.set_enabled(True)
        summ = costprofile.summary(top_n=5)
        comps = {c.split(":")[0] for sh in summ["shapes"]
                 for c in sh.split("+")}
        lanes = {"recurse", "tree", "shortest"}
        if not lanes <= comps:
            raise AssertionError(f"phase 13 (a): the cost profile names "
                                 f"{sorted(comps)}, not every lane family")
        if sum(fam_total.values()) != hop_total or (on_card and any(
                fam_total.get(f, 0) < 1 for f in lanes)):
            raise AssertionError(f"phase 13 (a): launches per family "
                                 f"{fam_total} against bucket_hop's "
                                 f"{hop_total}")
        out["a_cost"] = {
            "records": summ["records_total"], "shapes": len(summ["shapes"]),
            "top": summ["top"][:3], "launches_by_family": fam_total,
            "bucket_hop_launches": hop_total,
            "batch_queries": len(work), "batch_cold_s": walls[None][0],
            "batch_wall_s_teaching": walls["teach"],
            "batch_wall_s_priors_on": walls[True],
            "batch_wall_s_priors_off": walls[False]}
        part("a_serve")

        fit = costprior.refit()
        view = a.mvcc.read_view(a.oracle.read_only_ts())
        plans, _left = batch.plan_batch_groups_cached(view, work)
        saved = {batch._plan_shape(p): batch.plan_cost_us(p)
                 for p, _i in plans}
        a.checkpoint_to(p_dir)
        for x in alphas:
            if x.wal is not None:
                x.wal.close()
        del a, view, host
        alphas.clear()
        gc.collect()
        costprofile.reset()
        costprior.reset()
        t0 = time.perf_counter()
        b = open_alpha()
        out["reopen_s"] = time.perf_counter() - t0
        view = b.mvcc.read_view(b.oracle.read_only_ts())
        plans, _left = batch.plan_batch_groups_cached(view, work)
        ordered = batch.order_plans_by_cost(plans)
        gauges = METRICS.snapshot()["gauges"]
        preds = [{"group": batch._plan_shape(p),
                  "queries": batch._plan_queries(p),
                  "predicted_us": batch.plan_cost_us(p),
                  "source": prior_source(p)} for p, _i in ordered]
        if any(e["predicted_us"] != saved[e["group"]] or
               e["predicted_us"] <= 0 or e["source"] != "prior"
               for e in preds) or \
                [p for p, _i in ordered] == [p for p, _i in plans]:
            raise AssertionError(f"phase 13 (a): the reopened Alpha "
                                 f"predicts {preds} (saved {saved}), in "
                                 f"plan order: {ordered == plans}")
        out["a_priors"] = {
            "refit": {k: v for k, v in fit.items() if k != "fit"},
            "fit_r2": (fit["fit"] or {}).get("r2"),
            "launch_order": preds,
            "pack_imbalance": {
                st: gauges.get(f'plan_pack_imbalance{{stage="{st}"}}')
                for st in ("count", "predicted")}}
        del view
        no_oom("phase 13 (a)")
        part("a_reopen")

        # (b) a device budget of half the warmed caches: every device
        # cache emptied first, so what the budget governs is this
        # Alpha's working set
        GOV.set_budgets(device_bytes=1)
        GOV.evict_to_low("device")
        GOV.reset()
        if canon(b.query_batch(work)) != want_work or \
                ic_mix_bytes(b, queries) != want_mix:
            raise AssertionError("phase 13 (b): the reopened Alpha's "
                                 "warm-up differs")
        warm = GOV.cache_bytes("device")
        budget = sum(warm.values()) // 2
        high = int(budget * memgov.HIGH_WATERMARK)
        r0 = counter_totals(("cache_replacements_total",
                             "vec_replacements_total",
                             "cache_evictions_total"))
        # what the allocator holds for live tensors, warm: the governed
        # bytes must really be freed, not only struck from the count
        gc.collect()
        alloc_warm = torch.cuda.memory_allocated() if on_card else 0
        GOV.set_budgets(device_bytes=budget)
        # a budget takes effect at the next fill; one pass now brings the
        # warm caches under it before the first request
        GOV.maybe_evict("device")
        peaks, allocs = [], []

        def bounded(what):
            peaks.append(GOV.resident_bytes("device"))
            allocs.append(torch.cuda.memory_allocated() if on_card else 0)
            if allocs[-1] > alloc_warm:
                # tensors only a reference cycle still holds
                gc.collect()
                allocs[-1] = torch.cuda.memory_allocated()
            if peaks[-1] > high or allocs[-1] > alloc_warm:
                raise AssertionError(f"phase 13 (b): {what} left "
                                     f"{peaks[-1]} device bytes resident "
                                     f"(high watermark {high}) and "
                                     f"{allocs[-1]} allocated (warm "
                                     f"{alloc_warm}): "
                                     f"{GOV.cache_bytes('device')}")

        if canon(b.query_batch(work)) != want_work:
            raise AssertionError("phase 13 (b): the batch under the budget "
                                 "differs")
        bounded("the batch")
        for k, q in queries.items():
            if b.query_raw(q) != want_mix[k]:
                raise AssertionError(f"phase 13 (b): {k} under the budget "
                                     f"differs")
            bounded(k)
        moved = counter_delta(r0, counter_totals(
            ("cache_replacements_total", "vec_replacements_total",
             "cache_evictions_total")))
        evicted = GOV.evictions()
        replaced = sum(v for k, v in moved.items()
                       if "replacements" in k)
        if not sum(evicted.values()) or not replaced:
            raise AssertionError(f"phase 13 (b): evictions {evicted}, "
                                 f"re-placements {moved}")
        out["b_budget"] = {"warm_bytes": warm, "budget": budget,
                           "registrants": {
                               k: v["registrants"] for k, v in
                               GOV.status()["caches"].items()},
                           "high": high, "max_resident": max(peaks),
                           "allocated_warm": alloc_warm,
                           "max_allocated": max(allocs),
                           "evictions": evicted, "counters": moved,
                           "status": {k: v["bytes"] for k, v in
                                      b.status()["caches"].items()}}
        GOV.set_budgets()
        no_oom("phase 13 (b)")
        part("b_budget")

        # (c) a real allocation failure under a cap on the allocator
        steps = out["c_oom"] = {}
        if on_card:
            total = torch.cuda.get_device_properties(0).total_memory

            caps = []

            def capped(run):
                torch.cuda.empty_cache()
                caps.append(torch.cuda.memory_reserved() + MEMCOST_CAP_MARGIN)
                torch.cuda.set_per_process_memory_fraction(caps[-1] / total)
                try:
                    return run()
                finally:
                    torch.cuda.set_per_process_memory_fraction(1.0)

            def drop_all():
                GOV.set_budgets(device_bytes=1)
                GOV.evict_to_low("device")
                GOV.set_budgets()

            with fusion(False):
                if canon(b.query_batch(deep)) != want_deep:
                    raise AssertionError("phase 13 (c): the deep group "
                                         "differs")
                # 1. the governed caches hold memory: one failure, absorbed
                held = GOV.resident_bytes("device")
                s0, h0 = oom(), LAUNCHES["bucket_hop"]
                got = capped(lambda: b.query_batch(deep))
                s1 = oom()
                if canon(got) != want_deep or \
                        s1["events"] != s0["events"] + 1 or s1["degraded"] or \
                        LAUNCHES["bucket_hop"] == h0:
                    raise AssertionError(f"phase 13 (c) 1: {s0} -> {s1}")
                steps["absorbed"] = {"governed_bytes_before": held,
                                     "cap": caps[-1], "oom": s1}
                # 2. nothing left to evict: the retry fails too, and the
                # error goes to the caller (a warning); nothing is served
                # from the host and nothing stays degraded
                drop_all()
                warned = _Records(logging.WARNING)
                log = logging.getLogger("dgraph_tpu_torch.memgov")
                log.addHandler(warned)
                raised = None
                try:
                    capped(lambda: b.query_batch(deep))
                except Exception as e:  # noqa: BLE001 — classified below
                    if not memgov.is_alloc_failure(e):
                        raise
                    raised = f"{type(e).__name__}: {str(e).splitlines()[0]}"
                finally:
                    log.removeHandler(warned)
                s2 = oom()
                if raised is None or s2["degraded"] or \
                        s2["events"] != s1["events"] + 1 or \
                        len(warned.messages) != 1:
                    raise AssertionError(f"phase 13 (c) 2: raised {raised}, "
                                         f"{s1} -> {s2}, warnings "
                                         f"{warned.messages}")
                steps["raised"] = {"cap": caps[-1], "oom": s2, "error": raised,
                                   "warning": warned.messages[0]}
                # 3. the cap lifted: the card route serves at once
                h0 = LAUNCHES["bucket_hop"]
                if canon(b.query_batch(deep)) != want_deep or \
                        LAUNCHES["bucket_hop"] == h0 or oom() != s2:
                    raise AssertionError("phase 13 (c) 3: the card route did "
                                         "not serve after the failure")
                steps["after_failure_bucket_hop_launches"] = \
                    LAUNCHES["bucket_hop"] - h0
            part("c_real_oom")

        # 4. the degraded route: both attempts of a program fail
        # (injected), and the staged torch ops serve it on the card;
        # 5. one injected allocation failure at each governed site
        rag_eng = Engine(rag, device=device, device_threshold=LDBC_THRESHOLD)
        rq = graphrag_mix.templates(g)
        from dgraph_tpu_torch.engine import fused

        def fused_routes(q):
            r0 = fused.status()["routes"]
            b.query_raw(q)
            return {k: v - r0[k] for k, v in fused.status()["routes"].items()}

        # a query of one block, served by its whole-block program
        fused_q = next(q for q in queries.values() if fused_routes(q) ==
                       {"fused": 1, "staged": 0, "fallback": 0})
        order_q = ("{ q(func: uid(%s)) { knows (orderasc: first_name) "
                   "{ uid } } }" % ", ".join(hex(int(p)) for p in persons))

        def staged(fn):
            def run():
                with fusion(False):
                    return fn()
            return run

        def at_zero(fn):
            def run():
                b.device_threshold = 0
                try:
                    return staged(fn)()
                finally:
                    b.device_threshold = LDBC_THRESHOLD
            return run

        sites = {
            "bfs.ell_recurse": lambda: b.query_batch(work[-MEMCOST_RECURSE:]),
            "bfs.ell_step": lambda: b.query_batch(shortest),
            "fused.program": lambda: b.query_raw(fused_q),
            "hop.gather_edges": at_zero(lambda: b.query_raw(order_q)),
            "vec.topk": staged(lambda: rag_eng.query_bytes(rq["knn_hop"])),
            "feat.agg": staged(
                lambda: rag_eng.query_bytes(rq["msgpass_author"])),
        }
        # 4. both attempts of the program fail: the shape degrades to
        # the staged torch ops on the card, sticky until the reset
        want_f = b.query_raw(fused_q)
        routes0 = fused.status()["routes"]
        s3 = oom()
        warned = _Records(logging.WARNING)
        log = logging.getLogger("dgraph_tpu_torch.memgov")
        log.addHandler(warned)
        memgov.set_alloc_fault(lambda site: site == "fused.program")
        try:
            got = b.query_raw(fused_q)
        finally:
            memgov.set_alloc_fault(None)
            log.removeHandler(warned)
        s4 = oom()
        again = b.query_raw(fused_q)
        routes1 = fused.status()["routes"]
        if got != want_f or again != want_f or \
                s4["events"] != s3["events"] + 1 or \
                s4["degraded"] != s3["degraded"] + 1 or \
                len(warned.messages) != 1 or oom() != s4 or \
                routes1["fallback"] != routes0["fallback"] + 2 or \
                routes1["fused"] != routes0["fused"]:
            raise AssertionError(f"phase 13 (c) 4: {s3} -> {s4}, routes "
                                 f"{routes0} -> {routes1}, warnings "
                                 f"{warned.messages}")
        GOV.reset()
        if b.query_raw(fused_q) != want_f or \
                fused.status()["routes"]["fused"] != routes1["fused"] + 1:
            raise AssertionError("phase 13 (c) 4: the program did not "
                                 "serve after the reset")
        steps["degraded_on_card"] = {
            "oom": s4, "warning": warned.messages[0],
            "routes": {k: routes1[k] - routes0[k] for k in routes1}}
        part("c_degraded")
        injected = steps["injected"] = {}
        from dgraph_tpu_torch.ops.feat import LAUNCHES as COMBINE
        for site, run in sites.items():
            if site == "feat.agg":
                for k in COMBINE:
                    COMBINE[k] = 0
            want = run()
            armed = [True]

            def hook(s, site=site, armed=armed):
                if armed[0] and s == site:
                    armed[0] = False
                    return True
                return False

            before = oom()
            memgov.set_alloc_fault(hook)
            try:
                got = run()
            finally:
                memgov.set_alloc_fault(None)
            after = oom()
            if armed[0] or got != want or \
                    after["events"] != before["events"] + 1 or \
                    after["degraded"] != before["degraded"]:
                raise AssertionError(f"phase 13 (c) 5 {site}: armed "
                                     f"{armed[0]}, {before} -> {after}")
            injected[site] = after["events_total"] - before["events_total"]
            if site == "feat.agg":
                out["segment_combine_launches"] = COMBINE["segment_combine"]
        part("c_injected")
        out["status"] = {"oom": b.status()["oom"],
                         "cost_priors": {k: b.status()["cost_priors"][k]
                                         for k in ("shapes", "hits",
                                                   "fallbacks", "refits")}}
    except BaseException:
        say("phase 13 memory and cost (stopped)", **out)
        keep = None             # a failed phase hands nothing on
        raise
    finally:
        if on_card:
            torch.cuda.set_per_process_memory_fraction(1.0)
        memgov.set_alloc_fault(None)
        GOV.reset()
        for x in alphas:
            if x.wal is not None:
                x.wal.close()
        if keep is None:
            shutil.rmtree(tmp, ignore_errors=True)
        else:
            keep.update(tmp=tmp, p_dir=p_dir)
    return out


# phase 14: the front end over real sockets (server/http.py)
FRONT_PASSES = 3                # (a) IC-mix passes, over HTTP and in process
FRONT_COMMIT_NOW = 6            # (b) write_mix txns through /mutate?commitNow
FRONT_TWO_STEP = 2              # (b) through /mutate, then /commit (20 and 5
#                                 before phase 15)
FRONT_CLIENTS = 16              # (c) concurrent batch clients over (2, 2)
FRONT_DISCONNECT_AFTER_S = 0.3  # (c) the hung-up batch: admitted this long
FRONT_SLOW_IC14 = 8             # (c) IC14 queries that keep that batch busy
FRONT_COLD_THREADS = 8          # (d) concurrent /query clients, cold programs
FRONT_ACL_REQUESTS = 20         # (e) ACL'd requests after the warm-up
FRONT_SECRET = "chip-smoke-phase-14"
# (e) what the reader may read: persons, their friends and messages'
# authors and dates; likes, tags and forums stay hidden
FRONT_READABLE = ("first_name", "last_name", "city", "birthday_year",
                  "creation_ts", "knows", "has_creator", "reply_of",
                  "works_at", "org_name")
FRONT_HIDDEN = ("likes", "has_tag", "tag_name", "has_member",
                "container_of", "forum_title")
READ_BACK = ("{ q(func: uid(%s)) { uid first_name creation_ts knows { uid } "
             "likes { uid } has_creator { uid } reply_of { uid } "
             "has_tag { uid } works_at { uid } } }")


def http(base: str, path: str, body=None, headers=None,
         ctype: str = "application/dql", timeout: float = 600.0):
    """(status, headers, body bytes) of one request over a real socket;
    an error status is an answer here, not an exception."""
    import urllib.error
    import urllib.request
    data = body.encode() if isinstance(body, str) else body
    req = urllib.request.Request(
        base + path, data=data, method="GET" if data is None else "POST",
        headers={"Content-Type": ctype, **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def data_bytes(body: bytes) -> bytes:
    """The `data` member of a /query answer, as the bytes the server
    spliced in (the emitter's, never re-encoded)."""
    head = b'{"data":'
    if not body.startswith(head):
        raise AssertionError(f"not a query answer: {body[:200]!r}")
    return body[len(head):body.rindex(b',"extensions":')]


def phase_front_end(device, g, handoff: dict,
                    disconnect_after_s: float = FRONT_DISCONNECT_AFTER_S,
                    slow_ic14: int = FRONT_SLOW_IC14,
                    keep: dict | None = None) -> dict:
    """Phase 14: the HTTP front end (server/http.py) over real sockets
    on phase 13's SF1 Alpha, reopened on the card from its directory.
    Given `keep`, a successful phase hands its Alpha, server, directory
    and query sets on to phase 16 (which stops the server and removes
    the directory); otherwise, or on a failure, this phase does."""
    import re
    import socket
    import threading

    from dgraph_tpu_torch.engine import fused
    from dgraph_tpu_torch.models import ldbc
    from dgraph_tpu_torch.ops import bfs
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES
    from dgraph_tpu_torch.server.acl import READ, AclManager, _hash_password
    from dgraph_tpu_torch.server.api import Alpha
    from dgraph_tpu_torch.server.debug_routes import DEBUG_ENDPOINTS
    from dgraph_tpu_torch.server.http import make_http_server, serve_background
    from dgraph_tpu_torch.store.store import Store
    from dgraph_tpu_torch.tools import write_mix
    from dgraph_tpu_torch.utils import costprofile, memgov
    from dgraph_tpu_torch.utils.metrics import METRICS

    on_card = torch.device(device).type == "cuda"
    tmp, p_dir = handoff["tmp"], handoff["p_dir"]
    out: dict = {}
    parts = out["parts_s"] = {}
    t_part = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    def canon(results) -> list:
        return [json.dumps(r, sort_keys=True) for r in results]

    def fail(what, **kv):
        raise AssertionError(f"phase 14 {what}: " + json.dumps(kv,
                                                              default=str))

    a = srv = None
    try:
        a = Alpha.open(p_dir, device=device, device_threshold=LDBC_THRESHOLD)
        srv = make_http_server(a, "127.0.0.1", 0)
        serve_background(srv)
        port = srv.server_address[1]
        base = f"http://127.0.0.1:{port}"
        queries = dict(ldbc.ic_templates(g))
        queries["config3"] = ldbc.config3_query(g)
        rng = np.random.default_rng(LDBC_SEED)
        persons = rng.choice(g.person_uids, MEMCOST_RECURSE, replace=False)
        recurse = ["{ q(func: uid(%s)) @recurse(depth: %d) { uid knows } }"
                   % (hex(int(p)), MEMCOST_RECURSE_DEPTH) for p in persons]
        named = ldbc.ic_batch(g, copies=MEMCOST_BATCH_COPIES)
        work = [q for _n, q in named] + recurse       # phase 13's batch
        groups = [q for n, q in named if n != "IC14"] + recurse
        slow = work + [q for n, q in ldbc.ic_batch(
            g, copies=slow_ic14) if n == "IC14"]

        def post_batch(qs, path="/query/batch", headers=None):
            return http(base, path, json.dumps({"queries": qs}),
                        headers=headers, ctype="application/json")

        part("open")

        # (a) reads: every /query body is the in-process bytes at the
        # same snapshot (no write between); requests alternate, so both
        # p50s see the same warm state
        want = {k: a.query_raw(q) for k, q in queries.items()}
        lat = {"http": [], "in_process": []}
        for _ in range(FRONT_PASSES):
            for k, q in queries.items():
                t0 = time.perf_counter()
                st, _h, body = http(base, "/query", q)
                lat["http"].append((time.perf_counter() - t0) * 1e3)
                if st != 200 or data_bytes(body) != want[k]:
                    fail("(a)", template=k, status=st, body=body[:300])
                t0 = time.perf_counter()
                got = a.query_raw(q)
                lat["in_process"].append((time.perf_counter() - t0) * 1e3)
                if got != want[k]:
                    fail("(a) in process", template=k)
        want_work = canon(a.query_batch(work))
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        t0 = time.perf_counter()
        st, _h, body = post_batch(work)
        batch_s = time.perf_counter() - t0
        out["bucket_hop_launches"] = LAUNCHES["bucket_hop"]
        if st != 200 or canon(json.loads(body)["data"]) != want_work:
            fail("(a) /query/batch", status=st)
        if on_card and not out["bucket_hop_launches"]:
            fail("(a) /query/batch launched no bucket_hop")
        out["a_reads"] = {
            "requests": len(lat["http"]),
            "http_p50_ms": float(np.median(lat["http"])),
            "in_process_p50_ms": float(np.median(lat["in_process"])),
            "http_p99_ms": float(np.percentile(lat["http"], 99)),
            "batch_queries": len(work), "batch_http_s": batch_s,
            "bucket_hop_launches": out["bucket_hop_launches"]}
        part("a_reads")

        # (b) writes over HTTP, each read back over HTTP and in process
        # at the same snapshot
        txns = [tx for tx in write_mix.make_mix(
            g, n=100, seed=write_mix.WRITE_SEED + 3, tag="h").txns
            if not tx.del_nquads][:FRONT_COMMIT_NOW + FRONT_TWO_STEP]
        commit_ms = []

        def read_back(uids, what):
            q = READ_BACK % ", ".join(sorted(uids))
            st, _h, body = http(base, "/query", q)
            if st != 200 or data_bytes(body) != a.query_raw(q):
                fail("(b) read after " + what, status=st, body=body[:300])
            return json.loads(data_bytes(body))

        for i, tx in enumerate(txns):
            two_step = i >= FRONT_COMMIT_NOW
            path = "/mutate" if two_step else "/mutate?commitNow=true"
            t0 = time.perf_counter()
            if tx.set_json is not None:
                st, _h, body = http(base, path, json.dumps(
                    {"set": tx.set_json}), ctype="application/json")
                text = json.dumps(tx.set_json)
            else:
                st, _h, body = http(base, path, tx.set_nquads,
                                    ctype="application/rdf")
                text = tx.set_nquads
            if st != 200:
                fail("(b) /mutate", kind=tx.kind, status=st, body=body)
            doc = json.loads(body)["data"]
            if two_step:
                if doc["txn"]["commit_ts"]:
                    fail("(b) an open txn committed", doc=doc)
                st, _h, body = http(
                    base, f"/commit?startTs={doc['txn']['start_ts']}", "")
                if st != 200 or not json.loads(body)["data"]["commit_ts"]:
                    fail("(b) /commit", status=st, body=body)
            commit_ms.append((time.perf_counter() - t0) * 1e3)
            uids = set(doc["uids"].values()) | set(
                re.findall(r"0x[0-9a-f]+", text))
            got = read_back(uids, tx.kind)
            if not got["q"]:
                fail("(b) the write is not read back", kind=tx.kind)
        st, _h, body = http(base, "/alter", "nickname: string @index(exact) .")
        if st != 200:
            fail("(b) /alter", status=st, body=body)
        nick = hex(int(persons[0]))
        st, _h, body = http(base, "/mutate?commitNow=true",
                            f'<{nick}> <nickname> "front end" .',
                            ctype="application/rdf")
        q_nick = '{ q(func: eq(nickname, "front end")) { uid nickname } }'
        st2, _h, body2 = http(base, "/query", q_nick)
        if st != 200 or st2 != 200 or \
                data_bytes(body2) != a.query_raw(q_nick) or \
                json.loads(data_bytes(body2))["q"] != [
                    {"uid": nick, "nickname": "front end"}]:
            fail("(b) the altered schema", status=(st, st2), body=body2)
        op = write_mix.tag_upserts(g, 1, seed=write_mix.WRITE_SEED + 3)[0]
        st, _h, body = http(base, "/mutate?commitNow=true", op.src,
                            ctype="application/rdf")
        st2, _h, body2 = http(base, "/query", op.check)
        if st != 200 or json.loads(body)["data"]["applied"] != 1 or \
                st2 != 200 or data_bytes(body2) != a.query_raw(op.check) \
                or not write_mix.upsert_took(
                    json.loads(data_bytes(body2)), op):
            fail("(b) the upsert", status=(st, st2), body=body)
        out["b_writes"] = {"commit_now": FRONT_COMMIT_NOW,
                           "mutate_then_commit": FRONT_TWO_STEP,
                           "kinds": sorted({tx.kind for tx in txns}),
                           "write_p50_ms": float(np.median(commit_ms))}
        # fold the writes: the later parts read one stable snapshot
        a.maintenance_rollup()
        part("b_writes")

        # (c) admission: 16 clients at once over (2, 2)
        adm = a.attach_admission(2, 2)
        want_c = canon(a.query_batch(work))

        def sheds():
            return sum(v for k, v in counter_totals(("shed_total",)).items()
                       if 'lane="read"' in k)

        def admission_doc():
            st, _h, body = http(base, "/debug/admission")
            return json.loads(body)["lanes"]["read"]

        shed0, dbg0 = sheds(), admission_doc()["shed_total"]
        answers: list = []
        go = threading.Barrier(FRONT_CLIENTS)

        def client():
            go.wait()
            try:
                answers.append(post_batch(work))
            except Exception as e:  # noqa: BLE001 — failed below
                answers.append((repr(e), {}, b""))

        threads = [threading.Thread(target=client)
                   for _ in range(FRONT_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        burst_s = time.perf_counter() - t0
        codes = [st for st, _h, _b in answers]
        n429 = codes.count(429)
        retry = []
        for st, hdrs, body in answers:
            if st == 200:
                if canon(json.loads(body)["data"]) != want_c:
                    fail("(c) a 200 answer differs")
            elif st == 429:
                retry.append(int(hdrs["Retry-After"]))
                if json.loads(body)["errors"][0]["code"] != \
                        "ServerOverloaded":
                    fail("(c) a 429 body", body=body)
            else:
                fail("(c) status", status=st, body=body[:300])
        shed_metric = sheds() - shed0
        shed_debug = admission_doc()["shed_total"] - dbg0
        if len(answers) != FRONT_CLIENTS or not n429 or \
                n429 != shed_metric or n429 != shed_debug or \
                min(retry) < 1:
            fail("(c) sheds", codes=codes, shed_total=shed_metric,
                 debug_admission=shed_debug, retry_after=retry)
        st, _h, body = post_batch(work, "/query/batch?timeout=5ms")
        err = json.loads(body)["errors"][0]
        if st != 504 or err["code"] != "DeadlineExceeded" or \
                not err["stage"]:
            fail("(c) ?timeout=5ms", status=st, body=body)
        # a client that hangs up mid-batch: its request is cancelled at
        # the next checkpoint and everything it held is released
        c0 = METRICS.get("request_cancelled_total", stage="disconnect")
        lane = adm.lanes["read"]
        payload = json.dumps({"queries": slow}).encode()
        sock = socket.create_connection(("127.0.0.1", port), timeout=60)
        sock.sendall(b"POST /query/batch HTTP/1.1\r\nHost: smoke\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: %d\r\n\r\n" % len(payload) + payload)
        t_admit = time.perf_counter() + 30
        while lane.status()["inflight"] < 1 and \
                time.perf_counter() < t_admit:
            time.sleep(0.001)
        time.sleep(disconnect_after_s)
        t_close = time.perf_counter()
        sock.close()
        while time.perf_counter() < t_close + 30 and (
                lane.status()["inflight"] or METRICS.get(
                    "request_cancelled_total", stage="disconnect") == c0):
            time.sleep(0.001)
        freed_s = time.perf_counter() - t_close
        cancelled = METRICS.get("request_cancelled_total",
                                stage="disconnect") - c0
        rec = [r for r in costprofile.recent(8)
               if r.get("outcome") == "cancelled"]
        locked = [k for k, p in fused._programs.items() if p.lock.locked()]
        if cancelled != 1 or lane.status()["inflight"] or freed_s > 1.0 \
                or not rec or locked or a._active_reads:
            fail("(c) disconnect", cancelled=cancelled, freed_s=freed_s,
                 lane=lane.status(), cost_records=len(rec),
                 locked_programs=len(locked), reads=a._active_reads)
        st, _h, body = post_batch(work)
        if st != 200 or canon(json.loads(body)["data"]) != want_c:
            fail("(c) the batch after the disconnect", status=st)
        out["c_admission"] = {
            "codes": {str(c): codes.count(c) for c in sorted(set(codes))},
            "shed_total": shed_metric, "debug_admission_shed": shed_debug,
            "retry_after_s": sorted(set(retry)), "burst_s": burst_s,
            "timeout_stage": err["stage"], "disconnect_freed_s": freed_s,
            "disconnect_cancelled": cancelled}
        a.admission = None
        part("c_admission")

        # (d) cold programs under 8 concurrent clients: every capture on
        # the card overlaps other request threads' work
        want_d = {k: a.query_raw(q) for k, q in queries.items()}
        fused.reset(counters=False)
        st0 = fused.status()
        keys = sorted(queries)
        errors: list = []

        def cold(t):
            try:
                for j in range(len(keys)):
                    k = keys[(t * 2 + j) % len(keys)]
                    st, _h, body = http(base, "/query", queries[k])
                    if st != 200 or data_bytes(body) != want_d[k]:
                        errors.append((k, st, body[:300]))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=cold, args=(t,))
                   for t in range(FRONT_COLD_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        st1 = fused.status()
        captures = st1["captures"] - st0["captures"]
        if errors or st1["fallbacks"] != st0["fallbacks"] or \
                st1["routes"]["fallback"] != st0["routes"]["fallback"] or \
                (on_card and not captures):
            fail("(d)", errors=errors[:3], before=st0, after=st1)
        out["d_cold"] = {"threads": FRONT_COLD_THREADS,
                         "requests": FRONT_COLD_THREADS * len(keys),
                         "captures": captures, "programs": st1["programs"],
                         "fallbacks": st1["fallbacks"] - st0["fallbacks"],
                         "seconds": time.perf_counter() - t0}
        part("d_cold")

        # (e) ACL: a reader of some predicates, through the ACL view that
        # reads the snapshot's caches
        a.acl = AclManager(a, FRONT_SECRET)
        a.acl.ensure_groot()
        rules = ["_:g <dgraph.xid> \"readers\" .",
                 "_:u <dgraph.xid> \"reader\" .",
                 f"_:u <dgraph.password> \"{_hash_password('r-pass')}\" .",
                 "_:u <dgraph.user.group> _:g ."]
        for i, p in enumerate(FRONT_READABLE):
            rules += [f"_:r{i} <dgraph.rule.predicate> \"{p}\" .",
                      f"_:r{i} <dgraph.rule.permission> \"{READ}\""
                      f"^^<xs:int> .", f"_:g <dgraph.acl.rule> _:r{i} ."]
        a.mutate(set_nquads="\n".join(rules))
        a.maintenance_rollup()

        def login(user, pw):
            st, _h, body = http(base, "/login", json.dumps(
                {"userid": user, "password": pw}), ctype="application/json")
            if st != 200:
                fail("(e) /login", user=user, status=st, body=body)
            return {"X-Dgraph-AccessToken":
                    json.loads(body)["data"]["accessJWT"]}

        reader, groot = login("reader", "r-pass"), login("groot", "password")
        st, _h, body = http(base, "/query", queries["IC2"])
        if st != 401:
            fail("(e) a request without a token", status=st)
        want_q = {k: a.query_raw(q, acl_user="reader")
                  for k, q in queries.items()}
        want_b = canon(a.query_batch(groups, acl_user="reader"))

        def acl_request(i):
            if i % 2:
                k = keys[(i // 2) % len(keys)]
                st, _h, body = http(base, "/query", queries[k],
                                    headers=reader)
                if st != 200 or data_bytes(body) != want_q[k]:
                    fail("(e) /query", template=k, status=st)
                text = data_bytes(body).decode()
            else:
                st, _h, body = post_batch(groups, headers=reader)
                if st != 200 or canon(json.loads(body)["data"]) != want_b:
                    fail("(e) /query/batch", status=st)
                text = body.decode()
            hidden = [p for p in FRONT_HIDDEN if f'"{p}"' in text]
            if hidden:
                fail("(e) hidden predicates answered", hidden=hidden)

        # the first request of each kind: one batch, one pass of the mix
        acl_request(0)
        for i in range(len(keys)):
            acl_request(2 * i + 1)
        built, placed = [], []
        real_build, real_placed = bfs.build_ell, Store._note_placed

        def counting_build(*x, **k):
            built.append(1)
            return real_build(*x, **k)

        def counting_placed(self, *x, **k):
            placed.append(1)
            return real_placed(self, *x, **k)

        gc.collect()
        alloc0 = torch.cuda.memory_allocated() if on_card else 0
        captures0 = fused.status()["captures"]
        allocs = []
        bfs.build_ell, Store._note_placed = counting_build, counting_placed
        try:
            for i in range(FRONT_ACL_REQUESTS):
                acl_request(i)
                if on_card:
                    allocs.append(torch.cuda.memory_allocated())
        finally:
            bfs.build_ell, Store._note_placed = real_build, real_placed
        captured = fused.status()["captures"] - captures0
        if built or placed or captured or (allocs and max(allocs) > alloc0):
            fail("(e) the ACL view built or placed", ell_builds=len(built),
                 placements=len(placed), captures=captured,
                 allocated_after_first=alloc0,
                 max_allocated=max(allocs) if allocs else 0)
        st, _h, body = http(base, "/mutate?commitNow=true",
                            f'<{nick}> <first_name> "renamed" .',
                            headers=reader, ctype="application/rdf")
        if st != 401 or json.loads(body)["errors"][0]["code"] != \
                "Unauthorized":
            fail("(e) a refused write", status=st, body=body)
        out["e_acl"] = {"requests": FRONT_ACL_REQUESTS,
                        "readable": len(FRONT_READABLE),
                        "ell_builds": len(built), "placements": len(placed),
                        "captures": captured,
                        "allocated_after_first": alloc0,
                        "max_allocated": max(allocs) if allocs else 0,
                        "refused_write": st}
        part("e_acl")

        # (f) the debug surfaces
        a.attach_admission(64, 64)
        for path in DEBUG_ENDPOINTS:
            st, _h, body = http(base, path)
            if st != 200 or not body:
                fail("(f) a debug row", path=path, status=st)
        st, _h, body = http(base, "/debug/memory")
        if json.loads(body) != json.loads(json.dumps(
                memgov.GOVERNOR.status())):
            fail("(f) /debug/memory is not GOVERNOR.status()")
        st, _h, body = http(base, "/debug/scheduler?n=1000")
        doc = json.loads(body)
        shapes = [t["shape"] for t in doc["top"]]
        if set(doc.get("admission", {}).get("lanes", {})) != \
                {"read", "mutate"} or not any(
                    f"recurse:knows~d{MEMCOST_RECURSE_DEPTH}" in s
                    for s in shapes):
            fail("(f) /debug/scheduler", shapes=shapes[:20],
                 admission=doc.get("admission"))
        prof_dir = os.path.join(tmp, "front-end-profile")
        start = json.dumps({"action": "start", "dir": prof_dir})
        st, _h, _b = http(base, "/debug/profile", start, headers=groot,
                          ctype="application/json")
        st2, _h, _b = http(base, "/debug/profile", start, headers=groot,
                           ctype="application/json")
        st3, _h, body = post_batch(work, headers=groot)
        st4, _h, _b = http(base, "/debug/profile",
                           json.dumps({"action": "stop"}), headers=groot,
                           ctype="application/json")
        import glob
        files = glob.glob(os.path.join(prof_dir, "trace-*.json"))
        kernels = []
        if files:
            with open(files[0]) as f:
                kernels = [e for e in json.load(f)["traceEvents"]
                           if e.get("cat") == "kernel"
                           and "bucket_hop" in e.get("name", "")]
        if (st, st2, st3, st4) != (200, 409, 200, 200) or not files or \
                (on_card and not kernels):
            fail("(f) /debug/profile", statuses=(st, st2, st3, st4),
                 files=files, bucket_hop_events=len(kernels))
        out["f_debug"] = {"rows": len(DEBUG_ENDPOINTS),
                          "scheduler_shapes": len(shapes),
                          "profile_bucket_hop_events": len(kernels)}
        part("f_debug")
        if keep is not None:
            keep.update(alpha=a, server=srv, base=base, tmp=tmp,
                        p_dir=p_dir, queries=queries, work=work,
                        recurse=recurse, groot=groot)
    except BaseException:
        say("phase 14 front end (stopped)", **out)
        keep = None             # a failed phase hands nothing on
        raise
    finally:
        if keep is None:
            close_front_end(a, srv, tmp)
    return out


def close_front_end(a, srv, tmp) -> None:
    """Stop phase 14's server, close its Alpha's WAL and remove its
    directory."""
    import shutil
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if a is not None and a.wal is not None:
        a.wal.close()
    shutil.rmtree(tmp, ignore_errors=True)


# -- phase 16: the flight recorder, the metrics history and the sanitizers ----

OBS_PAIRS = 5                   # (a) interleaved disarmed/armed IC-mix passes
OBS_TS_INTERVAL_S = 0.25        # (a) the sampler's cadence
OBS_RING = 1 << 16              # (a) flight-ring events kept
OBS_PUSH_INTERVAL_S = 0.2       # (a) the telemetry pusher's cadence
OBS_STALL_FACTOR = 2.0          # (b) conviction at 2 x the prediction
OBS_STALL_FLOOR_MS = 50.0       # (b) ... and no sooner than 50 ms
OBS_TINY_PRIOR_US = 400.0       # (b) the IC14 instance's taught prior
OBS_BUSY_CLIENTS = 3            # (b) /query/batch clients beside IC14, the
OBS_BUSY_STAGGER_S = 0.1        # first 0.05 s before it, each next this much
                                # later; one more loops phase 13's recurse
                                # group (a short host rebuild) from IC14's
                                # conviction on
OBS_BURST_CLIENTS = 16          # (c) clients looping /query/batch over (2, 2)
OBS_BURST_S = 4.0               # (c) how long they loop
OBS_CHILD_THREADS = 8           # (e) concurrent /query clients, cold programs
OBS_CHILD_WRITES = 4            # (e) writes beside them
OBS_CHILD_TIMEOUT_S = 300       # (e) the child's time limit

# (e) the child: the port with both sanitizers on from its first import
SANITIZER_CHILD = r"""
import json, sys, threading, time, urllib.request
spec = json.load(open(sys.argv[1]))
from dgraph_tpu_torch.engine import fused
from dgraph_tpu_torch.server.api import Alpha
from dgraph_tpu_torch.server.http import make_http_server, serve_background
from dgraph_tpu_torch.utils import locks
t0 = time.perf_counter()
a = Alpha.open(spec["p_dir"], device=spec["device"],
               device_threshold=spec["threshold"])
srv = make_http_server(a, "127.0.0.1", 0)
serve_background(srv)
base = "http://127.0.0.1:%d" % srv.server_address[1]
boot_s = time.perf_counter() - t0

def post(path, body, ctype="application/dql"):
    req = urllib.request.Request(base + path, data=body.encode(),
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.read()

queries = spec["queries"]
keys = sorted(queries)
want = {k: a.query_raw(q) for k, q in queries.items()}
fused.reset(counters=False)          # every program cold again
st0 = fused.status()
errors = []

def reader(t):
    try:
        for j in range(len(keys)):
            k = keys[(t * 2 + j) % len(keys)]
            st, body = post("/query", queries[k])
            head = b'{"data":'
            got = body[len(head):body.rindex(b',"extensions":')]
            if st != 200 or got != want[k]:
                errors.append(("read", k, st))
    except Exception as e:
        errors.append(repr(e))

def writer():
    try:
        for w in spec["writes"]:
            st, body = post("/mutate?commitNow=true", w, "application/rdf")
            if st != 200 or not json.loads(body)["data"]["txn"]["commit_ts"]:
                errors.append(("write", st, body[:200].decode()))
    except Exception as e:
        errors.append(repr(e))

threads = [threading.Thread(target=reader, args=(t,))
           for t in range(spec["threads"])]
threads.append(threading.Thread(target=writer))
t1 = time.perf_counter()
for t in threads:
    t.start()
for t in threads:
    t.join(600)
serve_s = time.perf_counter() - t1
for k, q in queries.items():
    if a.query_raw(q) != want[k]:
        errors.append(("after", k))
st1 = fused.status()
srv.shutdown()
if a.wal is not None:
    a.wal.close()
snap = locks.GRAPH.snapshot()
races = locks.RACES.snapshot()
names = sorted({e["from"] for e in snap["edges"]}
               | {e["to"] for e in snap["edges"]})
doc = {"lock_sanitizer": locks.enabled(),
       "race_sanitizer": locks.race_enabled(),
       "boot_s": boot_s, "serve_s": serve_s, "errors": errors[:5],
       "captures": st1["captures"] - st0["captures"],
       "fallbacks": st1["fallbacks"] - st0["fallbacks"],
       "acquires": snap["acquires_total"], "edges": len(snap["edges"]),
       "locks_in_edges": names, "cycles": snap["cycles"],
       "long_holds": snap["long_holds"],
       "races_total": races["races_total"], "races": races["reports"],
       "tracked_classes": races["tracked_classes"]}
print(json.dumps(doc, default=str), flush=True)
sys.exit(0 if not errors and not snap["cycles"]
         and not races["reports"] else 1)
"""


class _Collector:
    """A telemetry collector in this process: counts the spans and cost
    records the pusher POSTs to /v1/traces and /v1/costs."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        self.lock = threading.Lock()
        self.spans = self.costs = self.posts = 0
        col = self

        class H(BaseHTTPRequestHandler):
            def do_POST(self):
                doc = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                with col.lock:
                    col.posts += 1
                    if self.path == "/v1/traces":
                        col.spans += sum(
                            len(ss["spans"]) for rs in doc["resourceSpans"]
                            for ss in rs["scopeSpans"])
                    else:
                        col.costs += len(doc["records"])
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def counts(self) -> dict:
        with self.lock:
            return {"spans": self.spans, "costs": self.costs,
                    "posts": self.posts}

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def phase_observability(device, g, front: dict,
                        burst_s: float = OBS_BURST_S,
                        stall_floor_ms: float = OBS_STALL_FLOOR_MS,
                        keep: dict | None = None) -> dict:
    """Phase 16: the flight recorder, the metrics history with its SLOs
    and forecast shedding, the telemetry pusher and the lock and race
    sanitizers, on phase 14's SF1 Alpha and HTTP server; stops that
    server and removes phase 14's directory at its end. Given `keep`, a
    successful phase hands phase 17 a copy of the directory (made with
    (e)'s), the Alpha's in-process answers over it and a copy of phase
    12 (f)'s sf 0.1 bulk directory."""
    import shutil
    import tempfile
    import threading

    from dgraph_tpu_torch.models import ldbc
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES
    from dgraph_tpu_torch.utils import (costprior, flightrec, memgov, slo,
                                        timeseries, tracing)
    from dgraph_tpu_torch.utils.metrics import METRICS
    from dgraph_tpu_torch.utils.push import TelemetryPusher

    on_card = torch.device(device).type == "cuda"
    a, base, tmp = front["alpha"], front["base"], front["tmp"]
    queries, work = front["queries"], front["work"]
    out: dict = {}
    parts = out["parts_s"] = {}
    t_part = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    def fail(what, **kv):
        raise AssertionError(f"phase 16 {what}: " + json.dumps(kv,
                                                              default=str))

    def canon(results) -> list:
        return [json.dumps(r, sort_keys=True) for r in results]

    def post_batch(qs, path="/query/batch"):
        return http(base, path, json.dumps({"queries": qs}),
                    ctype="application/json")

    def ring(kind):
        return [e for e in flightrec._STATE.ring.recent()
                if e["kind"] == kind]

    diag = os.path.join(tmp, "flight")
    col = pusher = None
    try:
        # the front end's ACL and admission off: this phase's requests
        # carry no token, and (c) attaches its own lanes
        a.acl = None
        a.admission = None
        want = {k: a.query_raw(q) for k, q in queries.items()}
        want_work = canon(a.query_batch(work))

        # (a) armed serving: recorder, sampler with its forecast and
        # SLOs, and a pusher to a collector in this process
        col = _Collector()
        pusher = TelemetryPusher(col.url, interval_s=OBS_PUSH_INTERVAL_S)
        engine = slo.SloEngine({"read_latency_p99_us": 1_000_000.0,
                                "error_rate": 0.01, "shed_rate": 0.05},
                               fast_window_s=30.0, slow_window_s=120.0)

        def arm():
            flightrec.arm(diag_dir=diag, alpha=a, pusher=pusher,
                          capture_device=True, ring_max=OBS_RING)
            timeseries.arm(interval_s=OBS_TS_INTERVAL_S, slo_engine=engine,
                           forecast=True)

        def disarm():
            timeseries.disarm()
            flightrec.disarm()

        def mix_pass() -> list:
            lat = []
            for k, q in queries.items():
                t0 = time.perf_counter()
                st, _h, body = http(base, "/query", q)
                lat.append((time.perf_counter() - t0) * 1e3)
                if st != 200 or data_bytes(body) != want[k]:
                    fail("(a) /query", template=k, status=st,
                         body=body[:300])
            return lat

        pusher.start()
        p50 = {"disarmed": [], "armed": []}
        for _ in range(OBS_PAIRS):
            disarm()
            p50["disarmed"].append(float(np.median(mix_pass())))
            arm()
            p50["armed"].append(float(np.median(mix_pass())))
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        st, _h, body = post_batch(work)
        out["bucket_hop_launches"] = LAUNCHES["bucket_hop"]
        if st != 200 or canon(json.loads(body)["data"]) != want_work:
            fail("(a) /query/batch", status=st)
        if on_card and not out["bucket_hop_launches"]:
            fail("(a) /query/batch launched no bucket_hop")
        time.sleep(2 * OBS_TS_INTERVAL_S)
        end = time.perf_counter() + 10
        while time.perf_counter() < end and not (
                col.counts()["spans"] and col.counts()["costs"]):
            time.sleep(0.05)
        got = col.counts()
        ts_doc = json.loads(http(base, "/debug/timeseries?name="
                                 "query_latency_us")[2])
        slo_doc = json.loads(http(base, "/debug/slo")[2])
        fr_doc = json.loads(http(base, "/debug/flightrecorder")[2])
        if not got["spans"] or not got["costs"] or not ts_doc["armed"] \
                or not ts_doc["series"] or not slo_doc["armed"] or \
                not fr_doc["armed"] or not ring("span") or \
                not ring("cost"):
            fail("(a) telemetry", collector=got, timeseries=ts_doc.get(
                "points"), slo=slo_doc.get("armed"),
                 ring=fr_doc.get("ring_stats"))
        ratio = [x / y for x, y in zip(p50["armed"], p50["disarmed"])]
        out["a_armed"] = {
            "pairs": OBS_PAIRS, "requests_per_pass": len(queries),
            "ic_mix_p50_ms": p50, "armed_over_disarmed": ratio,
            "armed_over_disarmed_median": float(np.median(ratio)),
            "batch_queries": len(work),
            "bucket_hop_launches": out["bucket_hop_launches"],
            "collector": got, "pusher": pusher.status(),
            "ts_points": timeseries.state().ring.points_total,
            "slo_states": {n: {w: s["windows"][w]["burn"]
                               for w in s["windows"]}
                           for n, s in slo_doc["states"].items()},
            "dumps_while_serving": len(flightrec.dumps())}
        part("a_armed")

        # (b) conviction: an IC14 instance taught a tiny prior, served
        # while OBS_BUSY_CLIENTS clients loop /query/batch back to back,
        # staggered so one's host rebuild falls where another launches,
        # and from its conviction on one more loops the recurse group,
        # whose rebuild is short: lane-kernel launches stay on the card
        # through the capture. The expected answers are served before the
        # recorder is armed, so none of them is the convicted request.
        flightrec.disarm()
        ic14 = next(q for n, q in ldbc.ic_batch(g, copies=2, seed=16)
                    if n == "IC14")
        want_14 = a.query_raw(ic14)
        want_busy = [want_work] * OBS_BUSY_CLIENTS + [
            canon(a.query_batch(front["recurse"]))]
        prof = os.path.join(tmp, "flight-profile")
        tracing.enable_device_trace(prof)
        flightrec.arm(diag_dir=diag, alpha=a, pusher=pusher,
                      capture_device=True, ring_max=OBS_RING, poll_s=0.02,
                      stall_factor=OBS_STALL_FACTOR,
                      stall_floor_ms=stall_floor_ms,
                      min_dump_interval_s=600.0)
        for _ in range(costprior.SAMPLE_FLOOR):
            costprior.learn("read", ic14, "chip-smoke-stall",
                            actual_us=OBS_TINY_PRIOR_US)
        stop = threading.Event()
        batch_answers = []
        # where the batch's bucket_hop launches fall against the capture
        # window: the bundle's capture calls are timed, the launch count
        # read every 2 ms
        marks: dict = {}
        capture_calls = (tracing.profile_start, tracing.profile_stop)

        def timed(name, fn):
            def call(*args, **kw):
                marks[name] = time.perf_counter()
                return fn(*args, **kw)
            return call

        tracing.profile_start = timed("capture_start", capture_calls[0])
        tracing.profile_stop = timed("capture_stop", capture_calls[1])
        hops: list = []

        busy_work = [work] * OBS_BUSY_CLIENTS + [front["recurse"]]

        def convicted() -> bool:
            return flightrec.state(1)["watchdog"].get("convictions", 0) > 0

        def busy(i):
            if i < OBS_BUSY_CLIENTS:
                time.sleep(i * OBS_BUSY_STAGGER_S)
            else:
                # the recurse group's prior is small: it starts once IC14
                # is convicted, and later convictions are not dumped
                while not stop.is_set() and not convicted():
                    time.sleep(0.005)
            while not stop.is_set():
                batch_answers.append((i, post_batch(busy_work[i])))

        def watch():
            last = LAUNCHES["bucket_hop"]
            while not stop.is_set():
                n = LAUNCHES["bucket_hop"]
                if n != last:
                    hops.append((time.perf_counter(), n - last))
                    last = n
                time.sleep(0.002)

        def hop_timeline() -> dict:
            rel = [(t - t_post, k) for t, k in hops]
            times = [t for t, _k in rel]
            w = [marks[m] - t_post for m in ("capture_start", "capture_stop")
                 if m in marks]
            inside = [t for t in times if len(w) == 2 and w[0] <= t <= w[1]]
            edges = w[:1] + inside + w[1:] if len(w) == 2 else []
            return {
                "ic14_sent_s": t0 - t_post,
                "capture_s": w,
                "launches_in_capture": sum(
                    k for t, k in rel if len(w) == 2 and w[0] <= t <= w[1]),
                # the longest stretch of the capture with no launch issued
                # (the counter is read every 2 ms)
                "longest_launch_free_in_capture_s": max(
                    (b - a for a, b in zip(edges, edges[1:])), default=None),
                "launches": sum(k for _t, k in rel),
                "first_last_launch_s": times[:1] + times[-1:],
                "gaps_over_250ms_s": [[a, b] for a, b in zip(times, times[1:])
                                      if b - a > 0.25][:8]}

        t_watch = threading.Thread(target=watch, name="phase16-hops")
        t_busy = [threading.Thread(target=busy, args=(i,),
                                   name=f"phase16-batch-{i}")
                  for i in range(len(busy_work))]
        t_post = time.perf_counter()
        t_watch.start()
        for t in t_busy:
            t.start()
        time.sleep(0.05)
        t0 = time.perf_counter()
        st, _h, body = http(base, "/query", ic14)
        ic14_ms = (time.perf_counter() - t0) * 1e3
        end = time.perf_counter() + 30
        while time.perf_counter() < end and not flightrec.dumps():
            time.sleep(0.02)
        stop.set()
        for t in t_busy:
            t.join(600)
        t_watch.join(60)
        tracing.profile_start, tracing.profile_stop = capture_calls
        time.sleep(0.2)             # a later conviction would dump here
        dumps = flightrec.dumps()
        if st != 200 or data_bytes(body) != want_14:
            fail("(b) the convicted request's answer", status=st)
        for i, (st2, _h2, b2) in batch_answers:
            if st2 != 200 or canon(json.loads(b2)["data"]) != want_busy[i]:
                fail("(b) a /query/batch beside the conviction", status=st2,
                     client=i)
        if len(dumps) != 1 or not dumps[0]["path"]:
            fail("(b) dumps", dumps=dumps)
        with open(dumps[0]["path"]) as f:
            bundle = json.load(f)
        reason = bundle["reason"]
        op = reason.get("op", {})
        prof_doc = bundle.get("device_profile", {})
        kernels = prof_doc.get("kernels", [])
        mem = bundle["surfaces"]["memory"]
        if reason["kind"] != "request" or \
                " ".join(ic14.split())[:200] != op.get("query") or \
                "query_raw" not in op.get("stack", "") or \
                mem["budgets"]["device"]["resident_bytes"] <= 0 or \
                "timeseries.ring" not in mem["caches"]:
            fail("(b) the bundle", reason={k: v for k, v in reason.items()
                                           if k != "op"},
                 query=op.get("query"), stack=op.get("stack", "")[-500:],
                 memory=mem["budgets"])
        busy_card = "error" in prof_doc
        if on_card and not busy_card and \
                not any("bucket_hop" in k for k in kernels):
            fail("(b) the device profile names no bucket_hop",
                 profile=prof_doc, hop_timeline=hop_timeline())
        out["b_conviction"] = {
            "dumps": len(dumps), "kind": reason["kind"],
            "threshold_us": reason.get("threshold_us"),
            "convicted_elapsed_us": op.get("elapsed_us"),
            "ic14_ms": ic14_ms, "batches_beside": len(batch_answers),
            "bundle_bytes": os.path.getsize(dumps[0]["path"]),
            "device_profile": {"busy": busy_card,
                               "error": prof_doc.get("error"),
                               "kernels": len(kernels),
                               "bucket_hop": [k for k in kernels
                                              if "bucket_hop" in k]},
            "hop_timeline": hop_timeline(),
            "governor_device_bytes":
                mem["budgets"]["device"]["resident_bytes"]}
        tracing.enable_device_trace(None)
        # the taught prior goes: (c) predicts from what was learned
        costprior.reset()
        costprior.refit()
        part("b_conviction")

        # (c) forecast shedding: a burst on the read lane over (2, 2)
        flightrec.disarm()
        flightrec.arm(diag_dir=diag, alpha=a, pusher=pusher,
                      ring_max=OBS_RING, watchdog=False)
        a.attach_admission(2, 2)
        f0 = METRICS.get("forecast_sheds_total", lane="read")
        answers = []
        t_end = time.perf_counter() + burst_s

        def client():
            while time.perf_counter() < t_end:
                answers.append(post_batch(work))

        threads = [threading.Thread(target=client)
                   for _ in range(OBS_BURST_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        fsheds = METRICS.get("forecast_sheds_total", lane="read") - f0
        codes = [st for st, _h, _b in answers]
        for st, _h, b2 in answers:
            if st == 200 and canon(json.loads(b2)["data"]) != want_work:
                fail("(c) a 200 answer differs")
            if st not in (200, 429):
                fail("(c) status", status=st, body=b2[:300])
        events = [e for e in ring("admission.shed")
                  if e.get("reason") == "forecast"]
        if not fsheds or len(events) != fsheds:
            fail("(c) forecast sheds", forecast_sheds=fsheds,
                 ring_events=len(events), codes=codes[:50],
                 forecast=timeseries._FORECAST.status())
        out["c_forecast"] = {
            "clients": OBS_BURST_CLIENTS, "burst_s": burst_s,
            "requests": len(answers),
            "codes": {str(c): codes.count(c) for c in sorted(set(codes))},
            "forecast_sheds": fsheds, "ring_events": len(events),
            "shed_reasons": {r: sum(1 for e in ring("admission.shed")
                                    if e.get("reason") == r)
                             for r in sorted({e.get("reason") for e in
                                              ring("admission.shed")})},
            "forecast": timeseries._FORECAST.status()}
        a.admission = None
        timeseries.disarm()
        part("c_forecast")

        # (d) memory events: one absorbed allocation failure at the
        # recurse group's launch, one degrading at a whole-block program
        GOV = memgov.GOVERNOR
        recurse = front["recurse"]
        want_r = canon(a.query_batch(recurse))
        from dgraph_tpu_torch.engine import fused

        def fused_routes(q):
            r0 = fused.status()["routes"]
            a.query_raw(q)
            return {k: v - r0[k] for k, v in fused.status()["routes"].items()}

        # a query of one block, served by its whole-block program
        fused_q = next(q for q in queries.values() if fused_routes(q) ==
                       {"fused": 1, "staged": 0, "fallback": 0})
        want_f = a.query_raw(fused_q)
        e0 = GOV.oom_stats()
        armed = [True]

        def once(site):
            if armed[0] and site == "bfs.ell_recurse":
                armed[0] = False
                return True
            return False

        memgov.set_alloc_fault(once)
        try:
            st, _h, body = post_batch(recurse)
        finally:
            memgov.set_alloc_fault(None)
        if armed[0] or st != 200 or canon(json.loads(body)["data"]) != \
                want_r or len(ring("memory.oom")) != 1:
            fail("(d) the absorbed failure", fired=not armed[0], status=st,
                 oom=ring("memory.oom"))
        memgov.set_alloc_fault(lambda site: site == "fused.program")
        try:
            st, _h, body = http(base, "/query", fused_q)
        finally:
            memgov.set_alloc_fault(None)
        e1 = GOV.oom_stats()
        deg = ring("memory.degrade")
        st_m, _h, body_m = http(base, "/debug/memory")
        if st != 200 or data_bytes(body) != want_f or len(deg) != 1 or \
                deg[0]["site"] != "fused.program" or \
                e1["events"] != e0["events"] + 2 or \
                "timeseries.ring" not in json.loads(body_m)["caches"]:
            fail("(d) the degraded program", status=st, degrade=deg,
                 oom=(e0, e1), memory_status=st_m)
        out["d_memory"] = {"oom_events": e1["events"] - e0["events"],
                           "memory_oom": ring("memory.oom"),
                           "memory_degrade": deg,
                           "governed": sorted(json.loads(body_m)["caches"])}
        GOV.reset()
        part("d_memory")
        flightrec.disarm()

        # (e) both sanitizers in a child process started with them on,
        # over a copy of this Alpha's directory
        a.checkpoint_to(front["p_dir"])
        child_dir = os.path.join(tmp, "sanitized")
        shutil.copytree(front["p_dir"], child_dir)
        if keep is not None:
            cli_tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
            keep.update(tmp=cli_tmp, p_dir=os.path.join(cli_tmp, "p"),
                        small=os.path.join(cli_tmp, "small"),
                        queries=queries, work=work,
                        want={k: a.query_raw(q) for k, q in queries.items()},
                        want_work=canon(a.query_batch(work)))
            shutil.copytree(front["p_dir"], keep["p_dir"])
            # phase 12 (f)'s bulk-loaded sf 0.1 directory
            shutil.copytree(os.path.join(tmp, "bulk"), keep["small"])
        uids = [hex(int(u)) for u in g.person_uids[:OBS_CHILD_WRITES]]
        spec = {"p_dir": child_dir, "device": device,
                "threshold": LDBC_THRESHOLD, "queries": queries,
                "threads": OBS_CHILD_THREADS,
                "writes": [f'<{u}> <nickname> "sanitized {i}" .'
                           for i, u in enumerate(uids)]}
        spec_path = os.path.join(tmp, "sanitized.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ, DGRAPH_TPU_LOCK_SANITIZER="1",
                   DGRAPH_TPU_RACE_SANITIZER="1")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", SANITIZER_CHILD, spec_path], env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=OBS_CHILD_TIMEOUT_S)
        child_s = time.perf_counter() - t0
        try:
            doc = json.loads(proc.stdout.strip().splitlines()[-1])
        except (IndexError, ValueError):
            doc = None
        if proc.returncode != 0 or doc is None:
            fail("(e) the sanitized child", rc=proc.returncode,
                 stdout=proc.stdout[-2000:], stderr=proc.stderr[-3000:])
        if not doc["lock_sanitizer"] or not doc["race_sanitizer"] or \
                doc["cycles"] or doc["races"] or doc["errors"] or \
                doc["fallbacks"] or (on_card and not doc["captures"]):
            fail("(e) the sanitized child", doc=doc)
        out["e_sanitizers"] = {
            "child_s": child_s, "boot_s": doc["boot_s"],
            "serve_s": doc["serve_s"], "threads": OBS_CHILD_THREADS,
            "writes": OBS_CHILD_WRITES, "captures": doc["captures"],
            "acquires": doc["acquires"], "edges": doc["edges"],
            "locks_in_edges": doc["locks_in_edges"],
            "cycles": len(doc["cycles"]), "races": len(doc["races"]),
            "long_holds": doc["long_holds"],
            "tracked_classes": len(doc["tracked_classes"])}
        part("e_sanitizers")
    except BaseException:
        say("phase 16 observability (stopped)", **out)
        if keep:
            shutil.rmtree(keep.pop("tmp"), ignore_errors=True)
            keep.clear()
        raise
    finally:
        timeseries.disarm()
        flightrec.disarm()
        slo.uninstall()
        tracing.enable_device_trace(None)
        memgov.set_alloc_fault(None)
        if pusher is not None:
            pusher.stop(flush=False)
        if col is not None:
            col.close()
        close_front_end(a, front["server"], tmp)
    return out


# -- phase 15: the cluster on the card -----------------------------------------

# SF1 split by predicate over two groups of three replicas: the person
# side and the content side
CLUSTER_GROUPS = (("first_name", "last_name", "city", "birthday_year",
                   "knows", "works_at", "org_name"),
                  ("creation_ts", "has_creator", "reply_of", "has_tag",
                   "tag_name", "has_member", "container_of", "forum_title",
                   "likes", "dgraph.type"))
CLUSTER_REPLICAS = 3
CLUSTER_PASSES = 3              # (b) IC-mix passes from each coordinator
CLUSTER_BATCH_COPIES = 4        # (b) phase 13's batch: ic_batch copies
CLUSTER_WRITE_SEED = 21         # (c) write_mix seed (tag "c")
CLUSTER_TXNS = 25               # (c) replicated transactions
CLUSTER_CROSS = 5               # (c) of them writing both groups at once
CLUSTER_DOWN_COMMITS = 10       # (d) commits while a replica is down
CLUSTER_MOVE_READERS = 4        # (e) reader threads during the move
CLUSTER_MOVE = "likes"          # (e) the tablet moved to the person side
# (c) the read-back of a group's predicates on a subject set
CLUSTER_READ = ("{ q(func: uid(%s)) { uid first_name last_name city "
                "birthday_year org_name knows { uid } works_at { uid } } }",
                "{ q(func: uid(%s)) { uid creation_ts tag_name forum_title "
                "has_creator { uid } reply_of { uid } has_tag { uid } "
                "has_member { uid } container_of { uid } likes { uid } } }")
CLUSTER_LIKES_Q = '{ q(func: eq(city, "%s")) { uid likes { uid } } }'
CLUSTER_STALL_S = 3.0           # (g) the wedged leg to the content side
CLUSTER_STALL_FLOOR_MS = 1000.0  # (g) conviction no sooner than this


def _cluster_txn_groups(tx) -> set:
    """The groups (0 person side, 1 content side) a write_mix txn
    touches."""
    text = json.dumps(tx.set_json) if tx.set_json is not None else \
        (tx.set_nquads or "") + (tx.del_nquads or "")
    return {i for i, preds in enumerate(CLUSTER_GROUPS)
            if any(f"<{p}>" in text or f'"{p}"' in text for p in preds)}


def _mirrored(parts, uids: dict) -> list:
    """The mutate() arguments of a committed txn's parts with its blank
    nodes written as the uids the cluster gave them, for the single-node
    mirror."""
    import copy
    import re
    out = []
    for kw in parts:
        kw = copy.deepcopy(kw)
        for key in ("set_nquads", "del_nquads"):
            if key in kw:
                kw[key] = re.sub(r"_:\w+", lambda m: f"<{uids[m.group(0)]}>",
                                 kw[key])
        if "set_json" in kw:
            blank = [u for b, u in uids.items() if b.startswith("_:json.")]
            kw["set_json"] = dict(kw["set_json"], uid=blank[0])
        out.append(kw)
    return out


def phase_cluster(device, g, single_commit_p50_ms=None) -> dict:
    """Phase 15: SF1 split by predicate over two groups of three port
    Alphas and one Zero, in this process over loopback gRPC, on the
    card: boot, routed reads and the lane batch against a single-node
    Alpha over the whole SF1 (the reference), replicated writes mirrored
    into it, a replica down and restarted from its WAL, a minority
    partition, a tablet move under reads and the front end's cluster
    documents. Works in a temporary directory, which it removes."""
    import copy
    import re
    import shutil
    import tempfile
    import threading

    from dgraph_tpu_torch import cli
    from dgraph_tpu_torch.cluster import start_cluster_alpha
    from dgraph_tpu_torch.cluster.fault import FaultyGroups
    from dgraph_tpu_torch.cluster.zero import (ZeroClient, ZeroState,
                                               make_zero_server)
    from dgraph_tpu_torch.models import ldbc
    from dgraph_tpu_torch.ops import bfs
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES
    from dgraph_tpu_torch.server.api import (Alpha, NoQuorum,
                                             ReadUnavailable, TxnAborted)
    from dgraph_tpu_torch.server.http import make_http_server, serve_background
    from dgraph_tpu_torch.store.store import Store, StoreBuilder
    from dgraph_tpu_torch.tools import write_mix
    from dgraph_tpu_torch.utils import logging as xlog
    from dgraph_tpu_torch.utils import memgov

    on_card = torch.device(device).type == "cuda"
    out: dict = {}
    parts = out["parts_s"] = {}
    t_part = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    def fail(what, **kv):
        raise AssertionError(f"phase 15 {what}: " + json.dumps(kv,
                                                              default=str))

    def count(name) -> float:
        return sum(counter_totals((name,)).values())

    def canon(results) -> list:
        return [json.dumps(r, sort_keys=True) for r in results]

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    servers, nodes, https = [], [], []
    zs = None
    beat = threading.Event()
    beaters = []
    hb_log = xlog.get("chip_smoke.cluster")

    def liveness_step(i):
        """Node slot i's liveness heartbeat to Zero, as the CLI's alpha
        sends it (Zero moves tablets only to nodes its liveness sweep
        holds alive); a slot whose node is down sends none."""
        def step():
            n = nodes[i]
            if n.get("down"):
                return
            a = n["alpha"]
            ts = max(a.mvcc.base_ts, max(
                (lay.commit_ts for lay in a.mvcc.layers), default=0))
            a.groups.zero.heartbeat(a.groups.node_id, group=a.groups.gid,
                                    max_ts=ts, max_uid=a.mvcc.uid_high())
        return step

    try:
        # (a) boot: one immutable base per group (its tablets over the
        # whole uid vocabulary, the rank space being shared), shared by
        # its three replicas; every node arms a WAL
        t0 = time.perf_counter()
        b = StoreBuilder()
        ldbc.load_into(b, g)
        full = b.finalize()
        single = Alpha(base=full, device=device,
                       device_threshold=LDBC_THRESHOLD)
        bases = [Store(full.uids, full.schema,
                       {p: full.preds[p] for p in preds if p in full.preds})
                 for preds in CLUSTER_GROUPS]
        out["build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        zs, zport, _zstate = make_zero_server(
            ZeroState(replicas=CLUSTER_REPLICAS))
        zs.start()
        zt = f"127.0.0.1:{zport}"

        def boot(k, i, addr="127.0.0.1:0"):
            d = os.path.join(tmp, f"g{k}n{i}")
            os.makedirs(d, exist_ok=True)
            a, s, bound = start_cluster_alpha(
                zt, base=bases[k], device_threshold=LDBC_THRESHOLD,
                wal_dir=d, addr=addr, device=device)
            return {"alpha": a, "server": s, "addr": bound, "dir": d}

        for k in range(2):
            for i in range(CLUSTER_REPLICAS):
                n = boot(k, i)
                servers.append(n["server"])
                nodes.append(n)
        group = [[n for n in nodes[k * CLUSTER_REPLICAS:
                                   (k + 1) * CLUSTER_REPLICAS]]
                 for k in range(2)]
        gids = [grp[0]["alpha"].groups.gid for grp in group]
        if len(set(gids)) != 2 or any(
                n["alpha"].groups.gid != gids[k]
                for k in range(2) for n in group[k]):
            fail("(a) groups", gids=[n["alpha"].groups.gid for n in nodes])
        zc = ZeroClient(zt)
        for k, preds in enumerate(CLUSTER_GROUPS):
            for p in preds:
                zc.should_serve(p, gids[k])
        for n in nodes:
            n["alpha"].groups.refresh()
        # one CLI heartbeat loop per node slot, every second
        hb0 = count("heartbeat_failures_total")
        for i in range(len(nodes)):
            t = threading.Thread(
                target=cli.run_heartbeat_loop, daemon=True,
                args=("liveness", 1.0, liveness_step(i), hb_log),
                kwargs={"stop": beat})
            t.start()
            beaters.append(t)
        owners = {}
        for n in nodes:
            a = n["alpha"]
            k = gids.index(a.groups.gid)
            local = set(a.mvcc.read_view(a.oracle.read_only_ts()).preds)
            if local != set(bases[k].preds):
                fail("(a) local tablets", node=n["addr"], local=sorted(local))
            owners[n["addr"]] = {p: a.groups.tablet_owner(p, claim=False)
                                 for preds in CLUSTER_GROUPS for p in preds}
        if any(o != owners[nodes[0]["addr"]] for o in owners.values()) or \
                any(owners[nodes[0]["addr"]][p] != gids[k]
                    for k, preds in enumerate(CLUSTER_GROUPS)
                    for p in preds):
            fail("(a) tablet_owner disagrees", owners=owners)

        def placed(a) -> dict:
            """Device bytes a node holds: its snapshot's (shared with its
            group's replicas) and its pulled tablets' hosts'."""
            snap = a.mvcc.read_view(a.oracle.read_only_ts())
            mine = sum(memgov.estimate_nbytes(v) for v in snap._device
                       .values()) + sum(memgov.estimate_nbytes(v) for v in
                                        snap.__dict__.get("_ell_devs", {})
                                        .values())
            with a._state_lock:
                hosts = [e[-1] for e in a._tablet_cache.values()]
            pulled = sum(memgov.estimate_nbytes(v)
                         for h in hosts for v in
                         list(h._device.values())
                         + list(h.__dict__.get("_ell_devs", {}).values()))
            return {"snapshot": mine, "pulled": pulled}

        out["a_boot"] = {"seconds": time.perf_counter() - t0,
                         "groups": {str(gids[k]): [n["addr"] for n in
                                                   group[k]]
                                    for k in range(2)},
                         "split": {str(gids[k]): sorted(bases[k].preds)
                                   for k in range(2)},
                         "placed_device_bytes": {n["addr"]: placed(
                             n["alpha"]) for n in nodes}}
        part("a_boot")

        # (b) reads: the IC mix from one coordinator of each group, byte
        # for byte the single node's; then phase 13's batch on a content-
        # side coordinator, where `knows` is foreign
        coords = [group[0][0]["alpha"], group[1][0]["alpha"]]
        queries = dict(ldbc.ic_templates(g))
        want = {k: single.query_raw(q) for k, q in queries.items()}
        tb0, th0 = count("tablet_bytes_fetched"), \
            count("taskhop_bytes_fetched")
        lat = {"single": [], gids[0]: [], gids[1]: []}
        for _ in range(CLUSTER_PASSES):
            for k, q in queries.items():
                for a in coords:
                    t0 = time.perf_counter()
                    got = a.query_raw(q)
                    lat[a.groups.gid].append(
                        (time.perf_counter() - t0) * 1e3)
                    if got != want[k]:
                        fail("(b) IC answer", template=k,
                             group=a.groups.gid, got=got[:300],
                             want=want[k][:300])
                t0 = time.perf_counter()
                single.query_raw(q)
                lat["single"].append((time.perf_counter() - t0) * 1e3)
        tablet_bytes = count("tablet_bytes_fetched") - tb0
        taskhop_bytes = count("taskhop_bytes_fetched") - th0
        if not tablet_bytes or not taskhop_bytes:
            fail("(b) both remote routes", tablet_bytes=tablet_bytes,
                 taskhop_bytes=taskhop_bytes)
        rng = np.random.default_rng(LDBC_SEED)
        persons = rng.choice(g.person_uids, MEMCOST_RECURSE, replace=False)
        work = [q for _n, q in ldbc.ic_batch(
            g, copies=CLUSTER_BATCH_COPIES)] + [
            "{ q(func: uid(%s)) @recurse(depth: %d) { uid knows } }"
            % (hex(int(p)), MEMCOST_RECURSE_DEPTH) for p in persons]
        want_work = canon(single.query_batch(work))
        content = coords[1]
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        t0 = time.perf_counter()
        got = content.query_batch(work)
        batch_cold_s = time.perf_counter() - t0
        out["bucket_hop_launches"] = LAUNCHES["bucket_hop"]
        if canon(got) != want_work:
            fail("(b) cluster batch differs from the single node's")
        if on_card and not out["bucket_hop_launches"]:
            fail("(b) the cluster batch launched no bucket_hop")
        # the second run at the same version: no ELL built, no CSR or
        # ELL placed, no tablet pulled
        built = {"ell": 0, "ell_placed": 0, "csr_placed": 0}
        real = bfs.build_ell, bfs.device_ell, Store._note_placed

        def build_ell(*a, **kw):
            built["ell"] += 1
            return real[0](*a, **kw)

        def device_ell(*a, **kw):
            built["ell_placed"] += 1
            return real[1](*a, **kw)

        def note_placed(self, *a, **kw):
            built["csr_placed"] += 1
            return real[2](self, *a, **kw)

        tb1 = count("tablet_bytes_fetched")
        bfs.build_ell, bfs.device_ell = build_ell, device_ell
        Store._note_placed = note_placed
        try:
            t0 = time.perf_counter()
            again = content.query_batch(work)
            batch_warm_s = time.perf_counter() - t0
        finally:
            bfs.build_ell, bfs.device_ell, Store._note_placed = real
        built["tablet_bytes_pulled"] = count("tablet_bytes_fetched") - tb1
        if canon(again) != want_work or any(built.values()):
            fail("(b) the second batch built, placed or pulled", **built)
        out["b_reads"] = {
            "ic_mix_p50_ms": {str(k): float(np.median(v))
                              for k, v in lat.items()},
            "tablet_bytes_fetched": tablet_bytes,
            "taskhop_bytes_fetched": taskhop_bytes,
            "batch_queries": len(work), "batch_cold_s": batch_cold_s,
            "batch_warm_s": batch_warm_s,
            "bucket_hop_launches": out["bucket_hop_launches"],
            "second_run": built,
            "placed_device_bytes": {n["addr"]: placed(n["alpha"])
                                    for n in nodes}}
        part("b_reads")

        # (c) replicated writes, alternating coordinators of the two
        # groups, mirrored into the single node; every acked commit is
        # read at its commit ts on each replica of each group it wrote
        mix = write_mix.make_mix(g, n=100, seed=CLUSTER_WRITE_SEED, tag="c")
        by = [[tx for tx in mix.txns if _cluster_txn_groups(tx) == {k}]
              for k in range(2)]
        singles = by[0][CLUSTER_CROSS:CLUSTER_CROSS + 3] + by[1][
            CLUSTER_CROSS:CLUSTER_CROSS + CLUSTER_TXNS - 3 - CLUSTER_CROSS]
        txns = []
        for i in range(CLUSTER_TXNS):
            if i % (CLUSTER_TXNS // CLUSTER_CROSS) == 0:
                j = i // (CLUSTER_TXNS // CLUSTER_CROSS)
                txns.append([by[0][j], by[1][j]])
            else:
                txns.append([singles.pop(0)])
        commit_ms, reads = [], 0

        def commit_on(a, parts_kw):
            t0 = time.perf_counter()
            t = a.new_txn()
            uids = {}
            for kw in parts_kw:
                uids.update(t.mutate(**kw))
            cts = t.commit()
            return cts, uids, (time.perf_counter() - t0) * 1e3

        def subjects_of(kws, uids) -> set:
            out = set(uids.values())
            for kw in kws:
                out |= set(re.findall(r"0x[0-9a-f]+", json.dumps(kw)))
            return out

        def check_commit(touched, subjects, cts):
            """The commit at `cts` on every replica of each group it
            wrote, read at its commit ts, against the mirror."""
            nonlocal reads
            for k in sorted(touched):
                q = CLUSTER_READ[k] % ", ".join(sorted(subjects))
                mirror = single.query_raw(q)
                for n in group[k]:
                    got = n["alpha"].query_raw(q, read_ts=cts)
                    reads += 1
                    if got != mirror:
                        fail("(c) a replica differs from the mirror",
                             node=n["addr"], ts=cts, got=got[:300],
                             want=mirror[:300])

        for i, txn_parts in enumerate(txns):
            kws = [tx.kwargs() for tx in txn_parts]
            a = coords[i % 2]
            cts, uids, ms = commit_on(a, copy.deepcopy(kws))
            commit_ms.append(ms)
            mirror_kws = _mirrored(kws, uids)
            t = single.new_txn()
            for kw in mirror_kws:
                t.mutate(**kw)
            t.commit()
            check_commit(set().union(*(_cluster_txn_groups(tx)
                                       for tx in txn_parts)),
                         subjects_of(mirror_kws, uids), cts)
        # two coordinators, one per group, write one key at once
        person = hex(int(g.person_uids[3]))
        go = threading.Barrier(2)
        results = {}

        def race(k):
            t = coords[k].new_txn()
            t.mutate(set_nquads=f'<{person}> <first_name> "Race{k}" .')
            go.wait()
            try:
                results[k] = t.commit()
            except TxnAborted as e:
                results[k] = e

        threads = [threading.Thread(target=race, args=(k,))
                   for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        won = [k for k, r in results.items() if isinstance(r, int) and r]
        lost = [k for k, r in results.items() if isinstance(r, TxnAborted)]
        if len(won) != 1 or len(lost) != 1:
            fail("(c) concurrent writes of one key", results=results)
        single.mutate(set_nquads=f'<{person}> <first_name> '
                                 f'"Race{won[0]}" .')
        check_commit({0}, {person}, results[won[0]])
        out["c_writes"] = {
            "txns": len(txns), "cross_group": CLUSTER_CROSS,
            "kinds": sorted({tx.kind for p in txns for tx in p}),
            "commit_p50_ms": float(np.median(commit_ms)),
            "commit_p99_ms": float(np.percentile(commit_ms, 99)),
            "single_node_commit_p50_ms": single_commit_p50_ms,
            "replica_reads": reads, "race_winner_group": gids[won[0]]}
        part("c_writes")

        # (d) a person-side replica down during commits, restarted from
        # its WAL; then a coordinator cut off from both its peers
        victim = group[0][2]
        ru0 = count("read_unavailable_total")
        victim["down"] = True
        victim["server"].stop(None)
        victim["alpha"].wal.close()
        # half of them write the person side: its stage reaches two of
        # three replicas, the majority
        dmix = write_mix.make_mix(g, n=100, seed=CLUSTER_WRITE_SEED + 1,
                                  tag="d")
        half = CLUSTER_DOWN_COMMITS // 2
        sides = [[tx for tx in dmix.txns
                  if _cluster_txn_groups(tx) == {k}][:half]
                 for k in range(2)]
        down_txns = [tx for pair in zip(*sides) for tx in pair]
        touched = {0: set(), 1: set()}
        for i, tx in enumerate(down_txns):
            kws = [tx.kwargs()]
            cts, uids, _ms = commit_on(coords[i % 2], copy.deepcopy(kws))
            mirror_kws = _mirrored(kws, uids)
            single.mutate(**mirror_kws[0])
            for k in _cluster_txn_groups(tx):
                touched[k] |= subjects_of(mirror_kws, uids)
        # with the replica still down, its group's live replicas and the
        # other group's coordinator serve every write of the outage
        for k, subjects in touched.items():
            if not subjects:
                continue
            q = CLUSTER_READ[k] % ", ".join(sorted(subjects))
            want_q = single.query_raw(q)
            for n in [n for n in group[k] if n is not victim] + [
                    {"alpha": coords[1 - k], "addr": "other group"}]:
                if n["alpha"].query_raw(q) != want_q:
                    fail("(d) a read while a replica is down",
                         node=n["addr"])
        breakers = {n["addr"]: n["alpha"].groups.resilience.snapshot()
                    .get(victim["addr"], {}) for n in group[0][:2]}
        t0 = time.perf_counter()
        for _ in range(50):
            try:
                back = boot(0, 2, addr=victim["addr"])
                break
            except RuntimeError:      # the port is still being released
                time.sleep(0.1)
        else:
            fail("(d) the replica did not restart")
        servers.append(back["server"])
        heals0 = count("fetchlog_heals_total")
        back["alpha"].resync_on_join()
        catch_up_s = time.perf_counter() - t0
        if count("fetchlog_heals_total") <= heals0:
            fail("(d) the restarted replica healed nothing via FetchLog")
        group[0][2] = nodes[nodes.index(victim)] = back
        # every node's breaker to the restarted replica closes through
        # its half-open probe (the pooled channel that saw the refused
        # connects is dropped first, as a failed broadcast drops it)
        t0 = time.perf_counter()
        for n in nodes:
            if n is back:
                continue
            grp = n["alpha"].groups
            grp.invalidate(victim["addr"])
            while grp.resilience.state(victim["addr"]) != "closed":
                if time.perf_counter() - t0 > 60:
                    fail("(d) a breaker to the restarted replica stays "
                         "open", node=n["addr"])
                try:
                    grp.pool(victim["addr"]).ping()
                except Exception:  # noqa: BLE001 — probe again
                    time.sleep(0.1)
        breakers_closed_s = time.perf_counter() - t0
        q = CLUSTER_READ[0] % ", ".join(hex(int(p)) for p in persons)
        for qq in (q, queries["IC3"], queries["IC13"]):
            if back["alpha"].query_raw(qq) != \
                    group[0][0]["alpha"].query_raw(qq) or \
                    back["alpha"].query_raw(qq) != single.query_raw(qq):
                fail("(d) the restarted replica's reads")
        cut = group[0][1]
        cut["alpha"].groups = FaultyGroups(cut["alpha"].groups)
        for n in group[0]:
            if n is not cut:
                cut["alpha"].groups.drop_link(n["addr"])
        try:
            cut["alpha"].query_raw(q)
            fail("(d) the minority side served a read")
        except ReadUnavailable:
            pass
        try:
            cut["alpha"].mutate(
                set_nquads=f'<{person}> <last_name> "Minority" .')
            fail("(d) the minority side committed")
        except NoQuorum:
            pass
        cut["alpha"].groups.heal_all()
        for qq in (q, queries["IC3"]):
            if cut["alpha"].query_raw(qq) != single.query_raw(qq):
                fail("(d) the healed node's reads")
        after = {n["addr"]: n["alpha"].groups.resilience.snapshot()
                 .get(victim["addr"], {}) for n in group[0][:2]}
        out["d_failure"] = {
            "down_commits": len(down_txns), "catch_up_s": catch_up_s,
            "breakers_closed_s": breakers_closed_s,
            "read_unavailable_total": count("read_unavailable_total") - ru0,
            "breakers_to_victim_while_down": {
                a: {k: b.get(k) for k in ("state", "opened_total",
                                          "failures_total")}
                for a, b in breakers.items()},
            "breakers_to_victim_after": {
                a: {k: b.get(k) for k in ("state", "opened_total",
                                          "failures_total")}
                for a, b in after.items()}}
        part("d_failure")

        # (e) `likes` moves to the person side while 4 threads read it
        likes_qs = [CLUSTER_LIKES_Q % c for c in ldbc.CITIES[:2]] + [
            q for n, q in ldbc.ic_batch(g, copies=2) if n == "IC7"]
        want_likes = {q: single.query_raw(q) for q in likes_qs}
        person_side = coords[0]
        for q in likes_qs:                     # warm the pulls
            if person_side.query_raw(q) != want_likes[q]:
                fail("(e) a read before the move", query=q)
        f0 = (count("tablet_bytes_fetched"), count("taskhop_bytes_fetched"))
        for q in likes_qs[:2]:
            person_side.query_raw(q)
        moving, bad, served = threading.Event(), [], [0]

        def reader(k):
            a = coords[k % 2]
            i = 0
            while moving.is_set() or i < 2 * len(likes_qs):
                q = likes_qs[i % len(likes_qs)]
                got = a.query_raw(q)
                served[0] += 1
                if got != want_likes[q]:
                    bad.append((k, q, moving.is_set(), got[:200],
                                want_likes[q][:200]))
                i += 1

        moving.set()
        threads = [threading.Thread(target=reader, args=(k,))
                   for k in range(CLUSTER_MOVE_READERS)]
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        moved = zc.move_tablet(CLUSTER_MOVE, gids[0])
        move_s = time.perf_counter() - t0
        for n in nodes:
            n["alpha"].groups.refresh()
        moving.clear()
        for t in threads:
            t.join(600)
        if not moved or bad or any(t.is_alive() for t in threads):
            fail("(e) the move", moved=moved, bad=bad[:3])
        if not all(n["alpha"].groups.serves(CLUSTER_MOVE) and
                   CLUSTER_MOVE in n["alpha"].mvcc.read_view(
                       n["alpha"].oracle.read_only_ts()).preds
                   for n in group[0]):
            fail("(e) the person side does not hold the moved tablet")
        f1 = (count("tablet_bytes_fetched"), count("taskhop_bytes_fetched"))
        for q in likes_qs[:2]:
            if person_side.query_raw(q) != want_likes[q]:
                fail("(e) a read after the move")
        f2 = (count("tablet_bytes_fetched"), count("taskhop_bytes_fetched"))
        if f2 != f1:
            fail("(e) the person side still fetches after the move",
                 before=f1, after=f2)
        out["e_move"] = {"moved": moved, "move_s": move_s,
                         "reads_during_move": served[0],
                         "fetch_bytes_before_move": [f1[0] - f0[0],
                                                     f1[1] - f0[1]],
                         "fetch_bytes_after_move": [f2[0] - f1[0],
                                                    f2[1] - f1[1]]}
        part("e_move")

        # (f) the front end over a person-side coordinator
        srv = make_http_server(coords[0], "127.0.0.1", 0)
        serve_background(srv)
        https.append(srv)
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        st, _h, body = http(base, "/state")
        state = json.loads(body)
        members = {g_: sorted(m["addr"] for m in doc["members"].values())
                   for g_, doc in state["groups"].items()}
        split = {g_: sorted(doc["tablets"]) for g_, doc
                 in state["groups"].items()}
        want_split = {str(gids[k]): sorted(set(CLUSTER_GROUPS[k])
                                           ^ {CLUSTER_MOVE})
                      for k in range(2)}
        if st != 200 or members != {str(gids[k]): sorted(
                n["addr"] for n in group[k]) for k in range(2)} or \
                split != want_split:
            fail("(f) /state", status=st, members=members, split=split,
                 want_split=want_split)
        st, _h, body = http(base, "/debug/peers")
        peers = json.loads(body)
        if st != 200 or not peers["enabled"] or not peers["peers"]:
            fail("(f) /debug/peers", status=st, body=body[:300])
        t0 = time.perf_counter()
        st, _h, body = http(base, "/debug/fleet")
        fleet_s = time.perf_counter() - t0
        doc = json.loads(body)
        if st != 200 or doc["errors"] or set(doc["nodes"]) != {
                n["addr"] for n in nodes}:
            fail("(f) /debug/fleet", status=st, errors=doc.get("errors"),
                 nodes=sorted(doc.get("nodes", ())))
        out["f_front_end"] = {
            "state_groups": members, "state_split": split,
            "peer_states": {a: p["state"] for a, p in
                            peers["peers"].items()},
            "fleet_nodes": len(doc["nodes"]), "fleet_s": fleet_s}
        part("f_front_end")

        # (g) the flight recorder across the cluster: a coordinator
        # request waiting on a leg to the content side is convicted, and
        # the bundle pulls that peer's flight over DebugFlight
        from dgraph_tpu_torch.utils import flightrec
        tag = "phase 15 flight"
        commit_on(coords[1], [{"set_nquads": f'_:t <tag_name> "{tag}" .'}])
        # a person-side read first: the coordinator's fold of the new
        # commit ts (~0.6 s at SF1) is done before the convicted request,
        # which then spends its time in the stalled leg, not in the fold
        coords[0].query_raw(CLUSTER_READ[0] % hex(int(g.person_uids[0])))
        content_addrs = {n["addr"] for n in group[1]}
        fired = threading.Event()

        def stall_once():
            if not fired.is_set():
                fired.set()
                time.sleep(CLUSTER_STALL_S)

        clients = [coords[0].groups.pool(x) for x in content_addrs]
        diag = os.path.join(tmp, "flight")
        flightrec.arm(diag_dir=diag, alpha=coords[0], poll_s=0.02,
                      stall_factor=2.0, stall_floor_ms=CLUSTER_STALL_FLOOR_MS,
                      min_dump_interval_s=600.0)
        try:
            for c in clients:
                c.fault_check = stall_once
            q_tag = '{ q(func: eq(tag_name, "%s")) { tag_name } }' % tag
            t0 = time.perf_counter()
            got = json.loads(coords[0].query_raw(q_tag))
            wedged_s = time.perf_counter() - t0
            dumps = flightrec.dumps()
        finally:
            for c in clients:
                c.fault_check = None
            flightrec.disarm()
        bundle = {}
        if len(dumps) == 1 and dumps[0]["path"]:
            with open(dumps[0]["path"]) as f:
                bundle = json.load(f)
        reason = bundle.get("reason") or {}
        pulled = bundle.get("peer_flight") or {}
        if not fired.is_set() or got["q"] != [{"tag_name": tag}] or \
                len(dumps) != 1 or reason.get("kind") != "request" or \
                reason.get("peer") not in content_addrs or \
                set(pulled.get("flight") or ()) < {"inflight", "ring",
                                                   "watchdog"}:
            fail("(g) the conviction on a peer leg", fired=fired.is_set(),
                 answer=got, dumps=dumps, reason={k: v for k, v in
                                                  reason.items() if k != "op"},
                 peer_flight={k: v for k, v in pulled.items()
                              if k != "flight"})
        st, _h, body = http(base, "/debug/fleet/flight?peer=" +
                            reason["peer"])
        peer_doc = json.loads(body) if st == 200 else {}
        if set(peer_doc) < {"armed", "inflight", "ring", "watchdog"}:
            fail("(g) /debug/fleet/flight", status=st, body=body[:300])
        out["g_flight"] = {"stall_s": CLUSTER_STALL_S, "wedged_s": wedged_s,
                           "peer": reason["peer"],
                           "peer_rpc": reason.get("peer_rpc"),
                           "threshold_us": reason.get("threshold_us"),
                           "peer_inflight": len(pulled["flight"]["inflight"]),
                           "fleet_flight_keys": sorted(peer_doc)}
        part("g_flight")
    finally:
        beat.set()
        for t in beaters:
            t.join(10)
        if beaters:
            out["heartbeats"] = {
                "loops": len(beaters),
                "failures": count("heartbeat_failures_total") - hb0}
        for srv in https:
            srv.shutdown()
        for s in servers:
            s.stop(None)
        if zs is not None:
            zs.stop(None)
        for n in nodes:
            if n["alpha"].wal is not None:
                n["alpha"].wal.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# -- phase 17: the CLI on the card --------------------------------------------

CLI_MAX_INFLIGHT = 4            # (a) admission tokens per lane
CLI_QUEUE_DEPTH = 16            # (a) ... and the wait queue
CLI_TS_INTERVAL_S = 0.25        # (a) the child's sampler cadence
CLI_PASSES = 3                  # (a) IC-mix passes over HTTP
CLI_WRITES = 2                  # (a) write_mix txns through /mutate?commitNow
CLI_WRITE_SEED = 31             # (a) their seed (tag "cli")
CLI_BOOT_S = 300.0              # a child's boot: torch import, SF1 open
CLI_SIGUSR2_S = 5.0             # (b) the bundle lands within this
CLI_INFLIGHT_S = 0.2            # (c) SIGINT this long into a batch
CLI_SIGINT_S = 60.0             # (c) the clean exit within this
CLI_VERB_S = 600                # (b), (c) an offline verb's time limit
CLI_HEARTBEAT_S = 0.5           # (d) the cluster Alphas' liveness period
CLI_ZERO_LIVENESS_S = 3         # (d) Zero's liveness window
CLI_ESCALATE_S = 60.0           # (d) the dead Zero's escalation within this
CLI_CLUSTER_Q = '{ q(func: eq(name, "alice")) { name friend { name } } }'
CLI_CLUSTER_WANT = {"q": [{"name": "alice", "friend": [{"name": "bob"}]}]}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_open(port: int) -> bool:
    import socket
    with socket.socket() as s:
        return s.connect_ex(("127.0.0.1", port)) == 0


class _Children:
    """The phase's `python -m dgraph_tpu_torch` processes, each with its
    output in a file of the phase's directory; `close` kills and waits
    for every one still running."""

    def __init__(self, tmp: str):
        self.tmp, self.procs = tmp, {}

    def start(self, name: str, *argv: str, env=None) -> subprocess.Popen:
        log = open(os.path.join(self.tmp, f"{name}.log"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "dgraph_tpu_torch", *argv],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
            stderr=subprocess.STDOUT, env=env)
        self.procs[name] = (proc, log)
        return proc

    def log(self, name: str) -> str:
        with open(os.path.join(self.tmp, f"{name}.log")) as f:
            return f.read()

    def alive(self) -> list:
        return sorted(n for n, (p, _l) in self.procs.items()
                      if p.poll() is None)

    def close(self) -> None:
        for proc, log in self.procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            log.close()


def run_verb(seconds: dict, label: str, *argv: str) -> tuple:
    """(exit code, printed JSON or None, output) of one offline verb;
    its wall seconds go to `seconds[label]`."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "dgraph_tpu_torch", *argv],
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       capture_output=True, text=True, timeout=CLI_VERB_S)
    seconds[label] = time.perf_counter() - t0
    try:
        doc = json.loads(r.stdout)
    except ValueError:
        doc = None
    return r.returncode, doc, r.stdout[-2000:] + r.stderr[-3000:]


def prom_value(text: str, name: str, **labels) -> float:
    """The sum of `dgraph_tpu_<name>` samples carrying `labels`."""
    import re
    total = 0.0
    for m in re.finditer(r"^dgraph_tpu_%s(\{[^}]*\})? (\S+)$"
                         % re.escape(name), text, re.M):
        got = dict(re.findall(r'(\w+)="([^"]*)"', m.group(1) or ""))
        if all(got.get(k) == v for k, v in labels.items()):
            total += float(m.group(2))
    return total


def debug_doc(p_dir: str) -> dict:
    """The `debug` verb's document of `p_dir`, made in this process."""
    import contextlib
    import io

    from dgraph_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["debug", "--p", p_dir])
    return json.loads(buf.getvalue())


def wait_up(kids: _Children, name: str, base: str,
            limit_s: float = CLI_BOOT_S, phase: str = "phase 17") -> float:
    """Seconds until the child `name` answers /health; fails if it exits
    or takes longer than `limit_s`."""
    t0 = time.perf_counter()
    while True:
        proc = kids.procs[name][0]
        if proc.poll() is not None:
            raise AssertionError(f"{phase}: {name} exited with "
                                 f"{proc.returncode}: "
                                 f"{kids.log(name)[-3000:]}")
        try:
            st, _h, _b = http(base, "/health", timeout=5)
            if st == 200:
                return time.perf_counter() - t0
        except OSError:
            pass
        if time.perf_counter() - t0 > limit_s:
            raise AssertionError(f"{phase}: {name} not up in {limit_s} s: "
                                 f"{kids.log(name)[-3000:]}")
        time.sleep(0.2)


def phase_cli(device, g, handed: dict, device_budget_bytes: int) -> dict:
    """Phase 17: `python -m dgraph_tpu_torch` in real processes on the
    card, over phase 16's copy of phase 14's SF1 directory (`handed`,
    with the in-process answers over it). (a) the alpha verb serving
    HTTP; (b) SIGUSR2, `diagnose` and `fleet`; (c) SIGINT, then `debug`,
    `backup`, `backup verify` and `restore`; (d) a `zero` and two
    cluster alphas, the cross-node read and the dead Zero's escalated
    heartbeats. Removes everything it made; fails if a child is still
    running at its end."""
    import glob
    import re
    import shutil
    import signal
    import threading
    from http.client import HTTPException

    from dgraph_tpu_torch.server.task import Client
    from dgraph_tpu_torch.tools import write_mix

    on_card = torch.device(device).type == "cuda"
    tmp, p_dir = handed["tmp"], handed["p_dir"]
    queries, work = handed["queries"], handed["work"]
    out: dict = {}
    parts = out["parts_s"] = {}
    t_part = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    def fail(what, **kv):
        raise AssertionError(f"phase 17 {what}: " + json.dumps(kv,
                                                              default=str))

    def canon(results) -> list:
        return [json.dumps(r, sort_keys=True) for r in results]

    kids = _Children(tmp)
    verb_s: dict = {}       # each offline verb's wall seconds
    try:
        # (a) the alpha verb on the card, its device left at the default
        budget_mb = -(-device_budget_bytes // (1 << 20))
        hport, gport = free_port(), free_port()
        diag = os.path.join(tmp, "diag")
        on_cpu = [] if on_card else ["--device", "cpu"]
        kids.start("alpha", "alpha", *on_cpu, "--p", p_dir, "--http_port",
                   str(hport), "--grpc_port", str(gport),
                   "--device_budget_mb", str(budget_mb),
                   "--max_inflight", str(CLI_MAX_INFLIGHT),
                   "--queue_depth", str(CLI_QUEUE_DEPTH),
                   "--ts_interval_s", str(CLI_TS_INTERVAL_S),
                   "--diag_dir", diag)
        base = f"http://127.0.0.1:{hport}"
        boot_s = wait_up(kids, "alpha", base)
        lat = []
        for _ in range(CLI_PASSES):
            for k, q in queries.items():
                t0 = time.perf_counter()
                st, _h, body = http(base, "/query", q)
                lat.append((time.perf_counter() - t0) * 1e3)
                if st != 200 or data_bytes(body) != handed["want"][k]:
                    fail("(a) /query", template=k, status=st,
                         body=body[:300])

        def prom() -> str:
            st, _h, body = http(base, "/debug/prometheus_metrics")
            if st != 200:
                fail("(a) /debug/prometheus_metrics", status=st)
            return body.decode()

        groups0 = prom_value(prom(), "kernel_group_launches_total")
        prof_dir = os.path.join(tmp, "profile")
        st, _h, _b = http(base, "/debug/profile", json.dumps(
            {"action": "start", "dir": prof_dir}), ctype="application/json")
        t0 = time.perf_counter()
        st2, _h, body = http(base, "/query/batch",
                             json.dumps({"queries": work}),
                             ctype="application/json")
        batch_s = time.perf_counter() - t0
        st3, _h, _b = http(base, "/debug/profile",
                           json.dumps({"action": "stop"}),
                           ctype="application/json")
        if (st, st2, st3) != (200, 200, 200) or \
                canon(json.loads(body)["data"]) != handed["want_work"]:
            fail("(a) /query/batch", statuses=(st, st2, st3))
        groups = prom_value(prom(), "kernel_group_launches_total") - groups0
        files = glob.glob(os.path.join(prof_dir, "trace-*.json"))
        launches = 0
        if files:
            with open(files[0]) as f:
                launches = sum(1 for e in json.load(f)["traceEvents"]
                               if e.get("cat") == "kernel"
                               and "bucket_hop" in e.get("name", ""))
        out["bucket_hop_launches"] = launches
        if not files or groups <= 0 or (on_card and not launches):
            fail("(a) the batch's kernels", traces=len(files),
                 kernel_groups=groups, bucket_hop=launches)
        st, _h, body = http(base, "/debug/memory")
        mem = json.loads(body)
        if st != 200 or \
                mem["budgets"]["device"]["budget_bytes"] != budget_mb << 20:
            fail("(a) /debug/memory", status=st,
                 budgets=mem.get("budgets"))
        txns = [tx for tx in write_mix.make_mix(
            g, n=100, seed=CLI_WRITE_SEED, tag="cli").txns
            if not tx.del_nquads][:CLI_WRITES]
        acked = 0
        for tx in txns:
            if tx.set_json is not None:
                st, _h, body = http(base, "/mutate?commitNow=true",
                                    json.dumps({"set": tx.set_json}),
                                    ctype="application/json")
                text = json.dumps(tx.set_json)
            else:
                st, _h, body = http(base, "/mutate?commitNow=true",
                                    tx.set_nquads, ctype="application/rdf")
                text = tx.set_nquads
            doc = json.loads(body)["data"] if st == 200 else {}
            if not doc.get("txn", {}).get("commit_ts"):
                fail("(a) /mutate", kind=tx.kind, status=st, body=body[:300])
            acked = max(acked, doc["txn"]["commit_ts"])
            uids = set(doc["uids"].values()) | set(
                re.findall(r"0x[0-9a-f]+", text))
            st, _h, body = http(base, "/query",
                                READ_BACK % ", ".join(sorted(uids)))
            if st != 200 or not json.loads(data_bytes(body))["q"]:
                fail("(a) a write not read back", kind=tx.kind, status=st)
        warm = lat[len(queries):]          # the passes after the first
        out["a_alpha"] = {
            "boot_s": boot_s, "requests": len(lat),
            "http_p50_ms": float(np.median(lat)),
            "warm_http_p50_ms": float(np.median(warm)),
            "http_p99_ms": float(np.percentile(lat, 99)),
            "batch_queries": len(work), "batch_http_s": batch_s,
            "kernel_groups": groups, "bucket_hop_launches": launches,
            "device_budget_mb": budget_mb,
            "device_resident_bytes":
                mem["budgets"]["device"]["resident_bytes"],
            "cache_evictions": sum(c.get("evictions", 0)
                                   for c in mem["caches"].values()),
            "writes": [tx.kind for tx in txns], "last_commit_ts": acked}
        part("a_alpha")

        # (b) diagnostics: SIGUSR2, then the diagnose and fleet verbs
        proc = kids.procs["alpha"][0]
        proc.send_signal(signal.SIGUSR2)
        t0 = time.perf_counter()
        bundles = []
        while time.perf_counter() - t0 < CLI_SIGUSR2_S and not bundles:
            time.sleep(0.05)
            bundles = glob.glob(os.path.join(diag, "flight-sigusr2-*.json"))
        sig_s = time.perf_counter() - t0
        if len(bundles) != 1:
            fail("(b) SIGUSR2", bundles=bundles, seconds=sig_s)
        addr = f"127.0.0.1:{hport}"
        rc, doc, text = run_verb(verb_s, "diagnose", "diagnose", addr, "--out",
                                 os.path.join(tmp, "pulled.json"))
        if rc != 0 or doc is None or doc["trigger"] != "http" or \
                not doc["server_path"]:
            fail("(b) diagnose", rc=rc, doc=doc, out=text)
        rc, fdoc, text = run_verb(verb_s, "fleet", "fleet", addr, "--out",
                                  os.path.join(tmp, "fleet.json"))
        if rc != 0 or fdoc is None or fdoc["self"] != "local" or \
                set(fdoc["nodes"]) != {"local"}:
            fail("(b) fleet", rc=rc, doc=fdoc, out=text)
        out["b_diagnostics"] = {"sigusr2_s": sig_s,
                                "surfaces": len(doc["surfaces"]),
                                "fleet_self": fdoc["self"]}
        part("b_diagnostics")

        # (c) SIGINT while a request thread serves the batch on the card:
        # drain, final checkpoint, exit 0; then the offline verbs over
        # the directory it left
        inflight = {}

        def batch_client():
            try:
                inflight["status"] = http(
                    base, "/query/batch", json.dumps({"queries": work}),
                    ctype="application/json")[0]
            except (OSError, HTTPException) as e:
                inflight["status"] = type(e).__name__

        client = threading.Thread(target=batch_client, daemon=True)
        client.start()
        time.sleep(CLI_INFLIGHT_S)
        busy = client.is_alive()
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=CLI_SIGINT_S)
        except subprocess.TimeoutExpired:
            rc = None
        sigint_s = time.perf_counter() - t0
        client.join(CLI_SIGINT_S)
        if rc != 0 or "draining maintenance" not in kids.log("alpha"):
            fail("(c) SIGINT", rc=rc, seconds=sigint_s,
                 log=kids.log("alpha")[-3000:])
        t0 = time.perf_counter()
        rc, dbg, text = run_verb(verb_s, "debug", "debug", "--p", p_dir)
        if rc != 0 or dbg is None or dbg["base_ts"] < acked:
            fail("(c) debug after SIGINT", rc=rc, acked=acked,
                 base_ts=None if dbg is None else dbg["base_ts"], out=text)
        # backup, verify and restore of phase 12's sf 0.1 directory (on
        # SF1 the script passed ~800 s); its `debug` document from this
        # process is what the restored one must equal
        small = handed["small"]
        want_dbg = debug_doc(small)
        bk, restored = os.path.join(tmp, "bk"), os.path.join(tmp, "r")
        rc, man, text = run_verb(verb_s, "backup", "backup", "--p", small,
                                  "--dest", bk)
        if rc != 0 or man is None or man["type"] != "full":
            fail("(c) backup", rc=rc, out=text)
        rc, ver, text = run_verb(verb_s, "backup verify", "backup",
                                  "verify", "--dest", bk)
        if rc != 0 or ver is None or not ver["ok"]:
            fail("(c) backup verify", rc=rc, out=text)
        rc, res, text = run_verb(verb_s, "restore", "restore", "--dest",
                                  bk, "--p", restored)
        if rc != 0 or res is None:
            fail("(c) restore", rc=rc, out=text)
        rc, dbg2, text = run_verb(verb_s, "debug restored", "debug",
                                   "--p", restored)
        keys = ("nodes", "predicates", "schema")
        if rc != 0 or dbg2 is None or \
                {k: dbg2[k] for k in keys} != {k: want_dbg[k] for k in keys}:
            fail("(c) the restored directory differs under debug", rc=rc,
                 out=text)
        out["c_offline"] = {
            "sigint_s": sigint_s, "batch_in_flight": busy,
            "batch_outcome": inflight.get("status"),
            "base_ts": dbg["base_ts"],
            "predicates": len(dbg["predicates"]),
            "restored_nodes": want_dbg["nodes"],
            "backup_bytes": dir_bytes(bk),
            "restored_max_ts": res["restored_max_ts"],
            "verbs_s": time.perf_counter() - t0, "verb_s": verb_s}
        part("c_offline")

        # (d) the cluster through the CLI: a Zero and two alphas on the
        # card with empty directories
        zport = free_port()
        kids.start("zero", "zero", "--port", str(zport), "--liveness",
                   str(CLI_ZERO_LIVENESS_S))
        t0 = time.perf_counter()
        while not port_open(zport):
            if kids.procs["zero"][0].poll() is not None or \
                    time.perf_counter() - t0 > CLI_BOOT_S:
                fail("(d) zero did not come up", log=kids.log("zero"))
            time.sleep(0.1)
        nodes = []
        for i in range(2):
            h, gp = free_port(), free_port()
            kids.start(f"node{i}", "alpha", *on_cpu, "--p",
                       os.path.join(tmp, f"c{i}"), "--grpc_port", str(gp),
                       "--http_port", str(h), "--zero",
                       f"127.0.0.1:{zport}", "--heartbeat",
                       str(CLI_HEARTBEAT_S))
            nodes.append((f"node{i}", f"http://127.0.0.1:{h}",
                          f"127.0.0.1:{gp}"))
        t0 = time.perf_counter()
        for name, b, _g in nodes:
            wait_up(kids, name, b)
        boot_s = time.perf_counter() - t0
        c1, c2 = Client(nodes[0][2]), Client(nodes[1][2])
        c1.alter("name: string @index(exact) .\nfriend: [uid] .")
        c1.mutate(set_nquads='_:a <name> "alice" .\n_:b <name> "bob" .\n'
                             '_:a <friend> _:b .', commit_now=True)
        t0 = time.perf_counter()
        while c2.query(CLI_CLUSTER_Q) != CLI_CLUSTER_WANT:
            if time.perf_counter() - t0 > 30:
                fail("(d) the cross-node read",
                     got=c2.query(CLI_CLUSTER_Q))
            time.sleep(0.5)
        read_s = time.perf_counter() - t0
        if c1.query(CLI_CLUSTER_Q) != CLI_CLUSTER_WANT:
            fail("(d) the writing node's read", got=c1.query(CLI_CLUSTER_Q))
        c1.channel.close()
        c2.channel.close()
        rc, fdoc, text = run_verb(verb_s, "fleet cluster", "fleet",
                                  nodes[0][1][len("http://"):])
        if rc != 0 or fdoc is None or fdoc["self"] != nodes[0][2] or \
                set(fdoc["nodes"]) != {n[2] for n in nodes}:
            fail("(d) fleet over the cluster", rc=rc, doc=fdoc, out=text)
        zero = kids.procs["zero"][0]
        zero.kill()
        zero.wait()
        t0 = time.perf_counter()
        fails = {}
        for name, b, _g in nodes:
            while True:
                st, _h, body = http(b, "/debug/prometheus_metrics")
                fails[name] = prom_value(body.decode(),
                                         "heartbeat_failures_total",
                                         kind="liveness")
                if fails[name] >= 3 and \
                        "zero link is likely dead" in kids.log(name):
                    break
                if time.perf_counter() - t0 > CLI_ESCALATE_S:
                    fail("(d) the dead Zero's heartbeats", node=name,
                         failures=fails[name], log=kids.log(name)[-2000:])
                time.sleep(0.25)
        escalate_s = time.perf_counter() - t0
        for name, _b, _g in nodes:
            proc = kids.procs[name][0]
            proc.send_signal(signal.SIGINT)
            try:
                rc = proc.wait(timeout=CLI_SIGINT_S)
            except subprocess.TimeoutExpired:
                rc = None
            if rc != 0:
                fail("(d) a cluster alpha's SIGINT", node=name, rc=rc,
                     log=kids.log(name)[-3000:])
        out["d_cluster"] = {"boot_s": boot_s, "cross_read_s": read_s,
                            "escalate_s": escalate_s,
                            "liveness_failures": fails}
        part("d_cluster")
        left = kids.alive()
        if left:
            fail("children still running", names=left)
    except BaseException:
        say("phase 17 cli (stopped)", **out)
        raise
    finally:
        kids.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# -- phase 18: static analysis against the card's run -------------------------

LINT_TIMEOUT_S = 300      # (a) the analyzer's child process


def phase_static_analysis(launches: dict) -> dict:
    """Phase 18: (a) the port's static analysis over the tree as
    shipped, in a child process: exit 0 and no unwaived finding; (b) its
    facts against what this process did in phases 1-17 (`launches`: the
    main paths' launches of each hand kernel)."""
    from dgraph_tpu_torch.analysis.facts import runtime_misses
    from dgraph_tpu_torch.utils import locks, memgov, tracing
    from dgraph_tpu_torch.utils.metrics import METRICS

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dgraph_tpu_torch.analysis", "--format=json"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=LINT_TIMEOUT_S)
    lint_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 18 (a): the analyzer exited "
                             f"{proc.returncode}: {proc.stdout[-3000:]}"
                             f"{proc.stderr[-3000:]}")
    doc = json.loads(proc.stdout)
    if doc["findings"]:
        raise AssertionError("phase 18 (a): unwaived findings: "
                             + json.dumps(doc["findings"]))
    t1 = time.perf_counter()
    made, names, spans = set(locks.MADE), METRICS.names(), tracing.names()
    caches = memgov.GOVERNOR.registered_names(ever=True)
    misses = runtime_misses(doc["facts"], locks=made, metrics=names,
                            spans=spans, caches=caches, launches=launches,
                            sources=KERNEL_SOURCES)
    if misses:
        raise AssertionError("phase 18 (b): the static facts miss what "
                             "the run did: " + json.dumps(misses))
    return {"a_lint": {"seconds": lint_s, "findings": 0,
                       "waived_by_rule": {r: n for r, n in
                                          doc["counts"]["waived"].items()
                                          if n},
                       "facts": doc["facts"]["totals"]},
            "b_run": {"seconds": time.perf_counter() - t1,
                      "lock_names": len(made), "metric_names": len(names),
                      "span_names": len(spans), "caches": sorted(caches),
                      "kernel_launches": launches}}


# -- phase 19: mesh serving in one process ----------------------------------------

MESH_SHARDS = 4
MESH_RECURSE_QUERIES = 4        # (c) queries of MESH_RECURSE_ROOTS roots
MESH_RECURSE_ROOTS = 16         # each: 64 roots in all
MESH_RECURSE_DEPTH = 4
MESH_RECURSE_SEED = 17
MESH_LANES = 512                # (e) lanes (int8 mask columns)
MESH_DEPTH = 4
MESH_LANE_SEED = 23
MESH_HTTP_TEMPLATES = ("IC2", "IC7", "IC9", "config3")   # (f)
MESH_TIMING_REPS = 3
MESH_RTOL, MESH_ATOL = 1e-5, 1e-6
# each mesh program and the reference function it ports
MESH_PROGRAMS = {
    "matrix_hop": ("dgraph_tpu_torch.parallel.dhop", "matrix_hop",
                   "dgraph_tpu/parallel/dhop.py:117"),
    "matrix_level": ("dgraph_tpu_torch.parallel.dhop", "matrix_level",
                     "dgraph_tpu/parallel/dhop.py:167"),
    "ring_matrix_hop": ("dgraph_tpu_torch.parallel.dhop", "ring_matrix_hop",
                        "dgraph_tpu/parallel/dhop.py:286"),
    "chain_hop": ("dgraph_tpu_torch.parallel.dhop", "chain_hop",
                  "dgraph_tpu/parallel/dhop.py:500"),
    "recurse_fused_matrix": ("dgraph_tpu_torch.parallel.dhop",
                             "recurse_fused_matrix",
                             "dgraph_tpu/parallel/dhop.py:410"),
    "mesh_topk": ("dgraph_tpu_torch.parallel.dsort", "mesh_topk",
                  "dgraph_tpu/parallel/dsort.py:130"),
    "mesh_row_sort": ("dgraph_tpu_torch.parallel.dsort", "mesh_row_sort",
                      "dgraph_tpu/parallel/dsort.py:190"),
    "knn_mesh": ("dgraph_tpu_torch.store.vec", "_mesh_topk",
                 "dgraph_tpu/store/vec.py:213"),
    "feat_mesh": ("dgraph_tpu_torch.engine.feat", "_mesh_combine",
                  "dgraph_tpu/engine/feat.py:136"),
    "bitmap_recurse_sharded": ("dgraph_tpu_torch.parallel.dbfs",
                               "bitmap_recurse_sharded",
                               "dgraph_tpu/parallel/dbfs.py:137"),
}
_SENT = 2**31 - 1


def card_mesh(device):
    """Phase 19's mesh: four shards of card 0 (four of the CPU in a
    rehearsal)."""
    from dgraph_tpu_torch.parallel.mesh import make_mesh
    if torch.device(device).type == "cuda":
        return make_mesh(MESH_SHARDS,
                         devices=[torch.device("cuda", 0)] * MESH_SHARDS)
    return make_mesh(MESH_SHARDS, device="cpu")


def _valid(x) -> int:
    from dgraph_tpu_torch.parallel.mesh import host_np
    return int((host_np(x) != _SENT).sum())


def mesh_least_bytes(name: str, a: dict, out) -> int:
    """Least bytes of one mesh program call: each input it must read once
    (the frontier, the indptr pairs of its real rows, the edges' ids, a
    filter set, the tablet rows it scores) and each output written once
    (the real edges' (nbrs, seg, pos), the next frontier and seen set,
    ranks, feature rows), whatever the shard count. A sharded output of
    a mesh across processes is read through host_np, which gathers it:
    every rank reads it in turn."""
    from dgraph_tpu_torch.parallel.mesh import host_np
    if name == "matrix_hop":
        fr = host_np(a["frontier"])
        total = int(host_np(out[3]).sum())
        return 4 * fr.size + 8 * _valid(fr) + 16 * total
    if name == "matrix_level":
        fr = host_np(a["frontier"])
        total = int(host_np(out[4]).sum())
        kept = int(host_np(out[3]).sum())
        allowed = 4 * len(np.asarray(a["allowed"])) if a["use_allowed"] \
            else 0
        return 4 * fr.size + 8 * _valid(fr) + 4 * total + allowed + 12 * kept
    if name == "ring_matrix_hop":
        ch = host_np(a["frontier_chunks"])
        return 4 * ch.size + 8 * _valid(ch) + \
            16 * int(host_np(out[3]).sum())
    if name == "chain_hop":
        fr = host_np(a["frontier"])
        caps = 4 * (a["out_cap"] + a["seen_cap"])
        return 2 * caps + 8 * _valid(fr) + 4 * int(out[2]) + 8 * int(out[7])
    if name == "recurse_fused_matrix":
        frs = host_np(out[7])
        return (4 * (a["out_cap"] + a["seen_cap"]) + 8 * _valid(frs)
                + 4 * int(out[2]) + 12 * _valid(out[4]) + 4 * frs.size)
    if name == "mesh_topk":
        return 12 * len(a["ranks"]) + 4 * (0 if out is None else len(out))
    if name == "mesh_row_sort":
        return 24 * len(a["nbrs"])
    if name == "knn_mesh":
        t = a["store"].vec_tablet(a["pred"])
        return int(t.vecs.nbytes + t.subj.nbytes) + 4 * t.dim + 4 * a["k"]
    if name == "feat_mesh":
        n_seg, dim = out[0].shape
        return (8 * len(a["nbrs"]) + 4 * dim * int(out[1].sum())
                + 4 * n_seg * dim + 8 * n_seg)
    if name == "bitmap_recurse_sharded":
        slabs = np.asarray(a["mask_slabs"])
        n, b = slabs.shape[0] * slabs.shape[1], slabs.shape[2]
        return 8 * int(np.asarray(a["deg_s"]).sum()) + 4 * n + 3 * n * b \
            + 4 * b
    raise KeyError(name)


class ProgramTape:
    """The mesh programs wrapped while armed: per call its device ms (a
    CUDA event pair around it) and least bytes; the largest call's
    arguments are kept for the timing replays."""

    def __init__(self, device):
        self.on_card = torch.device(device).type == "cuda"
        self.calls = {n: [] for n in MESH_PROGRAMS}
        self.biggest: dict = {}
        self.fns: dict = {}

    @contextlib.contextmanager
    def armed(self):
        import importlib
        import inspect
        saved = []
        for name, (mod, attr, _ref) in MESH_PROGRAMS.items():
            m = importlib.import_module(mod)
            fn = getattr(m, attr)
            self.fns[name] = fn
            saved.append((m, attr, fn))
            setattr(m, attr, self._wrap(name, fn, inspect.signature(fn)))
        try:
            yield self
        finally:
            for m, attr, fn in saved:
                setattr(m, attr, fn)

    def _wrap(self, name, fn, sig):
        def call(*a, **kw):
            ev = None
            if self.on_card:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = fn(*a, **kw)
            if ev is not None:
                ev[1].record()
            args = sig.bind(*a, **kw)
            args.apply_defaults()
            nb = mesh_least_bytes(name, args.arguments, out)
            self.calls[name].append((ev, nb))
            if nb >= self.biggest.get(name, (-1,))[0]:
                self.biggest[name] = (nb, a, kw)
            return out
        return call

    def summary(self) -> dict:
        if self.on_card:
            torch.cuda.synchronize()
        out = {}
        for name, calls in self.calls.items():
            if not calls:
                continue
            ms = [e[0].elapsed_time(e[1]) for e, _b in calls] \
                if self.on_card else []
            nb = sum(b for _e, b in calls)
            out[name] = {"calls": len(calls), "ms_total": sum(ms),
                         "least_bytes": nb,
                         "bound_ms": nb / HBM_BYTES_PER_S * 1e3}
        return out


def one_shard_rel(srel, device):
    """The same CSR as a 1-shard ShardedRel on `device`, stitched on the
    device from a placed mesh tablet (the single-device form)."""
    from dgraph_tpu_torch.parallel.mesh import Sharded
    from dgraph_tpu_torch.parallel.pshard import ShardedRel
    ptrs, idxs, base = [], [], 0
    for p, i in zip(srel.indptr_s.parts, srel.indices_s.parts):
        nnz = int(p[-1])
        ptrs.append(p[:-1].to(device) + base)
        idxs.append(i[:nnz].to(device))
        base += nnz
    n = srel.n_nodes
    ptr = torch.cat(ptrs)[:n]
    ptr = torch.cat([ptr, torch.tensor([base], dtype=ptr.dtype,
                                       device=ptr.device)])
    return ShardedRel(indptr_s=Sharded([ptr]),
                      indices_s=Sharded([torch.cat(idxs)]),
                      row_lo=np.zeros(1, np.int32), n_nodes=n,
                      pos_lo=np.zeros(1, np.int64))


def _single(name, a: dict, device):
    """The single-device form of one recorded call: the program on ONE
    shard of the card (a 1-shard mesh over the whole CSR: what the
    sharded program reduces to), the device top-k over the whole stack
    for knn, segment_combine over the whole stack for @msgpass."""
    import functools
    from dgraph_tpu_torch.ops.feat import segment_combine
    from dgraph_tpu_torch.parallel import dhop, dsort
    from dgraph_tpu_torch.parallel.mesh import make_mesh
    from dgraph_tpu_torch.parallel.pshard import shard_frontier
    from dgraph_tpu_torch.store import vec

    dev = torch.device(device)
    one = (make_mesh(devices=[dev]) if dev.type == "cuda"
           else make_mesh(1, device="cpu"))
    if name in ("matrix_hop", "matrix_level", "chain_hop",
                "recurse_fused_matrix"):
        rel = one_shard_rel(a["rel"], dev)
        kw = {k: v for k, v in a.items() if k not in ("mesh", "rel")}
        if name == "matrix_hop":
            kw["edge_cap"] *= MESH_SHARDS
        elif name == "matrix_level":
            kw["edge_cap"] *= MESH_SHARDS
        elif name == "chain_hop":
            kw["edge_cap"] *= MESH_SHARDS
            kw["frontier"] = np.asarray(kw["frontier"])
            kw["seen"] = np.asarray(kw["seen"])
        else:
            kw["edge_cap"] *= MESH_SHARDS
        return functools.partial(getattr(dhop, name), one, rel, **kw)
    if name == "ring_matrix_hop":
        rel = one_shard_rel(a["rel"], dev)
        ch = np.asarray(a["frontier_chunks"])
        fr = ch[ch != _SENT]
        cap = 64
        while cap < max(len(fr), 1):
            cap <<= 1
        return functools.partial(
            dhop.ring_matrix_hop, one, rel, shard_frontier(fr, 1, cap),
            a["edge_cap"] * MESH_SHARDS * MESH_SHARDS)
    if name in ("mesh_topk", "mesh_row_sort"):
        kw = {k: v for k, v in a.items() if k != "mesh"}
        return functools.partial(getattr(dsort, name), one, **kw)
    if name == "knn_mesh":
        subj, vecs = a["store"].vec_device(a["pred"], dev)
        q = torch.from_numpy(np.asarray(a["q"], np.float32)).to(dev)
        return functools.partial(vec.device_topk, subj, vecs, q, a["k"])
    if name == "feat_mesh":
        subj, vecs = a["store"].vec_device(a["pred"], dev)
        nb = torch.from_numpy(np.asarray(a["nbrs"], np.int32)).to(dev)
        sg = torch.from_numpy(np.asarray(a["seg"], np.int32)).to(dev)
        return functools.partial(segment_combine, subj, vecs, nb, sg,
                                 len(nb), a["n_seg"], a["agg"])
    return None


def mesh_program_rows(tape: ProgramTape, device, main_calls: dict,
                      rows: dict) -> None:
    """Fold one part of the phase into `rows`, per mesh program: its
    calls on the part's main path (`main_calls`, read before any
    replay), device ms per call and least-bytes bound over all of them,
    and its largest call replayed (1 warm-up, MESH_TIMING_REPS timed,
    CUDA events) on the mesh and in its single-device form. The tape
    then lets go of the part's arguments (their stores)."""
    import inspect
    served = tape.summary()
    for name, (nb, a, kw) in tape.biggest.items():
        fn = tape.fns[name]
        args = inspect.signature(fn).bind(*a, **kw)
        args.apply_defaults()
        big = {"least_bytes": nb, "bound_ms": nb / HBM_BYTES_PER_S * 1e3}
        if tape.on_card and name != "bitmap_recurse_sharded":
            fn(*a, **kw)
            big["mesh_ms"] = float(np.median(cuda_ms(
                lambda _x: fn(*a, **kw), MESH_TIMING_REPS)))
            single = _single(name, dict(args.arguments), device)
            if single is not None:
                single()
                big["single_ms"] = float(np.median(cuda_ms(
                    lambda _x: single(), MESH_TIMING_REPS)))
            del single
        row = rows.setdefault(name, {"reference": MESH_PROGRAMS[name][2],
                                     "launches": 0, "calls": 0,
                                     "ms_total": 0.0, "least_bytes": 0,
                                     "bound_ms": 0.0, "largest_call": None})
        got = served.get(name, {})
        row["launches"] += main_calls.get(name, 0)
        for k in ("calls", "ms_total", "least_bytes", "bound_ms"):
            row[k] += got.get(k, 0)
        if row["largest_call"] is None or \
                nb > row["largest_call"]["least_bytes"]:
            row["largest_call"] = big
    tape.biggest.clear()
    tape.calls = {n: [] for n in MESH_PROGRAMS}


def mesh_routes_ok(eng, part: str) -> None:
    """Fail `part` when its mesh engine served an expansion off the mesh
    (the device, a whole-block program or the host walk)."""
    off = {r: n for r, n in eng.routes.expansions.items()
           if n and r in ("device", "fused", "program", "numpy", "remote")}
    if off:
        raise AssertionError(f"phase 19 {part}: expansions off the mesh "
                             f"{off}")


def route_set(name: str) -> dict:
    from dgraph_tpu_torch.utils.metrics import METRICS
    return {r: METRICS.get(name, route=r)
            for r in ("host", "device", "fused", "mesh")}


def mesh_counters() -> dict:
    """The `mesh_*` counters and gauges of the registry (the reshard
    count read even when it never moved)."""
    from dgraph_tpu_torch.parallel.mesh import reshard_count
    from dgraph_tpu_torch.utils.metrics import METRICS
    snap = METRICS.snapshot()
    return {"mesh_hop_resharded_total": reshard_count(),
            **{k: v for part in ("counters", "gauges")
               for k, v in snap[part].items() if k.startswith("mesh_")}}


def phase_mesh_bench(device, store, mesh, tape: ProgramTape) -> dict:
    """Phase 19 (c) and (e) on the bench graph (phases 4-5's store)."""
    from dgraph_tpu_torch.engine import Engine, recurse
    from dgraph_tpu_torch.engine.batch import _dev_for
    from dgraph_tpu_torch.ops import bfs
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES as HOP
    from dgraph_tpu_torch.parallel import dbfs
    from dgraph_tpu_torch.parallel.mesh import (PROGRAM_CALLS, host_np,
                                                reshard_count, reshard_guard)
    from dgraph_tpu_torch.tools.hop_profile import make_seeds

    rel = store.rel("follows")
    n = store.n_nodes
    out: dict = {}
    # (c) @recurse(depth: 4) from 64 roots: chained hops, then one call
    t0 = time.perf_counter()
    rng = np.random.default_rng(MESH_RECURSE_SEED)
    roots = [np.unique(rng.integers(0, n, MESH_RECURSE_ROOTS))
             for _ in range(MESH_RECURSE_QUERIES)]
    qs = ["{ v as var(func: uid(%s)) @recurse(depth: %d) { follows } "
          "q(func: uid(v)) { count(uid) } }"
          % (", ".join(hex(int(r) + 1) for r in rs), MESH_RECURSE_DEPTH)
          for rs in roots]
    want_edges = [cpu_recurse(rel.indptr, rel.indices, rs,
                              MESH_RECURSE_DEPTH) for rs in roots]
    single = Engine(store, device=device, device_threshold=LDBC_THRESHOLD)
    want = [single.query_bytes(q) for q in qs]
    r0 = reshard_count()
    c = {}
    for route, chain in (("chain", True), ("fused", False)):
        PROGRAM_CALLS.clear()
        eng = Engine(store, device=device, device_threshold=0, mesh=mesh)
        recurse.MESH_CHAIN_HOPS = chain
        per = []
        try:
            with reshard_guard():
                for q, w, we in zip(qs, want, want_edges):
                    e0 = eng.routes.edges["mesh_chain"]
                    t1 = time.perf_counter()
                    got = eng.query_bytes(q)
                    per.append({"ms": (time.perf_counter() - t1) * 1e3,
                                "edges": eng.routes.edges["mesh_chain"] - e0,
                                "answer": got.decode()})
                    if got != w:
                        raise AssertionError(
                            f"phase 19 (c) {route}: answer {got[:200]!r} "
                            f"!= the single-device engine's {w[:200]!r}")
                    if per[-1]["edges"] != we:
                        raise AssertionError(
                            f"phase 19 (c) {route}: {per[-1]['edges']} "
                            f"edges, cpu_recurse counts {we}")
        finally:
            recurse.MESH_CHAIN_HOPS = True
        mesh_routes_ok(eng, f"(c) {route}")
        c[route] = {"queries": per, "programs": dict(PROGRAM_CALLS)}
    if not c["chain"]["programs"].get("chain_hop") or \
            not c["fused"]["programs"].get("recurse_fused_matrix"):
        raise AssertionError(f"phase 19 (c): routes not taken {c}")
    out["c_recurse"] = {"seconds": time.perf_counter() - t0,
                        "roots": int(sum(len(r) for r in roots)),
                        "depth": MESH_RECURSE_DEPTH, "cpu_edges": want_edges,
                        **c}
    # (e) the sharded bitmap traversal against make_ell_recurse
    t0 = time.perf_counter()
    seeds = make_seeds(n, MESH_LANES, seed=MESH_LANE_SEED)
    src_s, dst_s, deg_s, rows = dbfs.shard_coo_by_src(rel.indptr,
                                                      rel.indices,
                                                      MESH_SHARDS)
    mask0 = bfs.ranks_to_bitmap(seeds, n)
    slabs = dbfs.shard_mask(mask0, MESH_SHARDS, rows)
    PROGRAM_CALLS.clear()
    with reshard_guard():
        last_s, seen_s, edges_r = dbfs.bitmap_recurse_sharded(
            mesh, src_s, dst_s, deg_s, slabs, MESH_DEPTH)
    calls = dict(PROGRAM_CALLS)
    on_card = tape.on_card
    seen_d = torch.cat(seen_s.parts)[:n]
    edges_mesh = host_np(edges_r).astype(np.int64)
    g, dev = _dev_for(store, "follows", False, device)
    W = MESH_LANES // 32
    for k in HOP:
        HOP[k] = 0
    fn = bfs.make_ell_recurse(dev, g.outdeg, g.n, W, count_edges=False)
    last, seen, _ = fn(bfs.put_mask(bfs.pack_seed_masks(g, seeds), device),
                       MESH_DEPTH)
    hop_launches = dict(HOP)
    ell_edges = bfs.make_ell_count(g.outdeg, g.n, device)(
        last, seen).cpu().numpy()
    shifts = torch.arange(32, dtype=torch.int32, device=seen.device)
    bits = ((seen[:g.n, :, None] >> shifts) & 1).reshape(g.n, MESH_LANES)
    new_of_old = torch.from_numpy(np.asarray(g.new_of_old, np.int64)).to(
        seen.device)
    ell_seen = bits[new_of_old].to(torch.int8)
    host_seen = seen[:g.n].cpu().numpy().view(np.uint32)
    for q in (0, MESH_LANES - 1):     # the unpacking against the host's
        got = np.nonzero(ell_seen[:, q].cpu().numpy())[0]
        rows_q = np.nonzero((host_seen[:, q // 32] >> np.uint32(q % 32))
                            & np.uint32(1))[0]
        if not np.array_equal(got, np.sort(g.perm_order[rows_q])):
            raise AssertionError(f"phase 19 (e): lane {q} unpacked wrong")
    same = bool(torch.equal(ell_seen, seen_d.to(ell_seen.device)))
    if not same:
        bad = int((ell_seen != seen_d).any(0).sum())
        raise AssertionError(f"phase 19 (e): {bad} lanes' visited sets "
                             f"differ from make_ell_recurse's")
    if not np.array_equal(edges_mesh, ell_edges.astype(np.int64)):
        raise AssertionError("phase 19 (e): per-lane edges differ from "
                             "make_ell_count's")
    e = {"seconds": time.perf_counter() - t0, "lanes": MESH_LANES,
         "depth": MESH_DEPTH, "rows_per_shard": rows,
         "edge_cap_per_shard": int(src_s.shape[1]),
         "visited_total": int(seen_d.to(torch.int64).sum()),
         "edges_total": int(edges_mesh.sum()), "programs": calls,
         "bucket_hop_launches": hop_launches.get("bucket_hop", 0),
         "partials_bytes": MESH_SHARDS * rows * MESH_SHARDS * MESH_LANES}
    del seen_d, last_s, seen_s, ell_seen, bits
    if on_card:
        # the whole call on the four shards and on ONE shard of the card
        # (the single-device form of the same program)
        from dgraph_tpu_torch.parallel.mesh import make_mesh
        ms = cuda_ms(lambda _x: dbfs.bitmap_recurse_sharded(
            mesh, src_s, dst_s, deg_s, slabs, MESH_DEPTH), 1)
        one = make_mesh(devices=[torch.device(device, 0)])
        s1, d1, g1, r1 = dbfs.shard_coo_by_src(rel.indptr, rel.indices, 1)
        m1 = dbfs.shard_mask(mask0, 1, r1)
        ms1 = cuda_ms(lambda _x: dbfs.bitmap_recurse_sharded(
            one, s1, d1, g1, m1, MESH_DEPTH), 1)
        nb = (8 * rel.nnz + 4 * n + 3 * n * MESH_LANES + 4 * MESH_LANES)
        e["timing"] = {"mesh_ms": ms[0], "single_ms": ms1[0],
                       "least_bytes": nb,
                       "bound_ms": nb / HBM_BYTES_PER_S * 1e3}
        del s1, d1, g1, m1
    out["e_bitmap"] = e
    if reshard_count() != r0:
        raise AssertionError("phase 19 (c)/(e): reshards counted")
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def ldbc_mesh_queries(g) -> dict:
    """(a)'s extra orderings: a root `orderasc` + `first:` (mesh_topk)
    and a child-level `orderdesc` (mesh_row_sort)."""
    p = hex(int(g.person_uids[len(g.person_uids) // 3]))
    return {
        "topk": '{ q(func: has(first_name), orderasc: birthday_year, '
                'first: 25) { uid first_name birthday_year } }',
        "row_sort": '{ q(func: uid(%s)) { knows (orderdesc: birthday_year) '
                    '{ uid birthday_year } } }' % p,
    }


RING_QUERY = ('{ var(func: has(has_creator)) '
              '{ c as has_creator (orderasc: first_name) } '
              'q(func: uid(c), orderasc: first_name, first: 20) '
              '{ uid first_name } n(func: uid(c)) { count(uid) } }')


def phase_mesh_ldbc(device, built: dict, mesh, tape: ProgramTape,
                    answers: dict | None = None) -> dict:
    """Phase 19 (a), (b) and (f) on phase 6's SF1 store; the mesh's
    answers of (a) and (b) go to `answers` (phase 20 holds its processes
    to them)."""
    from dgraph_tpu_torch.engine import Engine
    from dgraph_tpu_torch.engine.execute import Executor
    from dgraph_tpu_torch.models import ldbc
    from dgraph_tpu_torch.parallel.mesh import (PROGRAM_CALLS, reshard_count,
                                                reshard_guard)

    g, store = built["g"], built["store"]
    out: dict = {}
    r0 = reshard_count()
    # (a) the IC mix and config 3, per query, and the two orderings
    t0 = time.perf_counter()
    queries = dict(ldbc.ic_templates(g))
    queries["config3"] = ldbc.config3_query(g)
    want = dict(built["ldbc_bytes"])
    extra = ldbc_mesh_queries(g)
    host = Engine(store, device="cpu", device_threshold=HOST_ONLY)
    with fusion(False):     # the pure numpy route
        want.update({k: host.query_bytes(q) for k, q in extra.items()})
    PROGRAM_CALLS.clear()
    knn0, feat0 = route_set("knn_route_total"), route_set("feat_route_total")
    eng = Engine(store, device=device, device_threshold=0, mesh=mesh)
    per = {}
    with reshard_guard():
        for k, q in {**queries, **extra}.items():
            before = dict(eng.routes.expansions)
            t1 = time.perf_counter()
            got = eng.query_bytes(q)
            per[k] = {"ms": (time.perf_counter() - t1) * 1e3,
                      "routes": {r: v - before[r]
                                 for r, v in eng.routes.expansions.items()
                                 if v - before[r]}}
            if answers is not None:
                answers.setdefault("a", {})[k] = got.decode()
            if got != want[k]:
                raise AssertionError(f"phase 19 (a) {k}: the mesh engine's "
                                     f"answer differs from the single-device"
                                     f" engine's")
    mesh_routes_ok(eng, "(a)")
    calls = dict(PROGRAM_CALLS)
    for name in ("mesh_topk", "mesh_row_sort", "matrix_hop", "matrix_level",
                 "chain_hop"):
        if not calls.get(name):
            raise AssertionError(f"phase 19 (a): {name} never ran ({calls})")
    if route_set("knn_route_total") != knn0 or \
            route_set("feat_route_total") != feat0:
        raise AssertionError("phase 19 (a): a knn or feat route ran")
    out["a_ic_mix"] = {"seconds": time.perf_counter() - t0,
                       "per_query": per, "programs": calls,
                       "routes": {"expansions": dict(eng.routes.expansions),
                                  "edges": dict(eng.routes.edges),
                                  "least_bytes": dict(eng.routes.least_bytes)}}
    # (b) a frontier past ring_threshold: ~1M messages over has_creator
    t0 = time.perf_counter()
    with fusion(False):
        want_ring = Engine(store, device=device,
                           device_threshold=LDBC_THRESHOLD).query_bytes(
            RING_QUERY)
    PROGRAM_CALLS.clear()
    ring_eng = Engine(store, device=device, device_threshold=0, mesh=mesh)
    with reshard_guard():
        t1 = time.perf_counter()
        got = ring_eng.query_bytes(RING_QUERY)
        ring_ms = (time.perf_counter() - t1) * 1e3
    calls = dict(PROGRAM_CALLS)
    if answers is not None:
        answers["b"] = got.decode()
    if got != want_ring:
        raise AssertionError("phase 19 (b): the ring route's answer differs "
                             "from the single-device route's")
    if not calls.get("ring_matrix_hop") or not calls.get("mesh_row_sort"):
        raise AssertionError(f"phase 19 (b): the ring did not run ({calls})")
    mesh_routes_ok(ring_eng, "(b)")
    # the ring's edge matrix itself against the single-device gather
    frontier = store.has_ranks("has_creator")
    ex = Executor(store, device=device, device_threshold=0, mesh=mesh)
    single = Executor(store, device=device, device_threshold=0)
    with reshard_guard():
        ring = ex._expand_mesh("has_creator", False, frontier)
    flat = single._expand_device("has_creator", False, frontier)
    for x, y, what in zip(ring, flat, ("nbrs", "seg", "pos")):
        if not np.array_equal(np.asarray(x), np.asarray(y)):
            raise AssertionError(f"phase 19 (b): the ring's {what} differ "
                                 f"from the single-device gather")
    out["b_ring"] = {"seconds": time.perf_counter() - t0,
                     "frontier": int(len(frontier)),
                     "ring_threshold": Executor.ring_threshold,
                     "edges": int(len(ring[0])), "query_ms": ring_ms,
                     "programs": calls}
    if reshard_count() != r0:
        raise AssertionError("phase 19 (a)/(b): reshards counted")
    out["f_alpha"] = mesh_alpha_http(device, g, store, mesh, built)
    return out


def mesh_alpha_http(device, g, store, mesh, built: dict) -> dict:
    """Phase 19 (f): an Alpha on the mesh over HTTP, then the same
    requests under a device budget that evicts `store.sharded`."""
    from dgraph_tpu_torch.models import ldbc
    from dgraph_tpu_torch.server.api import Alpha
    from dgraph_tpu_torch.server.http import make_http_server, serve_background
    from dgraph_tpu_torch.utils import memgov
    from dgraph_tpu_torch.utils.metrics import METRICS

    t0 = time.perf_counter()
    queries = dict(ldbc.ic_templates(g))
    queries["config3"] = ldbc.config3_query(g)
    names = MESH_HTTP_TEMPLATES
    a = Alpha(base=store, device=device, device_threshold=0, mesh=mesh)
    srv = make_http_server(a, "127.0.0.1", 0)
    serve_background(srv)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    res: dict = {}
    try:
        def serve(tag):
            lat = {}
            for k in names:
                t1 = time.perf_counter()
                status, _h, body = http(base, "/query", queries[k])
                lat[k] = (time.perf_counter() - t1) * 1e3
                if status != 200 or data_bytes(body) != \
                        built["ldbc_bytes"][k]:
                    raise AssertionError(f"phase 19 (f) {tag} {k}: status "
                                         f"{status}, answer differs")
            return lat

        res["served_ms"] = serve("served")
        status, _h, body = http(base, "/debug/scheduler")
        doc = json.loads(body)
        cost = (doc.get("mesh") or {}).get("shard_cost_us")
        if status != 200 or not cost or not sum(cost.values()):
            raise AssertionError("phase 19 (f): /debug/scheduler shows no "
                                 "mesh.shard_cost_us")
        res["shard_cost_us"] = cost
        ev0 = memgov.GOVERNOR.status()["caches"]["store.sharded"]["evictions"]
        rp0 = METRICS.get("cache_replacements_total", cache="store.sharded")
        resident = memgov.GOVERNOR.status()["caches"]["store.sharded"][
            "bytes"]
        # a budget under the sharded tablets' own bytes: placing one
        # evicts another
        budget = max(resident // 2, 1)
        was = (memgov.GOVERNOR.budget("device"),
               memgov.GOVERNOR.budget("host"))
        memgov.GOVERNOR.set_budgets(device_bytes=budget, host_bytes=was[1])
        try:
            memgov.GOVERNOR.maybe_evict("device")
            res["budget_ms"] = serve("under budget")
        finally:
            memgov.GOVERNOR.set_budgets(*was)
        st = memgov.GOVERNOR.status()["caches"]["store.sharded"]
        res["budget"] = {"device_bytes": budget,
                         "sharded_bytes_before": resident,
                         "evictions": st["evictions"] - ev0,
                         "replacements": METRICS.get(
                             "cache_replacements_total",
                             cache="store.sharded") - rp0}
        if res["budget"]["evictions"] < 1 or res["budget"]["replacements"] < 1:
            raise AssertionError(f"phase 19 (f): no store.sharded tablet "
                                 f"evicted and placed again {res['budget']}")
    finally:
        srv.shutdown()
        srv.server_close()
    res["seconds"] = time.perf_counter() - t0
    return res


MESH_CLI_SCHEMA = "name: string @index(exact) .\nfriend: [uid] @reverse ."
MESH_CLI_RDF = "\n".join(
    f'_:p{i} <name> "p{i}" .\n_:p{i} <friend> _:p{(i * 7 + 3) % 40} .'
    for i in range(40))
MESH_CLI_Q = '{ q(func: eq(name, "p1")) { name friend { name friend { name } } } }'

XMESH_PROCESSES = 2             # phase 20: ranks, each with ...
XMESH_LOCAL_SHARDS = 2          # ... this many shards of card 0
XMESH_TIMEOUT_S = 300           # the process group's timeout
XMESH_CHILD_S = 600             # a child's whole run
XMESH_SLAB_FRONTIER = 4096      # (b) message rows drawn for the hop
XMESH_SLAB_SEED = 29
XMESH_ADMIT_TEMPLATE = "IC2"    # (e1) the request shed and served
XMESH_PROMOTE_TEMPLATE = "config3"   # (e3) 3 filtered hops from a city
XMESH_E_LIMIT_S = 15.0          # (e) the most it may add to phase 20
XMESH_F_LIMIT_S = 10.0          # (f) the most it may add to phase 20
XMESH_F_REQUEST_S = 5.0         # (f1), (f2) the longest a request may take
XMESH_F_BUDGET_MS = 1e-3        # (f3) rank 1's budget: out at once
XMESH_F_ROUNDS = 200            # (f4) status rounds timed back to back
XMESH_MESH_ROUTES = ("mesh", "numpy", "device", "empty", "fused", "chain")
XMESH_CLI_INFLIGHT = 2          # (c) --max_inflight and --queue_depth

# phase 20 (a, b), one rank: argv spec.json rank
XMESH_CHILD = r"""
import json, os, sys, time
spec = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
sys.path.insert(0, spec["root"])
t_start = time.perf_counter()
import numpy as np
import torch
import chip_smoke as cs
from dgraph_tpu_torch.parallel import mesh as M
device = spec["device"]
if spec["nccl"]:
    os.environ["LOCAL_RANK"] = str(rank)
M.init_distributed(spec["coordinator"], spec["processes"], rank)
mesh = M.make_mesh(device=device)
if mesh.backend != spec["backend"] or not mesh.spans_processes:
    raise AssertionError(f"mesh {mesh!r}, not over {spec['backend']}")
out = {"rank": rank, "mesh": repr(mesh), "backend": mesh.backend,
       "local": list(mesh.local), "boot_s": time.perf_counter() - t_start}
from dgraph_tpu_torch.engine import Engine
from dgraph_tpu_torch.models import ldbc
from dgraph_tpu_torch.ops.feat import LAUNCHES as COMBINE
from dgraph_tpu_torch.tools import graphrag_mix
t0 = time.perf_counter()
g = ldbc.generate(sf=spec["sf"], seed=cs.LDBC_SEED)
store, _emb = cs.build_graphrag_store(g)
out["build_s"] = time.perf_counter() - t0
if spec.get("ring_threshold"):
    from dgraph_tpu_torch.engine.execute import Executor
    Executor.ring_threshold = spec["ring_threshold"]
want = json.load(open(spec["answers"]))
queries = dict(ldbc.ic_templates(g))
queries["config3"] = ldbc.config3_query(g)
queries.update(cs.ldbc_mesh_queries(g))
parts = {"a": queries}
if "b" in spec["parts"]:
    parts["b"] = {"ring": cs.RING_QUERY}
if "d" in spec["parts"]:
    parts["d"] = graphrag_mix.templates(g)
tape = cs.ProgramTape(device)
M.PROGRAM_CALLS.clear()
for k in COMBINE:
    COMBINE[k] = 0
knn0 = cs.route_set("knn_route_total")
feat0 = cs.route_set("feat_route_total")
r0 = M.reshard_count()
per, seconds, progs = {}, {}, {}
rounds = []             # (f4) seconds of each status round, this rank
plain_round = M._round

def timed_round(*args, **kw):
    t1 = time.perf_counter()
    try:
        return plain_round(*args, **kw)
    finally:
        rounds.append(time.perf_counter() - t1)

M._round = timed_round
status0 = M.CROSS_CALLS.get("status", 0)
with tape.armed(), M.reshard_guard():
    for part, qs in parts.items():
        t0 = time.perf_counter()
        eng = Engine(store, device=device, device_threshold=0, mesh=mesh)
        for k, q in qs.items():
            t1 = time.perf_counter()
            p0 = dict(M.PROGRAM_CALLS)
            got = eng.query_bytes(q).decode()
            per[f"{part}:{k}"] = (time.perf_counter() - t1) * 1e3
            progs[f"{part}:{k}"] = {n: c - p0.get(n, 0) for n, c in
                                    M.PROGRAM_CALLS.items()
                                    if c != p0.get(n, 0)}
            exp = want["b"] if part == "b" else want[part][k]
            if got != exp:
                raise AssertionError(f"phase 20 ({part}) {k}: rank {rank}'s "
                                     f"answer differs from phase 19's")
        cs.mesh_routes_ok(eng, f"({part}) across processes")
        seconds[part] = time.perf_counter() - t0
M._round = plain_round
calls = dict(M.PROGRAM_CALLS)
launches = dict(COMBINE)
us = sorted(x * 1e6 for x in rounds)
status = M.CROSS_CALLS.get("status", 0) - status0
out["f_rounds"] = {
    "status_rounds": status, "program_calls": sum(calls.values()),
    "rounds_per_program_call": status / max(sum(calls.values()), 1),
    "round_us_p50": us[len(us) // 2] if us else None,
    "round_us_max": us[-1] if us else None}
knn = {r: v - knn0[r] for r, v in cs.route_set("knn_route_total").items()}
feat = {r: v - feat0[r] for r, v in cs.route_set("feat_route_total").items()}
on_card = torch.device(device).type == "cuda"
if "d" in parts and ((on_card and not launches.get("segment_combine"))
                     or not knn["mesh"] or not feat["mesh"]):
    raise AssertionError(f"phase 20: segment_combine {launches}, knn "
                         f"{knn}, feat {feat}")
if any(knn[r] or feat[r] for r in ("host", "device", "fused")):
    raise AssertionError(f"phase 20: knn {knn}, feat {feat} off the mesh")
if M.reshard_count() != r0:
    raise AssertionError("phase 20: reshards counted")
cs.no_oom(f"phase 20 rank {rank}")
out.update(seconds=seconds, per_query_ms=per, programs=calls,
           segment_combine_launches=launches.get("segment_combine", 0),
           knn_routes=knn, feat_routes=feat, tape=tape.summary(),
           cross_calls=dict(M.CROSS_CALLS))
if "e" in spec["parts"]:
    # (e) an Alpha on each rank over the mesh: the lead (rank 0) decides
    # admission, lane groups and route promotions, every rank follows
    import threading
    from dgraph_tpu_torch.dql.parser import parse
    from dgraph_tpu_torch.engine import batch as B
    from dgraph_tpu_torch.engine.treebatch import plan_tree
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES as HOPS
    from dgraph_tpu_torch.server.admission import ServerOverloaded
    from dgraph_tpu_torch.server.api import Alpha
    from dgraph_tpu_torch.utils import costprior
    from dgraph_tpu_torch.utils.metrics import METRICS
    t_e = time.perf_counter()
    agreed = []         # seconds of each agreement, this rank
    plain_agree = M.agree

    def timed_agree(*args, **kw):
        t1 = time.perf_counter()
        try:
            return plain_agree(*args, **kw)
        finally:
            agreed.append(time.perf_counter() - t1)

    M.agree = timed_agree
    a = Alpha(base=store, device=device, device_threshold=0, mesh=mesh)
    a.attach_admission(1, 0)
    asked = [0]

    def ask(q):
        asked[0] += 1
        try:
            return {"served": a.query_raw(q).decode()}
        except ServerOverloaded as err:
            return {"shed": err.reason, "retry_after_s": err.retry_after_s}

    def hold():
        # a local request holds this rank's read token until released
        got, done = threading.Event(), threading.Event()

        def run():
            with a.admission.admit("read"):
                got.set()
                done.wait(cs.XMESH_TIMEOUT_S)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        if not got.wait(60):
            raise AssertionError("phase 20 (e1): no local token")

        def release():
            done.set()
            t.join(60)
        return release

    # (e1) one token, no queue, the lead's or the follower's token held
    e1 = {}
    k1 = cs.XMESH_ADMIT_TEMPLATE
    for step, holder in (("held_0", 0), ("free", None), ("held_1", 1)):
        release = hold() if rank == holder else None
        e1[step] = ask(queries[k1])
        if release is not None:
            release()
    if e1["held_0"].get("shed") != "queue_full":
        raise AssertionError(f"phase 20 (e1): rank {rank} not shed with "
                             f"rank 0's token held: {str(e1['held_0'])[:200]}")
    for step in ("free", "held_1"):
        if e1[step].get("served") != want["a"][k1]:
            raise AssertionError(f"phase 20 (e1) {step}: rank {rank} shed "
                                 f"or answered other than phase 19")
        e1[step] = "served"
    e1["lane"] = {k: v for k, v in a.admission.status()["lanes"][
        "read"].items() if k in ("admitted_total", "shed_total")}
    # (e2) a tree group of one query: rank 0's prior alone calls it worth
    # a lane kernel
    def lane_shape(q):
        blocks = parse(q)
        if B._eligible(store, blocks) or B._eligible_shortest(store,
                                                             blocks):
            return None
        tp = plan_tree(store, blocks)
        return None if tp is None else B._plan_shape(tp[1])

    k2 = next(k for k in sorted(parts["a"]) if lane_shape(queries[k]))
    shape = lane_shape(queries[k2])
    if rank == 0:
        for _ in range(costprior.PRIORS.sample_floor):
            costprior.PRIORS.learn("read", None, shape,
                                   2 * B.KERNEL_WORTH_US)
    e2 = {"template": k2, "shape": shape,
          "own_worth": B._kernel_worth(shape, 1)}
    g0 = METRICS.get("kernel_group_launches_total", family="tree")
    HOPS["bucket_hop"] = 0
    got = a.query_batch([queries[k2]])
    e2["bucket_hop_launches"] = HOPS["bucket_hop"]
    e2["groups"] = METRICS.get("kernel_group_launches_total",
                               family="tree") - g0
    if json.dumps(got[0], sort_keys=True) != json.dumps(
            json.loads(want["a"][k2]), sort_keys=True):
        raise AssertionError(f"phase 20 (e2) {k2}: rank {rank}'s lane "
                             f"group answers other than phase 19")
    if e2["groups"] < 1 or (torch.device(device).type == "cuda"
                            and e2["bucket_hop_launches"] < 1):
        raise AssertionError(f"phase 20 (e2): rank {rank} ran no lane "
                             f"group: {e2}")
    # (e3) a threshold no frontier reaches; rank 0's route EMAs promote
    # the mesh, rank 1's the host walk
    a.device_threshold = cs.HOST_ONLY
    fast, slow = ("mesh", "numpy") if rank == 0 else ("numpy", "mesh")
    for _ in range(64):
        costprior.PRIORS.learn_route(fast, 1.0)
        costprior.PRIORS.learn_route(slow, 1000.0)
    k3 = cs.XMESH_PROMOTE_TEMPLATE
    e3 = {"template": k3,
          "own_promotion": costprior.promoted("mesh", "numpy")}
    r0 = {r: METRICS.get("mesh_route_total", route=r)
          for r in cs.XMESH_MESH_ROUTES}
    got = ask(queries[k3])
    e3["routes"] = {r: METRICS.get("mesh_route_total", route=r) - r0[r]
                    for r in cs.XMESH_MESH_ROUTES}
    if got.get("served") != want["a"][k3] or e3["routes"]["mesh"] < 1:
        raise AssertionError(f"phase 20 (e3) {k3}: rank {rank}'s routes "
                             f"{e3['routes']}, answer equal to phase 19: "
                             f"{got.get('served') == want['a'][k3]}")
    M.agree = plain_agree
    us = sorted(x * 1e6 for x in agreed)
    requests = asked[0] + 1       # the asks and the batch
    out["e_follow"] = {
        "seconds": time.perf_counter() - t_e, "e1": e1, "e2": e2, "e3": e3,
        "requests": requests, "agree_calls": len(us),
        "agree_per_request": len(us) / requests,
        "agree_us_per_request": sum(us) / requests,
        "agree_us_p50": us[len(us) // 2], "agree_us_max": us[-1],
        "cross_calls_agree": M.CROSS_CALLS.get("agree", 0)}
if "f" in spec["parts"]:
    # (f) failures every rank sees, on (e)'s Alpha at threshold 0: rank 1
    # alone fails, and both ranks take the same path
    from dgraph_tpu_torch.utils import memgov
    t_f = time.perf_counter()
    a.device_threshold = 0
    tries = [0]         # launches at the armed site, this rank

    def arm(site, n):
        left = [n if rank == 1 else 0]
        tries[0] = 0

        def hook(at):
            if at != site:
                return False
            tries[0] += 1
            if left[0]:
                left[0] -= 1
                return True
            return False
        memgov.set_alloc_fault(hook)

    def timed(run):
        t1 = time.perf_counter()
        try:
            got = {"served": run()}
        except Exception as err:
            agreed = M.failure_of(err)
            got = {"raised": type(err).__name__,
                   "stage": getattr(err, "stage", None),
                   "agreed": None if agreed is None else agreed.kind,
                   "message": str(err)[:300]}
        memgov.set_alloc_fault(None)
        got["s"] = time.perf_counter() - t1
        return got

    def first_with(part, program):
        return next(k for k in sorted(parts[part])
                    if progs[f"{part}:{k}"].get(program))

    def served_again(k):
        got = timed(lambda: a.query_raw(queries[k]).decode())
        if got.get("served") != want["a"][k]:
            raise AssertionError(f"phase 20 (f): rank {rank} did not serve "
                                 f"{k} as phase 19 did after a failure")
        return got["s"]

    def oom(site):
        return METRICS.get("oom_events_total", site=site)

    # (f1) one allocation failure on rank 1 at mesh.matrix_hop
    k1 = first_with("a", "matrix_hop")
    e0 = oom("mesh.matrix_hop")
    arm("mesh.matrix_hop", 1)
    f1 = timed(lambda: a.query_raw(queries[k1]).decode())
    f1.update(template=k1, launches=tries[0],
              plain_launches=progs[f"a:{k1}"]["matrix_hop"],
              oom_events=oom("mesh.matrix_hop") - e0)
    if f1.get("served") != want["a"][k1]:
        raise AssertionError(f"phase 20 (f1) {k1}: rank {rank} "
                             f"{str(f1)[:400]}")
    f1["served"] = "equal to phase 19"
    # (f2) two in a row on rank 1 at feat.agg over feat_mesh
    k2 = first_with("d", "feat_mesh")
    for k in COMBINE:
        COMBINE[k] = 0
    arm("feat.agg", 2)
    f2 = timed(lambda: a.query_raw(parts["d"][k2]).decode())
    f2.update(template=k2, launches=tries[0],
              segment_combine_launches=COMBINE.get("segment_combine", 0),
              next_s=served_again(k1))
    # (f3) a budget that runs out on rank 1 only
    f3 = timed(lambda: a.query_raw(
        queries[k1], deadline_ms=cs.XMESH_F_BUDGET_MS if rank == 1
        else None).decode())
    f3.update(template=k1, next_s=served_again(k1))
    # (f4) status rounds back to back, no work between them: what a
    # round costs when no rank waits for another
    b2b = []
    with M.lockstep(mesh, "f4"):
        frame = M._FRAME.get()
        for _ in range(cs.XMESH_F_ROUNDS):
            t1 = time.perf_counter()
            M._round(frame, "f4")
            b2b.append((time.perf_counter() - t1) * 1e6)
    b2b.sort()
    out["f_fail"] = {"seconds": time.perf_counter() - t_f, "f1": f1,
                     "f2": f2, "f3": f3,
                     "back_to_back_us_p50": b2b[len(b2b) // 2],
                     "back_to_back_us_p90": b2b[len(b2b) * 9 // 10]}
if "slabs" in spec["parts"]:
    # (b) this rank materialises only its own shards' slabs of
    # has_creator; assemble_sharded_rel agrees the rest with one gather
    from dgraph_tpu_torch.parallel.dhop import matrix_hop
    from dgraph_tpu_torch.parallel.pshard import assemble_sharded_rel
    t0 = time.perf_counter()
    rel = store.rel("has_creator")
    n = rel.indptr.shape[0] - 1
    rows = -(-n // mesh.size)
    local = {}
    for d in mesh.local:
        lo, hi = min(d * rows, n), min(d * rows + rows, n)
        ptr = rel.indptr[lo:hi + 1].astype(np.int64)
        base = int(ptr[0])
        lp = (ptr - base).astype(np.int32)
        lp = np.concatenate([lp, np.full(rows - (hi - lo), lp[-1],
                                         np.int32)])
        local[d] = (lp, rel.indices[base:base + int(lp[-1])])
    c0 = dict(M.CROSS_CALLS)
    srel = assemble_sharded_rel(mesh, n, local)
    if M.CROSS_CALLS.get("nnz", 0) != c0.get("nnz", 0) + 1:
        raise AssertionError("phase 20 (b): no nnz agreement")
    rng = np.random.default_rng(cs.XMESH_SLAB_SEED)
    cand = np.unique(rng.integers(0, n, cs.XMESH_SLAB_FRONTIER))
    fr = cand[rel.indptr[cand + 1] > rel.indptr[cand]].astype(np.int32)
    owners = set((fr // rows).tolist())
    if not {mesh.ranks[d] for d in owners} >= set(mesh.owners):
        raise AssertionError("phase 20 (b): the frontier misses a rank")
    deg = (rel.indptr[fr + 1] - rel.indptr[fr]).astype(np.int64)
    cap = 64
    while cap < max(int(deg.sum()), 1):
        cap <<= 1
    pad = np.full(cap, cs._SENT, np.int32)
    pad[:len(fr)] = fr
    t1 = time.perf_counter()
    nbrs_s, seg_s, _pos, totals, max_e = matrix_hop(mesh, srel, pad, cap)
    nb, sg, tot = M.host_np(nbrs_s), M.host_np(seg_s), M.host_np(totals)
    hop_ms = (time.perf_counter() - t1) * 1e3
    if int(M.host_np(max_e)) > cap:
        raise AssertionError("phase 20 (b): past the edge cap")
    got = np.concatenate([np.stack([sg[d, :int(tot[d])], nb[d, :int(tot[d])]])
                          for d in range(mesh.size)], axis=1)
    got = got[:, np.lexsort((got[1], got[0]))]
    seg = np.repeat(np.arange(len(fr)), deg)
    idx = np.concatenate([rel.indices[rel.indptr[f]:rel.indptr[f + 1]]
                          for f in fr])
    want_e = np.stack([seg, idx])
    want_e = want_e[:, np.lexsort((want_e[1], want_e[0]))]
    if not np.array_equal(got, want_e):
        raise AssertionError("phase 20 (b): the disjoint-slab hop's edges "
                             "differ from the CSR walk")
    out["b_slabs"] = {"seconds": time.perf_counter() - t0,
                      "frontier": int(len(fr)), "edges": int(deg.sum()),
                      "hop_ms": hop_ms,
                      "local_bytes": int(sum(p.nbytes + i.nbytes for p, i in
                                             local.values()))}
out["seconds_total"] = time.perf_counter() - t_start
# (f5) what the lead's decisions leave behind at the end of phase 20
out["f_store"] = {"store_keys": M._DECISIONS.num_keys(),
                  "occurrences": len(M._OCCURRENCES)}
M.shutdown_distributed()
print(json.dumps(out), flush=True)
"""


def xmesh_children(device, answers_path: str, tmp: str, parts,
                   nccl: bool = False, sf: float = LDBC_SF,
                   ring_threshold: int | None = None) -> list:
    """Run phase 20's two ranks (XMESH_CHILD) to their end; their JSON
    documents, or a failure with their output."""
    root = os.path.dirname(os.path.abspath(__file__))
    spec = {"root": root, "device": device, "answers": answers_path,
            "coordinator": f"127.0.0.1:{free_port()}",
            "processes": XMESH_PROCESSES, "sf": sf, "parts": list(parts),
            "local_shards": 1 if nccl else XMESH_LOCAL_SHARDS,
            "backend": "nccl" if nccl else "gloo", "nccl": nccl,
            "ring_threshold": ring_threshold}
    spec_path = os.path.join(tmp, "nccl.json" if nccl else "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, DGRAPH_TPU_DIST_TIMEOUT_S=str(XMESH_TIMEOUT_S),
               DGRAPH_TPU_LOCAL_SHARDS=str(spec["local_shards"]))
    logs, procs = [], []
    try:
        for r in range(XMESH_PROCESSES):
            logs.append(open(os.path.join(tmp, f"rank{r}{nccl:d}.log"),
                             "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", XMESH_CHILD, spec_path, str(r)],
                cwd=root, env=env, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + XMESH_CHILD_S
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    docs = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        try:
            doc = json.loads(text.strip().splitlines()[-1])
        except (IndexError, ValueError):
            doc = None
        if p.returncode != 0 or doc is None:
            raise AssertionError(f"phase 20: rank {r} exited "
                                 f"{p.returncode}: {text[-4000:]}")
        docs.append(doc)
    return docs


def xmesh_follow(docs: list, device) -> dict:
    """Phase 20 (e) across the ranks: (e1) the same verdicts with the
    lead's Retry-After, (e2) rank 0's prior alone calls the group worth
    and each rank launched it as a lane kernel, (e3) rank 0's EMAs alone
    promote the mesh and both ranks count the same routes; the agreement
    calls and seconds per request, and (e)'s seconds within
    XMESH_E_LIMIT_S."""
    es = [d["e_follow"] for d in docs]
    e1 = [e["e1"] for e in es]
    if e1[0]["held_0"] != e1[1]["held_0"]:
        raise AssertionError(f"phase 20 (e1): the ranks shed unlike: "
                             f"{[x['held_0'] for x in e1]}")
    e2 = [e["e2"] for e in es]
    if not e2[0]["own_worth"] or e2[1]["own_worth"] or \
            e2[0]["template"] != e2[1]["template"]:
        raise AssertionError(f"phase 20 (e2): priors {e2}")
    if torch.device(device).type == "cuda" and min(
            x["bucket_hop_launches"] for x in e2) < 1:
        raise AssertionError(f"phase 20 (e2): a rank launched no "
                             f"bucket_hop: {e2}")
    e3 = [e["e3"] for e in es]
    if not e3[0]["own_promotion"] or e3[1]["own_promotion"] or \
            e3[0]["routes"] != e3[1]["routes"]:
        raise AssertionError(f"phase 20 (e3): promotions and routes {e3}")
    for e in es:
        if e["agree_per_request"] > 2 or e["agree_calls"] < e["requests"]:
            raise AssertionError(f"phase 20 (e): {e['agree_calls']} "
                                 f"agreements for {e['requests']} requests")
    seconds = max(e["seconds"] for e in es)
    if seconds > XMESH_E_LIMIT_S:
        raise AssertionError(f"phase 20 (e): {seconds:.2f} s, past "
                             f"{XMESH_E_LIMIT_S} s")
    return {"added_s": seconds, "ranks": es}


def xmesh_failures(docs: list) -> dict:
    """Phase 20 (f) across the ranks: (f1) one allocation failure on rank
    1 at mesh.matrix_hop, retried by both (one launch more than phase 20
    (a)'s on each rank, the event counted on rank 1 alone, each request
    under XMESH_F_REQUEST_S); (f2) two in a row at feat.agg raise the
    same class on both within it; (f3) a budget out on rank 1 alone ends
    the request with DeadlineExceeded naming the same stage on both,
    within the budget plus 2 s; (f)'s seconds within XMESH_F_LIMIT_S;
    (f4) the status rounds per program call and a round's µs on the lead
    and on the follower, while serving and back to back; (f5) the
    decision store's keys and occurrence entries at the end of phase
    20."""
    fs = [d["f_fail"] for d in docs]
    f1 = [f["f1"] for f in fs]
    if [x["oom_events"] for x in f1] != [0, 1] or any(
            x["launches"] != x["plain_launches"] + 1
            or x["s"] > XMESH_F_REQUEST_S for x in f1):
        raise AssertionError(f"phase 20 (f1): {f1}")
    f2 = [f["f2"] for f in fs]
    if any(x.get("raised") != "AllocFault" or x["agreed"] != "alloc"
           or x["s"] > XMESH_F_REQUEST_S for x in f2):
        raise AssertionError(f"phase 20 (f2): {f2}")
    f3 = [f["f3"] for f in fs]
    if any(x.get("raised") != "DeadlineExceeded" or not x["stage"]
           or x["s"] > XMESH_F_BUDGET_MS / 1e3 + 2.0 for x in f3) or \
            f3[0]["stage"] != f3[1]["stage"]:
        raise AssertionError(f"phase 20 (f3): {f3}")
    seconds = max(f["seconds"] for f in fs)
    if seconds > XMESH_F_LIMIT_S:
        raise AssertionError(f"phase 20 (f): {seconds:.2f} s, past "
                             f"{XMESH_F_LIMIT_S} s")
    return {"added_s": seconds, "ranks": fs,
            "f4_rounds": [{**d["f_rounds"], **{
                k: d["f_fail"][k] for k in ("back_to_back_us_p50",
                                            "back_to_back_us_p90")}}
                for d in docs],
            "f5_store": [d["f_store"] for d in docs]}


def xmesh_program_rows(docs: list, rows19: dict) -> dict:
    """Per mesh program: each rank's calls and CUDA-event ms across
    processes beside phase 19's in-process calls and ms (per call)."""
    out = {}
    for name in MESH_PROGRAMS:
        ranks = [d["tape"].get(name) for d in docs]
        if not any(ranks):
            continue
        one = rows19.get(name, {})
        out[name] = {
            "calls": [r["calls"] if r else 0 for r in ranks],
            "ms_total": [r["ms_total"] if r else 0.0 for r in ranks],
            "ms_per_call": [r["ms_total"] / r["calls"] if r else None
                            for r in ranks],
            "bound_ms": ranks[0]["bound_ms"] if ranks[0] else None,
            "in_process_calls": one.get("calls"),
            "in_process_ms_per_call": (one["ms_total"] / one["calls"]
                                       if one.get("calls") else None)}
    return out


def mesh_cli_pair(device) -> dict:
    """Phase 20 (c): two `alpha --jax-coordinator` processes with
    admission control armed (`--max_inflight`, `--queue_depth`), each with
    XMESH_LOCAL_SHARDS shards of card 0 (two of the CPU in a rehearsal),
    one 4-shard mesh over gloo, on empty directories: the same alter and
    commit to both, one query to both at once, both answers equal to a
    plain CPU Alpha's, /debug/scheduler's `mesh.shard_cost_us` on each,
    exit 0 on SIGINT; then one process asking for one device more than
    the machine has exits non-zero, naming the count, before its
    directory exists."""
    import shutil
    import signal
    import tempfile
    import threading

    from dgraph_tpu_torch.engine import Engine
    from dgraph_tpu_torch.server.api import Alpha

    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="mesh_cli_")
    kids = _Children(tmp)
    out: dict = {"processes": XMESH_PROCESSES,
                 "local_shards": XMESH_LOCAL_SHARDS}
    names = [f"alpha{r}" for r in range(XMESH_PROCESSES)]
    try:
        coord = f"127.0.0.1:{free_port()}"
        hports = [free_port() for _ in names]
        on_cpu = [] if on_card else ["--device", "cpu"]
        for r, name in enumerate(names):
            kids.start(name, "alpha", *on_cpu, "--p", os.path.join(tmp, name),
                       "--http_port", str(hports[r]),
                       "--grpc_port", str(free_port()),
                       "--jax-coordinator", coord, "--mesh-devices", "-1",
                       "--store", "device_threshold=0",
                       "--max_inflight", str(XMESH_CLI_INFLIGHT),
                       "--queue_depth", str(XMESH_CLI_INFLIGHT),
                       env=dict(os.environ,
                                JAX_NUM_PROCESSES=str(XMESH_PROCESSES),
                                JAX_PROCESS_ID=str(r),
                                DGRAPH_TPU_LOCAL_SHARDS=str(
                                    XMESH_LOCAL_SHARDS),
                                DGRAPH_TPU_DIST_TIMEOUT_S=str(
                                    XMESH_TIMEOUT_S)))
        bases = [f"http://127.0.0.1:{p}" for p in hports]
        out["boot_s"] = max(wait_up(kids, name, base, phase="phase 20 (c)")
                            for name, base in zip(names, bases))
        st = [http(b, "/alter", MESH_CLI_SCHEMA)[0] for b in bases]
        st += [http(b, "/mutate?commitNow=true", MESH_CLI_RDF,
                    ctype="application/rdf")[0] for b in bases]
        got, lat = {}, {}

        def ask(r):
            t1 = time.perf_counter()
            got[r] = http(bases[r], "/query", MESH_CLI_Q)
            lat[r] = (time.perf_counter() - t1) * 1e3

        threads = [threading.Thread(target=ask, args=(r,))
                   for r in range(XMESH_PROCESSES)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(CLI_SIGINT_S)
        out["query_ms"] = [lat.get(r) for r in range(XMESH_PROCESSES)]
        plain = Alpha(device="cpu", device_threshold=HOST_ONLY)
        plain.alter(MESH_CLI_SCHEMA)
        plain.mutate(set_nquads=MESH_CLI_RDF)
        want = json.loads(Engine(plain.mvcc.read_view(
            plain.oracle.read_ts()), device="cpu").query_bytes(MESH_CLI_Q))
        costs = []
        for b in bases:
            s4, _h, sched = http(b, "/debug/scheduler")
            st.append(s4)
            costs.append((json.loads(sched).get("mesh") or {}).get(
                "shard_cost_us"))
        for r, name in enumerate(names):
            if r not in got or got[r][0] != 200 or \
                    json.loads(data_bytes(got[r][2])) != want:
                raise AssertionError(
                    f"phase 20 (c): {name}'s answer "
                    f"{got.get(r, (None, None, b''))[2][:300]!r}: "
                    f"{kids.log(name)[-2000:]}")
        if set(st) != {200} or not all(costs):
            raise AssertionError(f"phase 20 (c): statuses {st}, shard costs "
                                 f"{costs}")
        out["shard_cost_us"] = costs
        t0 = time.perf_counter()
        for name in names:
            kids.procs[name][0].send_signal(signal.SIGINT)
        rcs = [kids.procs[name][0].wait(timeout=CLI_SIGINT_S)
               for name in names]
        out["sigint_s"] = time.perf_counter() - t0
        for r, (name, rc) in enumerate(zip(names, rcs)):
            t = kids.log(name)
            if rc != 0 or "over gloo" not in t or \
                    f"process {r}/{XMESH_PROCESSES}" not in t or \
                    f"admission control armed: max_inflight=" \
                    f"{XMESH_CLI_INFLIGHT}" not in t:
                raise AssertionError(f"phase 20 (c): {name} exited {rc}: "
                                     f"{t[-2000:]}")
        out["backend"] = "gloo"
        if on_card:
            n = torch.cuda.device_count()
            wide = os.path.join(tmp, "wide")
            rc, _doc, txt = run_verb(out, "wide_s", "alpha", "--p", wide,
                                     "--mesh-devices", str(n + 1))
            if rc == 0 or f"asks for {n + 1} devices and this machine " \
                    f"has {n}" not in txt or os.path.exists(wide):
                raise AssertionError(f"phase 20 (c): --mesh-devices {n + 1} "
                                     f"exited {rc}: {txt}")
            out["wide_rc"] = rc
    finally:
        kids.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_mesh_processes(device, answers: dict, rows19: dict,
                         sf: float = LDBC_SF,
                         ring_threshold: int | None = None) -> dict:
    """Phase 20: a mesh across processes. (a, b) two ranks, each with two
    shards of card 0, one 4-shard mesh over gloo: each builds SF1 with
    the GraphRAG embeddings from phase 6's and 10's seeds and serves
    phase 19's (a) IC mix and orderings, (b) ring query and (d) nine
    GraphRAG templates at device_threshold 0, every answer byte-equal to
    phase 19's on the single-process 4-shard mesh, then a matrix_hop
    over has_creator slabs each rank alone holds (assemble_sharded_rel),
    its edges equal to the CSR walk, (e) an Alpha on each rank
    whose admission, lane groups and route promotions are the lead's
    (`xmesh_follow`), and (f) failures on rank 1 alone that both ranks
    retry or raise together (`xmesh_failures`); (c) the CLI pair,
    admission armed; (d) NCCL, one rank per card, where there are two
    cards."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="xmesh_")
    out: dict = {}
    try:
        path = os.path.join(tmp, "answers.json")
        with open(path, "w") as f:
            json.dump(answers, f)
        t0 = time.perf_counter()
        docs = xmesh_children(device, path, tmp,
                              ("a", "b", "d", "e", "f", "slabs"), sf=sf,
                              ring_threshold=ring_threshold)
        out["a_b_children_s"] = time.perf_counter() - t0
        out["e_follow"] = xmesh_follow(docs, device)
        out["f_fail"] = xmesh_failures(docs)
        for d in docs:
            if torch.device(device).type == "cuda" and \
                    d["segment_combine_launches"] < 1:
                raise AssertionError(f"phase 20: rank {d['rank']} launched "
                                     f"no segment_combine")
        out["ranks"] = [{k: d[k] for k in (
            "rank", "mesh", "backend", "local", "boot_s", "build_s",
            "seconds", "seconds_total", "programs",
            "segment_combine_launches", "knn_routes", "feat_routes",
            "cross_calls", "b_slabs")} for d in docs]
        out["per_query_ms"] = {k: [d["per_query_ms"][k] for d in docs]
                               for k in docs[0]["per_query_ms"]}
        out["programs"] = xmesh_program_rows(docs, rows19)
        t0 = time.perf_counter()
        out["c_cli"] = mesh_cli_pair(device)
        out["c_cli"]["seconds"] = time.perf_counter() - t0
        cards = torch.cuda.device_count() if \
            torch.device(device).type == "cuda" else 0
        if cards >= 2:
            t0 = time.perf_counter()
            nd = xmesh_children(device, path, tmp, ("a",), nccl=True, sf=sf,
                                ring_threshold=ring_threshold)
            out["nccl"] = {"seconds": time.perf_counter() - t0,
                           "per_query_ms": {k: [d["per_query_ms"][k]
                                                for d in nd]
                                            for k in nd[0]["per_query_ms"]},
                           "mesh": nd[0]["mesh"]}
        else:
            out["nccl"] = f"not run: {cards} card" + ("" if cards == 1
                                                      else "s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_mesh_graphrag(device, g, store, mesh, tape: ProgramTape,
                        answers: dict | None = None) -> dict:
    """Phase 19 (d) on phase 10's GraphRAG store: knn through knn_mesh and
    the @msgpass templates through feat_mesh; the mesh's answers go to
    `answers["d"]`."""
    from dgraph_tpu_torch.engine import Engine
    from dgraph_tpu_torch.ops.feat import LAUNCHES as COMBINE
    from dgraph_tpu_torch.parallel.mesh import (PROGRAM_CALLS, reshard_count,
                                                reshard_guard)
    from dgraph_tpu_torch.tools import graphrag_mix

    t0 = time.perf_counter()
    queries = graphrag_mix.templates(g)
    single = Engine(store, device=device, device_threshold=LDBC_THRESHOLD)
    want = {k: json.loads(single.query_bytes(q)) for k, q in queries.items()}
    exact = {"knn_hop", "knn_uid", "knn_recurse"}
    PROGRAM_CALLS.clear()
    for k in COMBINE:
        COMBINE[k] = 0
    knn0, feat0 = route_set("knn_route_total"), route_set("feat_route_total")
    r0 = reshard_count()
    eng = Engine(store, device=device, device_threshold=0, mesh=mesh)
    per = {}
    with reshard_guard():
        for k, q in queries.items():
            t1 = time.perf_counter()
            raw = eng.query_bytes(q)
            per[k] = {"ms": (time.perf_counter() - t1) * 1e3}
            got = json.loads(raw)
            if answers is not None:
                answers.setdefault("d", {})[k] = raw.decode()
            err = json_float_err(want[k], got, exact_floats=(
                k in exact or k.endswith("_max")))
            per[k]["max_rel_err"] = err
    launches = dict(COMBINE)
    calls = dict(PROGRAM_CALLS)
    mesh_routes_ok(eng, "(d)")
    knn = {r: v - knn0[r] for r, v in route_set("knn_route_total").items()}
    feat = {r: v - feat0[r] for r, v in route_set("feat_route_total").items()}
    if knn["mesh"] < 4 or any(knn[r] for r in ("host", "device", "fused")):
        raise AssertionError(f"phase 19 (d): knn routes {knn}")
    if feat["mesh"] < 5 or any(feat[r] for r in ("host", "device", "fused")):
        raise AssertionError(f"phase 19 (d): feat routes {feat}")
    if reshard_count() != r0:
        raise AssertionError("phase 19 (d): reshards counted")
    return {"seconds": time.perf_counter() - t0, "per_query": per,
            "programs": calls, "knn_routes": knn, "feat_routes": feat,
            "segment_combine_launches": launches.get("segment_combine", 0)}


def json_float_err(want, got, exact_floats: bool) -> float:
    """Hold a JSON answer against another: equal structure and values,
    floats exactly or to rtol=MESH_RTOL, atol=MESH_ATOL. Returns the
    largest relative float difference."""
    worst = [0.0]

    def walk(a, b, path):
        if isinstance(a, dict):
            if not isinstance(b, dict) or a.keys() != b.keys():
                raise AssertionError(f"phase 19 (d): keys differ at {path}")
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, list):
            if not isinstance(b, list) or len(a) != len(b):
                raise AssertionError(f"phase 19 (d): lengths differ at "
                                     f"{path}")
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        elif isinstance(a, float) and isinstance(b, (int, float)):
            diff = abs(a - b)
            worst[0] = max(worst[0], diff / max(abs(a), 1e-30))
            if exact_floats and a != b or \
                    diff > MESH_ATOL + MESH_RTOL * abs(a):
                raise AssertionError(f"phase 19 (d): {b} != {a} at {path}")
        elif a != b:
            raise AssertionError(f"phase 19 (d): {b!r} != {a!r} at {path}")

    walk(want, got, "")
    return worst[0]


def merge_calls(*parts) -> dict:
    """The mesh program calls of several main paths, summed."""
    out: dict = {}
    for p in parts:
        for k, v in p.items():
            out[k] = out.get(k, 0) + v
    return out


def check_mesh_routes(rows: dict) -> None:
    """Phase 19 as a whole: the matrix, level and chain routes counted in
    `mesh_route_total`, and every mesh program of the slice launched."""
    from dgraph_tpu_torch.utils.metrics import METRICS
    for route in ("mesh", "fused", "chain"):
        if not METRICS.get("mesh_route_total", route=route):
            raise AssertionError(f"phase 19: mesh_route_total{{route="
                                 f"{route!r}}} never counted")
    missing = [n for n in MESH_PROGRAMS if not rows.get(n, {}).get(
        "launches")]
    if missing:
        raise AssertionError(f"phase 19: programs never launched {missing}")


def _load_smoke(tree: str, name: str):
    """The `chip_smoke.py` of checkout `tree`, as module `name`."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(tree, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _xmesh_answers(device: str, sf: float, ring) -> dict:
    """Phase 19's answers at `sf`: its (a), (b) and (d) parts on this
    checkout's one-process mesh."""
    from dgraph_tpu_torch.engine import Engine
    from dgraph_tpu_torch.engine.execute import Executor
    from dgraph_tpu_torch.models import ldbc

    mesh, tape = card_mesh(device), ProgramTape(device)
    built = build_ldbc(sf)
    g = built["g"]
    queries = dict(ldbc.ic_templates(g))
    queries["config3"] = ldbc.config3_query(g)
    host = Engine(built["store"], device="cpu", device_threshold=HOST_ONLY)
    with fusion(False):
        built["ldbc_bytes"] = {k: host.query_bytes(q)
                               for k, q in queries.items()}
    answers: dict = {}
    if ring:
        Executor.ring_threshold = ring
    try:
        with tape.armed():
            phase_mesh_ldbc(device, built, mesh, tape, answers=answers)
            store = build_graphrag_store(g)[0]
            phase_mesh_graphrag(device, g, store, mesh, tape,
                                answers=answers)
    finally:
        Executor.ring_threshold = 1 << 17
    return answers


def xmesh_ab(argv) -> int:
    """Phase 20 from two checkouts on one card, in turns: builds phase
    19's answers once with this checkout (its one-process 4-shard mesh
    over LDBC SNB at `--sf` with the GraphRAG embeddings), then runs
    phase 20's two ranks (`xmesh_children`) from `OTHER`'s
    `chip_smoke.py` and from this one's, in the order other, this, this,
    other. Each run serves parts (a), (b), (d), (e) and the slab hop,
    plus (f) where its checkout has it, and must give phase 19's
    answers. `OTHER` is a checkout of another revision (`git archive`
    of it, unpacked). Prints per run each rank's seconds per part, each
    mesh program's CUDA-event ms per call (the wait in its scope's
    rounds included) and (f)'s figures; writes all of it to `--out`
    when given. `--device cpu` rehearses it on the CPU (its times mean
    nothing)."""
    import argparse
    import tempfile
    ap = argparse.ArgumentParser(prog="chip_smoke.py --xmesh-ab")
    ap.add_argument("other", help="a checkout of the revision to compare "
                                  "with")
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.device == "cpu":
        torch.cuda.synchronize = lambda *a, **k: None
        smi = "cpu"
    else:
        smi = phase_device()
    # the CPU rehearsal's sf 0.02 holds too few messages for the ring's
    # threshold: lower it as the rehearsal of the whole script does
    ring = 2000 if args.sf < 0.05 else None
    t0 = time.perf_counter()
    answers = _xmesh_answers(args.device, args.sf, ring)
    gc.collect()
    if args.device != "cpu":
        torch.cuda.empty_cache()
    print(f"phase 19 answers: {time.perf_counter() - t0:.1f} s", flush=True)
    tmp = tempfile.mkdtemp(prefix="xmesh_ab_")
    path = os.path.join(tmp, "answers.json")
    with open(path, "w") as f:
        json.dump(answers, f)
    trees = {"other": _load_smoke(os.path.abspath(args.other),
                                  "chip_smoke_other"),
             "this": sys.modules[__name__]}
    runs = []
    for name in ("other", "this", "this", "other"):
        mod = trees[name]
        failures = hasattr(mod, "xmesh_failures")
        parts = ("a", "b", "d", "e", "slabs") + (("f",) if failures else ())
        t0 = time.perf_counter()
        docs = mod.xmesh_children(args.device, path, tmp, parts, sf=args.sf,
                                  ring_threshold=ring)
        run = {"tree": name, "seconds": time.perf_counter() - t0,
               "rank_seconds": [d["seconds"] for d in docs],
               "programs": {n: row["ms_per_call"] for n, row in
                            mod.xmesh_program_rows(docs, {}).items()},
               "cross_calls": [d["cross_calls"] for d in docs]}
        if failures:
            run["f"] = mod.xmesh_failures(docs)
        runs.append(run)
        print(json.dumps(run, default=str), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "sf": args.sf, "runs": runs}, f,
                      default=str, indent=1)
    return 0


def main() -> None:
    t_start = time.perf_counter()
    smi = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    device = "cuda"
    run_start = counter_totals(ROUTE_COUNTERS)
    tape: dict = {}

    def counted(name, fn):
        """Run one phase; keep its route counters' deltas."""
        before = counter_totals(ROUTE_COUNTERS)
        out = fn()
        tape[name] = counter_delta(before, counter_totals(ROUTE_COUNTERS))
        return out

    phase_build()
    no_oom("phase 2")
    from dgraph_tpu_torch.engine.batch import _ell_for

    t0 = time.perf_counter()
    store = build_store(N_NODES)
    g = _ell_for(store, "follows", False)
    say("setup store", nodes=store.n_nodes,
        edges=store.rel("follows").nnz, ell_slots=g.padded_edges,
        dense_buckets=sum(1 for k, _e, _r in g.parts if k == "ell"),
        tile_rows=0 if g.tiles is None else int(g.tiles.shape[0]),
        lvl2_buckets=[int(t.shape[1]) for t in g.lvl2],
        seconds=time.perf_counter() - t0)
    from dgraph_tpu_torch.ops.bfs import pack_seed_masks
    from dgraph_tpu_torch.tools.hop_profile import make_seeds
    hop = phase_kernels(g, device,
                        pack_seed_masks(g, make_seeds(N_NODES, LANES)))
    no_oom("phase 3")
    launches = counted("phase 4", lambda: phase_serve(
        store, device, N_NODES, SERVE_QUERIES, SERVE_DEPTH))
    no_oom("phase 4")
    phase_bench(store, device, N_NODES, LANES, DEPTH, CHECK_LANES,
                hop["bound_ms"])
    no_oom("phase 5")
    # phase 19 (c) and (e) on the bench graph while its store lives; its
    # other parts run where their stores do, all before phase 18
    mesh, ptape = card_mesh(device), ProgramTape(device)
    mesh_rows: dict = {}
    mesh_s: dict = {}
    t0 = time.perf_counter()
    with ptape.armed():
        bench_mesh = counted("phase 19 (c, e)", lambda: phase_mesh_bench(
            device, store, mesh, ptape))
    mesh_program_rows(ptape, device, merge_calls(
        bench_mesh["c_recurse"]["chain"]["programs"],
        bench_mesh["c_recurse"]["fused"]["programs"],
        bench_mesh["e_bitmap"]["programs"]), mesh_rows)
    mesh_s["c_e"] = time.perf_counter() - t0
    say("phase 19 mesh (c, e)", seconds=mesh_s["c_e"], **bench_mesh)
    no_oom("phase 19 (c, e)")
    del store, g
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES
    t0 = time.perf_counter()
    built = build_ldbc(LDBC_SF)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    with no_fused_fallback("phase 6"):
        ldbc = counted("phase 6", lambda: phase_ldbc(device, built=built))
    # the per-query path runs torch ops only: no hand kernel of the repo
    # is on it, and these counts show none launched
    say("phase 6 ldbc", seconds=time.perf_counter() - t0,
        hand_kernel_launches=dict(LAUNCHES), **ldbc)
    no_oom("phase 6")
    t0 = time.perf_counter()
    with no_fused_fallback("phase 7"):
        ic = counted("phase 7", lambda: phase_ic_batch(device, built))
    say("phase 7 ic batch", seconds=time.perf_counter() - t0, **ic)
    no_oom("phase 7")
    t0 = time.perf_counter()
    fz = counted("phase 9", lambda: phase_fused(device, built))
    say("phase 9 fused", seconds=time.perf_counter() - t0, **fz)
    no_oom("phase 9")
    t0 = time.perf_counter()
    handoff: dict = {}
    with no_fused_fallback("phase 11"):
        alpha = counted("phase 11", lambda: phase_alpha(
            device, built, handoff=handoff))
    say("phase 11 alpha", seconds=time.perf_counter() - t0, **alpha)
    no_oom("phase 11")
    t0 = time.perf_counter()
    kept: dict = {}     # phase 12's directory, for phase 13
    with no_fused_fallback("phase 12"):
        life = counted("phase 12", lambda: phase_lifecycle(
            device, built, handoff, keep=kept))
    say("phase 12 lifecycle", seconds=time.perf_counter() - t0, **life)
    no_oom("phase 12")
    # phase 19 (a), (b) and (f) on phase 6's store, before it goes
    t0 = time.perf_counter()
    mesh_answers: dict = {}   # phase 19's answers, phase 20's reference
    with ptape.armed():
        ldbc_mesh = counted("phase 19 (a, b, f)", lambda: phase_mesh_ldbc(
            device, built, mesh, ptape, answers=mesh_answers))
    mesh_program_rows(ptape, device, merge_calls(
        ldbc_mesh["a_ic_mix"]["programs"], ldbc_mesh["b_ring"]["programs"]),
        mesh_rows)
    mesh_s["a_b_f"] = time.perf_counter() - t0
    say("phase 19 mesh (a, b, f)", seconds=mesh_s["a_b_f"], **ldbc_mesh)
    no_oom("phase 19 (a, b, f)")
    # phase 7's store (its placed graphs and programs) goes before the
    # feature and GraphRAG store is built from the same graph
    g = built["g"]
    del built
    gc.collect()
    torch.cuda.empty_cache()
    # one SF1 store with the feature mix's extension and the GraphRAG
    # embeddings serves phases 8 and 10
    t0 = time.perf_counter()
    store, emb = build_graphrag_store(g)
    say("setup graphrag store", seconds=time.perf_counter() - t0,
        nodes=store.n_nodes, **emb)
    t0 = time.perf_counter()
    with no_fused_fallback("phase 8"):
        feat = counted("phase 8", lambda: phase_features(device, g, store))
    say("phase 8 dql features", seconds=time.perf_counter() - t0, **feat)
    no_oom("phase 8")
    t0 = time.perf_counter()
    cases = phase_combine_cases(device)
    say("phase 10 graphrag kernel", seconds=time.perf_counter() - t0,
        **cases)
    t0 = time.perf_counter()
    with no_fused_fallback("phase 10"):
        rag = counted("phase 10", lambda: phase_graphrag(device, g, store))
    say("phase 10 graphrag", seconds=time.perf_counter() - t0, **rag)
    no_oom("phase 10")
    t0 = time.perf_counter()
    with ptape.armed():
        rag_mesh = counted("phase 19 (d)", lambda: phase_mesh_graphrag(
            device, g, store, mesh, ptape, answers=mesh_answers))
    mesh_program_rows(ptape, device, rag_mesh["programs"], mesh_rows)
    mesh_s["d"] = time.perf_counter() - t0
    say("phase 19 mesh (d)", **{**rag_mesh, "seconds": mesh_s["d"]})
    no_oom("phase 19 (d)")
    check_mesh_routes(mesh_rows)
    say("phase 19 mesh", seconds=sum(mesh_s.values()), parts_s=mesh_s,
        shards=mesh.size, devices=sorted({str(d) for d in mesh.devices}),
        counters=mesh_counters(), programs=mesh_rows)
    # phase 20: the same answers from a mesh across two processes
    t0 = time.perf_counter()
    xmesh = phase_mesh_processes(device, mesh_answers, mesh_rows)
    say("phase 20 mesh across processes", seconds=time.perf_counter() - t0,
        backend="gloo", nccl=xmesh.pop("nccl"), **xmesh)
    del mesh_answers
    no_oom("phase 20")
    # phase 10's store stays alive: phase 13 injects at its knn and
    # @msgpass launches
    t0 = time.perf_counter()
    front_dir: dict = {}     # phase 13's directory, for phase 14
    mem = counted("phase 13", lambda: phase_memory_cost(
        device, g, kept, store, keep=front_dir))
    say("phase 13 memory and cost", seconds=time.perf_counter() - t0, **mem)
    del store
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    oom0 = oom_events()     # phase 13's own, which its end reset
    no_oom("phase 14 (start)", since=oom0)
    served: dict = {}        # phase 14's Alpha and server, for phase 16
    with no_fused_fallback("phase 14"):
        front = counted("phase 14", lambda: phase_front_end(
            device, g, front_dir, keep=served))
    say("phase 14 front end", seconds=time.perf_counter() - t0, **front)
    no_oom("phase 14", since=oom0)
    t0 = time.perf_counter()
    handed: dict = {}        # a copy of phase 14's directory, for phase 17
    obs = counted("phase 16", lambda: phase_observability(
        device, g, served, keep=handed))
    say("phase 16 observability", seconds=time.perf_counter() - t0, **obs)
    # phase 16 (d) injects exactly two allocation failures: one absorbed
    # at bfs.ell_recurse, one degrading fused.program (reset after)
    if obs["d_memory"]["oom_events"] != 2:
        raise AssertionError(f"phase 16: {obs['d_memory']['oom_events']} "
                             f"allocation failures, not its two")
    oom0 += 2
    no_oom("phase 16", since=oom0)
    del served
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        with no_fused_fallback("phase 15"):
            cl = counted("phase 15", lambda: phase_cluster(
                device, g, alpha["commits"]["p50_ms"]))
        say("phase 15 cluster", seconds=time.perf_counter() - t0, **cl)
        no_oom("phase 15", since=oom0)
    except BaseException:
        import shutil
        shutil.rmtree(handed["tmp"], ignore_errors=True)
        raise
    t0 = time.perf_counter()
    cli = counted("phase 17", lambda: phase_cli(
        device, g, handed, mem["b_budget"]["budget"]))
    say("phase 17 cli", seconds=time.perf_counter() - t0, **cli)
    # the launches of each main path, counted from zero around its run
    paths = {"bucket_hop": {
                 "query_batch @recurse (phase 4)": launches["bucket_hop"],
                 "query_batch IC mix (phase 7)":
                     ic["bucket_hop_launches"]["bucket_hop"],
                 "query_batch DQL features (phase 8)":
                     feat["bucket_hop_launches"]["bucket_hop"],
                 "query_batch GraphRAG (phase 10)":
                     rag["batch_bucket_hop_launches"],
                 "Alpha.query_batch after writes (phase 11)":
                     alpha["bucket_hop_launches"],
                 "restored Alpha.query_batch (phase 12)":
                     life["bucket_hop_launches"],
                 "Alpha.query_batch, memory and cost (phase 13)":
                     mem["bucket_hop_launches"],
                 "HTTP /query/batch (phase 14)":
                     front["bucket_hop_launches"],
                 "HTTP /query/batch, recorder and sampler armed (phase 16)":
                     obs["bucket_hop_launches"],
                 "cluster Alpha.query_batch (phase 15)":
                     cl["bucket_hop_launches"],
                 "CLI alpha process, HTTP /query/batch, from its trace "
                 "(phase 17)": cli["bucket_hop_launches"]},
             "segment_combine": {
                 **rag["segment_combine_launches_by_path"],
                 "@msgpass under an injected fault (phase 13)":
                     mem.get("segment_combine_launches", 0),
                 "@msgpass through feat_mesh, per shard (phase 19 (d))":
                     rag_mesh["segment_combine_launches"],
                 "@msgpass through feat_mesh across two processes, per "
                 "shard of each rank (phase 20 (a))":
                     sum(r["segment_combine_launches"]
                         for r in xmesh["ranks"]),
                 "@msgpass through feat_mesh across two processes, two "
                 "injected failures on rank 1 (phase 20 (f2))":
                     sum(r["f2"]["segment_combine_launches"]
                         for r in xmesh["f_fail"]["ranks"])}}
    paths["bucket_hop"]["Alpha.query_batch, a lane group only rank 0's "
                        "prior calls worth, on each of two ranks (phase "
                        "20 (e2))"] = sum(
        r["e2"]["bucket_hop_launches"] for r in xmesh["e_follow"]["ranks"])
    paths["bucket_hop"]["make_ell_recurse against the sharded bitmap "
                        "traversal (phase 19 (e))"] = \
        bench_mesh["e_bitmap"]["bucket_hop_launches"]
    t0 = time.perf_counter()
    lint = phase_static_analysis({name: sum(paths[name].values())
                                  for name in KERNEL_SOURCES})
    say("phase 18 static analysis", seconds=time.perf_counter() - t0,
        **lint)
    hub = rag["timing"]["segment_combine_msgpass_hub"]
    errs = [cases["max_abs_err"], hub["max_abs_err"],
            rag["timing"]["segment_combine_featprop_mean"]["max_abs_err"]]
    measured = {"bucket_hop": hop,
                "segment_combine": {**hub, "max_abs_err": max(errs)}}
    totals = counter_delta(run_start, counter_totals(ROUTE_COUNTERS))
    outside = {k: v - sum(d.get(k, 0.0) for d in tape.values())
               for k, v in totals.items()}
    if any(v < 0 for v in outside.values()) or any(
            k not in totals for d in tape.values() for k in d):
        raise AssertionError(f"route counters: the phases' deltas do not "
                             f"add up to the run's totals: {outside}")
    say("route counters", totals=totals, by_phase=tape,
        outside_phases=outside)
    say("script", seconds=time.perf_counter() - t_start, nvidia_smi=smi)
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": KERNEL_REPLACES[name],
                "launches": sum(paths[name].values()),
                "launches_by_path": paths[name],
                "max_abs_err": measured[name]["max_abs_err"],
                "ms": measured[name]["ms"],
                "plain_ms": measured[name]["plain_ms"],
                "bound_ms": measured[name]["bound_ms"],
                "bound_by": measured[name]["bound_by"],
                "library_ms": measured[name].get("library_ms"),
                "kernels_ms": measured[name].get("kernels_ms"),
                "chain_floor_ms": measured[name].get("chain_floor_ms")}
               for name, src in KERNEL_SOURCES.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--xmesh-ab"]:
        sys.exit(xmesh_ab(sys.argv[2:]))
    main()
