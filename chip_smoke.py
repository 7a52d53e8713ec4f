"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, numbered as they were added; any failure exits non-zero. Phases
1-4 and 30 run first, alone. Then two lanes run side by side: a child
process of this script (``--host-lane``, its log printed when it is
joined, its processes stopped with it) runs the `pio` chain 16, 17a,
18, 24, 26, 28 and 29 over one store, while this process runs 5-13,
17b, 14, 15, 16c, 19-22, 25, 31, 32, 34 and 35 (with 36's shells beside
19-35), and then 33, 23 and 27 over the child's phase-16 store. Phase 14 hands its grid scores to 24 through
a file, 16 its instances to 33, 23 and 27. Phase 3's timings, which make
the `kernels` line, are taken before the lanes start; the seconds and
rates logged after it are taken with the other lane running.

1. the card's name and power limit (nvidia-smi), and the build of every
   CUDA kernel under predictionio_tpu_torch/csrc/ with nvcc for sm_90a;
2. each kernel against its plain PyTorch version on the card, case by
   case (among them the shapes of both serving paths, of the evaluation
   bucket and of the quickstart walk-through's engine, (1,2,16,16), a
   head dim of 50 zero-padded into the D=64 kernel, and the MoE
   sessionrec cell's GQA launches, q (16,32,8192,128) over k, v at 4
   heads, mixed real lengths, with no window and with the 1,024-key
   window, each one counted launch of its kind), with the max abs
   difference and the tolerance;
3. the kernel's time at the serving shape, the batch bucket and the
   evaluation bucket (64,4,2048,64) beside
   the plain version, the library call (scaled_dot_product_attention
   with the same mask, and with is_causal alone, yardsticks the port
   never calls) and the bound: CUDA events around 100 back-to-back
   launches on preallocated tensors, divided by 100 (20 calls of the
   plain version; inputs stay in L2, as after the layer that wrote
   them), the kernel's device time
   from torch.profiler, and the kernel against the library call at B=1
   for S in {512, 8192};
4. the sessionrec serving path end to end at the long-context serving
   config (vocab 50,000, max_len 2048, d_model 256, 4 heads, 4 layers,
   bf16, random weights from a seed): save the model, deploy its
   directory through the port's engine server, POST queries, and check
   every answer, the kernel's launches per query, and the top-10 against
   the same model run with the plain attention;
5. sessionrec training at the JAX package's dense training config
   (bench.py:1199-1200: vocab 50,000, max_len 256, d_model 256, 4 heads,
   4 layers, batch 64, bf16): 512 users × 257 view events (cut from
   bench.py's 1,024) into the
   port's memory event store, then `run_train` for one epoch (8 Adam
   steps) into an engine instance: stage seconds, step times, tokens/s,
   peak memory, and the losses, which must be finite and fall;
6. the long-context training config (bench.py:1261-1263: max_len 4096,
   batch 4, blockwise attention): `run_train` on 13 users × 4,097
   events (4 steps, the last batch padded with all-PAD rows); then, on
   a seeded random batch as bench.py makes it, one step's loss and
   gradients through blockwise attention against full attention, and 4
   timed steps of `make_train_step`, and a profile of long-context steps
   as in phase 7;
7. the sequence-tiled loss forced at the dense shape against the flat
   loss (loss and gradients), a torch.profiler trace of dense training
   steps (the tied-logits product's share, and the device's busy share:
   profiled device time over the step timed without the profiler),
   and the logits product timed as the path computes it (f32 operands,
   CUDA cores) beside the bf16 tensor-core product with f32 output, a
   yardstick the path does not call;
8. the instance trained in phase 5, deployed from the store and queried
   as in phase 4;
9. ALS at the ML-20M shape (bench.py:95-99, 119-125: 138,493 users ×
   26,744 items × 20M power-law ratings, rank 32, λ 0.08): the seconds
   of `ladder_rows` through the native packer (`NATIVE_LADDERS` must
   move), and on the first 4M ratings beside the NumPy path's (the
   layouts equal array for array), and of staging; 3 bf16 iterations (cut
   from bench.py's 10) after a one-iteration
   warm-up, timed by CUDA events (ms per iteration, ratings/s, useful and
   executed TFLOP/s, peak memory), one iteration under torch.profiler
   (launches, device time, busy share against the unprofiled iteration);
   the f32 route's 3 iterations; RMSE finite and below the first
   iteration's, bf16 within 0.02 of f32; one f32 user half-step against
   float64 Cholesky on the host on 4,096 sampled rows;
10. rank 200 (bench.py:396-441): 1 iteration (cut from 2) with the "auto" bf16 CG
   matvec after a profiled one, and a user half-step with each matvec
   (bf16, f32) timed and held against float64 on 1,024 sampled rows;
11. serving the phase-9 model: `ALSModel.save`, then the engine server
   with the recommendation template on that directory; ~30 HTTP queries (num 10/100/1000,
   white and black lists, an unknown user, a user with more than 512
   seen items), each held against a float64 host top-k; 256 queries
   through `DeployedEngine.query_batch` against the single path;
12. batch top-k at B=256 × I=2M (bench.py:927): flat against chunked,
   both timed;
13. the recommendation template at the MovieLens-100k shape: events into
   the memory store, `run_train` (rank 10, 10 iterations, λ 0.01, seed
   3), deploy of the instance, HTTP queries checked as in phase 11;
14. sessionrec evaluation at the serving width: 128 users × 2,049 view
   events, `run_evaluation(SessionRecEvaluation(k=10), ...)` over two
   grid points (lr 1e-3 and 3e-3, batch 8, one epoch) with eval_k 2:
   each fold trains on the card and predicts its 64 held-out users in one
   (64,4,2048,64) bucket through the flash kernel. Checks the instance
   row, best.json, HitRate@10 against a host recomputation from the
   returned triples, the kernel's launches (4 layers × the buckets), and
   16 held-out queries batch against single and the plain attention;
   logs the seconds of every stage and the peak memory;
15. recommendation evaluation at the ML-100k shape: the JAX template's
   4-point grid plus rank 32 / 10 iterations / λ 0.08, through
   `run_evaluation(RecommendationEvaluation(k=10), ...)` with the
   template's Engine and then with a FastEvalEngine: the instance rows,
   best.json, Precision@10 and MAP@10 against the host, the same scores
   under both engines, one read of the data source under FastEvalEngine
   against one a point, and the best point again on the CPU;
16. `pio` as separate processes (`python -m predictionio_tpu_torch.cli.pio`)
   over a fresh PIO_FS_BASEDIR (the default sqlite + localfs): (a)
   sessionrec at the serving width: 128 users × 2,049 view events as
   JSON lines, `app new`, `import`, `train` (one epoch at batch 8: 16
   Adam steps at S=2048), `deploy`, 30 queries over HTTP; the deploy
   process's `GET /` must count 4 × 30 kernel launches (and answer
   `text/html` to a browser's `Accept: text/html`), every answer's
   items must equal those of the same instance deployed in this process
   from the same store, and the scores must hold against the plain
   attention; the kernel timed on the q/k/v of a served query; (b) the
   recommendation template at the ML-100k shape the same way (rank 10,
   10 iterations, λ 0.01): the instance row COMPLETED with the JAX
   package's algorithms_params text, the training read through
   `EventStore.scan` on sqlite timed, and 30 answers equal to the
   in-process deploy and the float64 reference; (c) the top-k tie order
   on the card: item tables whose rows repeat, through `recommend_topk`,
   `recommend_topk_chunked` (three tiles and an overlap tile),
   `similar_topk` and `predict_topk_batch`, each against the host's
   (value desc, index asc) order, and the tie rule's time beside bare
   `torch.topk` at B=1 × 26,744 and B=256 × 2M;
17. serving under load: (a) phase 16a's instance behind two `pio deploy`
   processes, `--batching --batch-max 64` and unbatched, both with
   `--cache` and `--server-key`; closed-loop clients C in {1, 8, 64} send
   distinct queries (no level may hit the cache) that mix stored users
   with `items` sessions of 1 to 2,048 real items (every fifth with a
   black list): p50, p99 and
   queries/s per C and mode, the batch-size histogram, the dispatch ms
   per batch and the queue-wait share; batches above 1 at C >= 8;
   batched answers against unbatched ones, and the last answer of a
   batch of each dispatched size (replayed in this process) against the
   plain attention; (b) the ML-20M-shape model of phase 11, stored as an
   engine instance, behind the in-process server, batching on and off,
   at the same C; (c) a
   repeated-query mix through the cache (hits launch nothing), then
   `/reload` with the key: the cache generation moves, `/readyz` is 200
   and the next repeat misses; (d) `X-PIO-Deadline-Ms` 1, then 20, at
   C=64: 503s with Retry-After and no other error, and at 20 ms queries
   the dispatcher expired at dequeue; (e) `pio undeploy --server-key`
   stops both deploy processes with exit code 0. Each deploy process's
   kernel launches must equal 4 x the sum over dispatched batch sizes n
   of popcount(n) (4 a query that missed the cache unbatched), and no
   failed batch may have been retried query by query;
18. the event server and the loop events → train → serve → feedback,
   in the store of phase 16: (a) `pio app new ingest`, a full key and
   one whitelisted to `view`, `pio app channel-new ingest side`, `pio
   eventserver --stats` as a process (seconds to listening), `GET /`
   and `/readyz`; (b) the view events of 32 of 16a's users (every 4th:
   65,568 events, the walks still cover all 50,000 items) over `POST
   /batch/events.json`, 50 a request from 8 keep-alive clients: every
   status 201, the `/stats.json` ingest counters, the app's columnar
   read equal to 16a's import of those users (ids and creation times
   aside), events/s; 200 single `POST /events.json` (p50); (c) 401, 403,
   400, a channel POST read back only from its channel, `GET`/`DELETE
   /events/{id}.json`, a filtered `GET /events.json` with a limit, and a
   SegmentIO and a MailChimp webhook; (d) `pio train` from app `ingest`
   (S = 2048, 4 Adam steps), `pio deploy --feedback --no-batching`, 30
   queries (half with a prId) answered as the in-process deploy and
   the plain attention answer them, 4 kernel launches a query, exactly
   one `predict` event per query (its query and prediction, entityId =
   the answer's prId) readable within 10 s, `pio undeploy`; (e) the
   event server again over a binevents event store with `--wal-dir
   --wal-policy write-through --wal-fsync interval`: the first 5,000 of
   16b's events all 202, drained (`pio wal status`: 0 pending) and read
   back equal through the native scanner, events/s and drain seconds;
   then SIGKILL during a second burst, a restart, and every
   acknowledged event read back;
19. similar product and e-commerce at the ML-20M shape: 10M of
   bench.py's power-law pairs over 138,493 × 26,744 as implicit views
   (cut from phase 9's 20M), each item
   in 1-3 of 20 categories; each template's algorithm trained at the JAX
   package's defaults (rank 10, λ 0.01, α 1.0, seed 3) but for 10
   iterations (cut from 20)
   from prepared data built from the COO (both layouts by the native
   packer); 64 queries a template (categories, white and black lists,
   a live `unavailableItems` constraint and newcomers' recent views read
   from a small store) held against float64 on the host with the tie
   rule; train seconds, ms per iteration, device ms and launches per
   query, peak memory;
20. the ALS-family templates through a store: an ML-100k-shape shop
   (25,000 views, cut from 100,000; 2,000 buys, categories, a
   constraint) through `pio import` → `pio train` → `pio deploy` of
   e-commerce, HTTP queries,
   then a new `unavailableItems` and a newcomer's views POSTed to `pio
   eventserver`: the next answers must exclude those items and serve
   the newcomer; similar product through `run_train` → the engine
   server, every answer against the deployed engine and float64;
21. classification at the UCI Covertype shape (581,012 × 54, 7 classes,
   seeded): multinomial naive Bayes trained and scored on every row,
   300 logreg Adam steps (lr 0.1, l2 1e-4; ms and launches a step
   against the bytes bound), a 10-tree depth-5 forest grown on the host
   on 29,050 sampled rows and its votes walked on the card over every
   row, each against float64 on the host (the votes exactly); then the
   template: 20,000 entities' `$set` properties in sqlite, `run_train`
   with naive Bayes and logreg under BlendedServing, HTTP queries, and
   the Accuracy grid through `run_evaluation` on the card equal to the
   same folds on the CPU;
22. ANN retrieval (`ops/ann.py`) at the JAX package's own ANN point
   (bench_serving.py:1563-1623), its catalog cut from 1,000,000 to
   65,536 items at rank 32 from its factor mixture (256 clusters, noise
   0.5, seeds 7/8), 2,048 users with 8 seen items; `ALSModel.save` builds
   the IVF index at persist time (the auto nlist; the build seconds
   logged), `ALSModel.load` on the
   card and `configure_retrieval("ann")`; at nprobe = nlist 64 answers
   equal brute force, ids and order; at the auto nprobe each answer
   equals a float64 rescore of its shortlist; recall and MAP@10 at
   nprobe auto, 2x and 4x; `ann_topk` at B = 1 and 32 (CUDA events,
   profiled device time, launches) beside brute `recommend_topk` and the
   probe's bytes bound, and at B = 32 beside a row-at-a-time loop; then
   the ML-20M-shape model of phase 17 behind the engine server with
   retrieval=ann: `annShortlistHistogram` counts its queries, `POST
   /retrieval` switches to brute and back, and at full probe the HTTP
   answers equal brute force;
23. online freshness (`online/`): phase 16b's ML-100k instance behind
   `pio deploy --online --online-interval-s 0.2 --cache` and `pio
   eventserver` over the same sqlite store: 8 known users each rate
   their first answer over `POST /events.json`, and each answer changes
   with no retrain (the seconds from the 201, p50 and max); a new user
   and a new item are served; 32 other users' cache entries survive
   (hits, no misses); the same events folded in this process on the card
   give vectors within 1e-4 of a float64 solve of each user's full
   history and the deploy process's answers (ms per user folded), with
   the device ms and launches of `_gather_rows`; `/reload` moves the
   overlay's generation and the folded users are refolded, and a delta
   computed against the old generation is discarded;
24. the parallel evaluation grid: phase 14's two grid points (the
   serving widths, eval_k 2, one epoch) over 16a's sqlite store through
   `pio eval chip_smoke.GridEvaluation chip_smoke.GridParams --parallel 2`
   as a process, whose forked workers each train a point's folds on the
   card and predict them through the flash kernel; the evaluation row is
   polled every 20 ms (EVALUATING mid-run); each fold logs its process,
   its launches and whether it rebuilt the kernel library; the forked
   scores and best point against the serial grid (`--parallel 1`) within
   the spread of two serial runs (phase 14's and `pio eval`'s; two `pio
   eval` runs alone), floored at one user's hit; a poisoned grid (3
   heads over d_model 256) completes as one FAILED and one COMPLETED
   point, EVALUATING with one point landed while the other runs; a
   FakeRun through `pio eval` sees the card; wall seconds of each;
25. e2 and the quality parity: `compare_quality` at the ML-100k
   reconstruction (rank 10, 10 iterations, λ 0.05, 5 folds) with the
   ALS on the card, held-out RMSE within 0.05 of the NumPy ALS-WR's and
   MAP@10 inside its seed band; the implicit path against popularity on
   examples/data/sample_movielens.txt; `MarkovChain.train` over 26,744
   states (a 2.86 GB dense f32 table) from the first 2.5M of phase 9's
   ratings as per-user consecutive transitions (cut from all 20M) against
   float64 on the host, ids exact with
   ties lowest index first; `CategoricalNaiveBayes.train` on the first
   quarter of phase 21's Covertype-shape rows as categorical strings, the
   counts exactly
   against NumPy bincount; each device program's CUDA-event ms, device
   ms and launches;
26. the observability layers over 16a's store: (a) `pio train --profile
   --profile-dir --profile-out`: the `pio.train_report.v1` report with
   the four stages, FLOPs within 10 % of `seqrec_train_flops` (the
   model's matrix products, counted from its shapes), 0 < MFU <= 1
   against the table's 989e12, peak device bytes below the card's
   memory and a Chrome trace; (b) that instance behind `pio deploy
   --tracing --batching --batch-max 64`: 64 queries over 8 closed-loop
   clients, each answer with `X-PIO-Trace-Id`, every trace on
   `/traces.json` with the JAX package's spans in its order, each
   inside its root, and the launches 4 × popcount of the batches; the
   same in an in-process server, where each flash launch's host time
   falls inside a `batcher.device_dispatch` span and its CUDA event has
   completed when `query_batch` returns; (c) `/metrics` parsed as
   Prometheus text: the device gauges (in use > 0, peak >= it, limit =
   total memory), `pio_serving_recompile_total` 0, the `compile` block
   of `/stats.json`; (d) the tracing overhead at C = 8 against the same
   deploy with `--no-tracing`: p50, p99 and queries/s over three paired
   rounds, order alternated; (e) `pio eventserver --tracing`: one batch
   of 50 events, its `parse → validate → insert_batch` trace behind the
   key, the ingest families on `/metrics`;
27. the prefork serving pool: 16a's instance behind `pio deploy --workers
   N --batching --batch-max 64 --cache --shm-cache --tracing --supervise
   --server-key` for N in {1, 2, 4} (4 only where the host allows 4 CPU
   stripes), each started alone (seconds until every worker is in the
   spool), warmed, then phase 17's C=64 level (the same 256 distinct
   queries at every N): p50, p99, queries/s beside phase 17's batched
   row, every answer equal to the in-process one within BATCH_SCORE_TOL,
   every worker launching, each worker's launches = 4 x popcount of its
   batches (read worker by worker over the pool's loopback peer
   endpoints), no build and no batch retry in any worker, and each
   worker's device bytes from the folded /metrics; on N=2 a `/reload`
   and a `/drain` landing on one worker reach every worker (the
   /stats.json per-worker admin section), /metrics counters equal the
   sum of the workers' own and /traces.json holds several workers'
   traces; on the largest N one worker's answer is a shared-cache hit for
   its siblings that launches nothing, the kernel is timed on a served
   query's q/k/v while the pool serves at C=64, and a sibling SIGKILLed
   under load is respawned from the spawn context and answers on the
   card with no 5xx, the segment surviving; then 16b's ML-100k instance
   behind `--workers 2 --model-mmap --online` and `pio eventserver`:
   answers equal a one-process deploy's, one tail lease, both workers map
   the same checkpoint payloads (bytes unchanged), and after 8 users'
   ratings every answer on fresh connections equals the same fold in
   this process;
28. the router tier: `pio router --supervise --tracing` with two
   `--replica-cmd` replicas (`pio deploy` of 16a's instance, `--batching
   --batch-max 64 --tracing`, on the card), a third such deploy as the
   canary, and 16b's ML-100k instance as a second engine (`--engine`),
   the scale controller in dry run: phase 17's C=64 level (256 distinct
   queries) through the router, every answer equal to the in-process one
   within BATCH_SCORE_TOL, p50, p99, queries/s beside phase 27's N=2 pool
   and the router's own hop from its spans; the kernel timed on a served
   query's q/k/v while the replicas serve through the router; the ML-100k
   engine at /engines/<name>/queries.json equal to its deploy queried
   directly; `pio status --router` (no storage, no torch) listing both
   engines with their replicas up; the canary at weight 10 over 1,000 queries within 5
   binomial sigmas, then promoted (weight 100) over `/fleet/canary`; a
   replica SIGKILLed under load at C=8: no 5xx, retries counted, the
   supervisor respawns it, membership marks it up, seconds to its first
   routed 200; `pio experiment start` over phase 24's forked grid (both
   variants on the two replicas): answers stamped with experimentId and
   variantId, attributed buys into `pio eventserver` counted by
   `pio_experiment_conversions_ingested_total`, then `pio experiment
   conversions` and `status`; `pio trace` of a routed query, a stitched
   tree from the router's root span to the replica's
   batcher.device_dispatch; `/fleet/metrics` folding both replicas and
   `pio_fleet_desired_replicas` on `/metrics`; each replica's launches = 4
   x popcount of its batches with no build; a SIGTERM of the router stops
   it and its replicas;
29. remote storage and the admin tools: an in-process PostgreSQL wire
   emulator (tests/pg_emulator.py, md5 authentication) and a fake S3
   in this script (path-style objects, SigV4 headers required); `pio`
   with METADATA in PostgreSQL, EVENTDATA through the `chaos` injector
   (20 % seeded faults) over the same database, MODELDATA in S3: `pio
   app new`, `pio import` of 12 of 16a's users (24,588 views; cut from
   128, every event crosses the wire twice), 1,000 exact copies and 400
   `$set` events (events/s beside 16a's sqlite import), `pio build`
   beside it; `pio run` of a main that calls
   `SelfCleaningDataSource.clean_persisted_events` (duplicates removed,
   `$set` runs compressed) and reads back through the injector: the
   count exact, every view once, one folded `$set` an item, faults
   fired, no torch loaded; `pio train` of 16a's engine at full width on
   the card, its weights in the blob (`storage_engine_factory`), the
   blob in S3 under the instance id the PostgreSQL row names, its
   envelope SHA-256 right; `pio deploy --batching` from S3: phase 17's
   C=8 level of 128 distinct queries, each answer within BATCH_SCORE_TOL
   of the blob fetched back and deployed here, launches = 4 x popcount
   of the batches with no build, the kernel timed on a served query's
   q/k/v beside its plain version; while the deploy boots, `pio
   adminserver` over the PostgreSQL metadata (alive, an app made, listed
   (and by `pio app list`), its data and then itself deleted), `pio
   dashboard` over phase 24's store (the index lists the forked grid's
   instance, its evaluator_results.json equals the stored row's,
   `/metrics` and a CORS preflight answer), `pio upgrade` and `pio
   template` exiting 1 with the JAX package's messages;
30. `pio lint` of the port's own tree on this machine, which has no
   JAX, in child processes started with phase 1 and joined before
   phase 3 (nothing is timed meanwhile): `pio lint --format json
   --no-cache` must exit 0 with no finding, all three project passes in
   its stats and more than 100 files, and load no torch; the lint of a
   copy of tests/analysis_fixtures/host_sync_bad.py and of its torch
   twin (tests/analysis_fixtures_torch/) must give exactly the five
   findings the tests pin; the lint's seconds (parse, module rules,
   project rules) are logged;
31. the 15 example engines of examples_torch/, after phase 25, in the
   main process: each trained from its own seed_events.py (or, where it has
   none, its JAX test's events) through `run_train` on the card and on
   the CPU, loaded through `load_models` and `prepare_deploy`, and
   asked its README's and its JAX test's queries; the card's instance
   served on the card and on the CPU agree (ALS scores within 1e-5, the
   z-score blend 1e-4; the forest's votes exactly, the Markov chain and
   hello-similarity within 1e-6, the ridge 1e-12), an engine with no ALS
   also against the one trained on the CPU; an ALS engine trained on
   the CPU is not held to the card's (its scores move with the last bits
   of its start on these small data) but shows the same pinned
   behaviours: a disabled item absent, only the query's categories or
   years, an excluded item untrained, the forest's labels, a live weight
   lifting its item, the dislikes demoting i0; per engine the train
   seconds, predict p50, ms a query between CUDA events, device ms and
   launches a query; meanwhile, in a thread,
   recommendation-custom-serving's README through `pio` processes on
   the card: `app new`, `python seed_events.py`, `pio build`, `pio
   train`, `pio deploy` (whose GET / names the card), a query over
   HTTP, a live edit of disabled.txt and the same query without the
   disabled item, no redeploy; no flash kernel is launched;
32. the chunked and bucketed ALS layouts on phase 9's ML-20M-shape
   ratings at rank 32, λ 0.08: both sides packed by the native chunker
   (chunks of 512 then 128), bucketizer (from 8, growth 2) and capped
   bucketizer (4,096 ratings a row), `als.NATIVE_CHUNKS` and
   `NATIVE_BUCKETS` showing that they served, and each equal to the
   NumPy path on the first 4M ratings; the bf16 route through
   `solve_half` over 3 iterations for the fused ladder (the reference),
   the bucketed layout streamed from the host, resident, and the
   chunked layout: ms an iteration by CUDA events, ratings/s, RMSE
   (within 0.02 of fused's), peak device memory (streamed below
   resident), launches and device ms of one iteration by torch.profiler;
   each layout's f32 user half-step against float64 Cholesky on 4,096
   rows (1e-4; the capped one on its own columns) and, uncapped, against
   the fused f32 half-step; `als_train(max_row_len=4096,
   hbm_resident=False)` for one iteration; beside phase 9's numbers;
33. `pio export --format parquet` of 16b's ML-100k app (102,000 events)
   from the child's store, read only; `pio import` of the file (Parquet
   by its suffix) into a fresh store; JSON-lines exports of both apps,
   equal line for line (without pyarrow: both commands exit 1 with the
   JAX package's message);
34. the in-process device mesh (`parallel/mesh.py`), in the main lane
   after phase 32, its meshes over 4 positions on the card (or over 4
   cards when there are): (a) fused DP×MP ALS on phase 9's ML-20M-shape
   ratings at rank 32, λ 0.08, bf16, `shard_factors` on 1×4 and 2×2
   meshes, 2 iterations each, against the unsharded run (RMSE within
   1e-3, the f32 user half-step on 4,096 rows within 1e-5, each table's
   shards on their devices 4 or 2 ways; ms an iteration by CUDA events,
   launches and device ms of one iteration by torch.profiler after the
   timed runs, peak memory), and the chunked layout on 2×2 for one
   iteration against chunked unsharded (1e-3); (b) the 1×4 model saved
   (`"sharded"` in model.json) and loaded onto a 1×4 serving mesh, 256
   queries through the sharded dispatch against `recommend_topk` on the
   unsharded model (scores 1e-5, indices equal where finite off
   near-ties), phase 12's 2M-item top-k sharded 4 ways against the flat
   path with both times, k above a shard's rows and a batch of 5 on a
   2-wide data axis; (c) naive Bayes (counts exactly) and logreg (W
   within 1e-3) on phase 21's Covertype sample over a 4×1 data mesh
   against the unsharded fits; (d) `run_train` of the ML-100k
   recommendation engine with `"shardFactors": true` and a 2×2
   `meshConf` on a context given the 4 positions (the instance records
   the meshConf), `load_deployed_engine` onto a 2-way serving mesh, 32
   `DeployedEngine.query` answers against the engine trained unsharded
   (scores 1e-5); (e) `e2/quality.compare_quality` at ML-100k over a 2×2
   mesh against `mesh=None` (RMSE within 1e-3); no flash kernel is
   launched;
35. the sequence mesh and the multi-process mesh, in the main lane after
   phase 34: (a) ring attention (`ops/attention.ring_attention_sharded`)
   at (4, 4, 4096, 64) bf16, causal, rows of mixed length, over 4 "seq"
   positions on the card against blockwise attention (output within
   TOL[bf16], the gradients of sum(out²) within 3e-2 relative), each
   route's ms, launches, device ms and peak memory, forward and
   forward+backward; (b) the long-context config (vocab 50,000, S 4096,
   batch 4, bf16) for 4 Adam steps from one initial state, unsharded
   (blockwise), over {"data": 1, "seq": 4}, {"data": 2, "seq": 2} and
   {"data": 2, "model": 2} (the "model" axis idle): losses within 1e-4
   relative step by step, the parameters' median distance within lr/10
   of the unsharded run's (their largest distance and mean logged); step
   ms, launches, device ms, peak memory; (c) 16 of 16a's users through
   `run_train` with meshConf {"data": 1, "seq": 4} at the serving width
   (the instance records it; training launches no flash kernel), served
   by `DeployedEngine.query`: 4 flash launches a query, each top-10
   within SCORE_TOL of the plain attention, the kernel within TOL[bf16]
   of its plain version on a served query's q/k/v; (d) two ranks of the
   script (`--dist-child`, fresh interpreters started at the phase's
   start, PIO_NUM_HOSTS=2, gloo, 2 positions each on the card): the
   cross-rank psum, and 2 fused 2×2 `shard_factors` ALS iterations at
   the ML-20M shape (bf16, rank 32) equal to the in-process 2×2 run on
   the same ratings and table (1e-6 relative); ms an iteration, launches,
   device ms, collectives' seconds and host-staged bytes per rank;
36. the launchers, the distribution and the walk-throughs, in the main
   lane beside phases 19-35 (its work runs in shells and `pio` processes,
   a thread of this process waiting on them): (a)
   `make-distribution-torch.sh` into a temporary directory outside the
   checkout, the tarball unpacked there (the port's package, bin_torch/,
   conf/, docs_torch/, pyproject.toml and README.md, no build/); (b)
   `bin_torch/pio-start-all` from the tree, the event server's `GET /`
   alive, `pio-shell` bound from the tree with no JAX package on its path,
   `pio-stop-all`; (c) `docs_torch/quickstart-sessionrec.md` and
   `docs_torch/quickstart-recommendation.md` verbatim, each in one bash
   with the tree as its working directory and nothing of this checkout
   on the path, so that their `pio train` and `pio deploy` run on the
   card (`GET /` and `/stats.json` of the deploy read before each
   document's tear-down block); (d) the flash kernel's library built by
   the sessionrec deploy from the tree's own csrc/ into the tree's own
   build/kernels/; (e) that deploy's kernel launches (`GET /`
   kernelLaunches); (f) the seconds of every block, of the build and of
   the phase;
37. the operator documents of docs_torch/ against live servers on the
   card, in phase 36's thread after its walk-throughs, from the same
   tree, beside its `pio-start-all` stack (stopped after this phase) and
   over the walk-throughs' stores: (a) three documented command lines
   verbatim, their port 8000 replaced — observability.md's `pio train
   --profile` in the recommendation walk-through's directory (its
   TRAIN_REPORT.json must show device memory), serving-performance.md's
   `pio deploy --workers 4 --supervise ...` of the sessionrec
   walk-through's instance and freshness.md's `pio deploy --online` of
   the recommendation instance; (b) queries to both deploys over fresh
   connections, a rating written to the store and folded by the online
   deploy, then every metric family of observability.md's catalog and
   every /stats.json key of serving-performance.md's table that the
   documents name for the engine server under that deploy's conditions,
   present on its /metrics and /stats.json; pio-start-all's event
   server after an app made through the admin server and events in two
   distinct seconds: its documented families, and /stats.json without
   --stats answering 404; every deploy and the train on the card; (c)
   the seconds of every step and the pool's flash launches, read worker
   by worker, which count toward the kernels line;
38. a `kernels` JSON line;
39. the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}};
40. in the main path after phase 35, the sessionrec serve path's stage
   spans, over a random model at the long-context serving config
   (SPANS_USERS users, histories log-uniform 16-2,048 of power-law items)
   through `DeployedEngine.query_batch` in SPANS_BATCH-query batches: (a)
   `obs.trace.span` with no trace bound and no profiler recording is the
   shared no-op, and its ns a block over SPAN_CALLS; (b) a `Trace` bound
   around each of SPANS_TRACED batches records the seven `seqrec.*`
   stage spans in order, and their median ms; (c) SPANS_PROFILED batches
   under `torch.profiler` (host and card) show the seven stages as host
   annotations in order, and each annotation the profiler mirrors onto
   the card's timeline says it is one; its flash launches count toward
   the kernels line.

Each phase of the main path logs its seconds (`[phases]`).
`--als-only`, `--eval-only`, `--pio-only`, `--serve-only`,
`--ingest-only`, `--templates-only`, `--ann-only`, `--online-only`,
`--grid-only`, `--e2-only`, `--obs-only`, `--pool-only`,
`--router-only`, `--storage-only`, `--lint-only`, `--examples-only`,
`--als-layouts-only`, `--parquet-only`, `--mesh-only`, `--dist-only`,
`--quickstart-only` and `--docs-only` run phases 9-13, 14-15, 16, 17,
18, 19-21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36
and 36-37 alone
(17 over 16a's
instance and a random ML-20M-shape ALS model, 18, 24 and 26 over 16a's
import, 22 over a random ML-20M-shape model, 23 over 16b's import and
train, 27 over 16a's and 16b's, 28 over 16a's and 16b's and a serial
`pio eval` of phase 24's two grid points, 29 with its dashboard over a
serial `pio eval` of those points on 16 of 16a's users, 33 over a 16b
import and train) and print no result line. Phases
22, 23, 25, 31, 32 and 34 launch no flash kernel. Exits non-zero, printing no result,
when there is no card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib.util
import json
import math
import os
import re
import shlex
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Callable
from datetime import datetime, timedelta, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from predictionio_tpu_torch import __version__
from predictionio_tpu_torch import native as native_libs
from predictionio_tpu_torch.api.engine_server import create_engine_server
from predictionio_tpu_torch.controller import (
    AverageMetric,
    Engine,
    EngineParams,
    EngineParamsGenerator,
    Evaluation,
    FastEvalEngine,
    PersistentModelManifest,
)
from predictionio_tpu_torch.controller.evaluation import MetricEvaluator, best_json_variant
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.core.wire import from_wire
from predictionio_tpu_torch.data import movielens
from predictionio_tpu_torch.e2 import engine as e2
from predictionio_tpu_torch.e2 import quality
from predictionio_tpu_torch.models import logreg, naive_bayes, random_forest, seqrec
from predictionio_tpu_torch.models.als import ALSModel, build_allow_vector
from predictionio_tpu_torch.obs import trace as ptrace
from predictionio_tpu_torch.obs.device import TrainProfiler
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.ops import ann as ann_ops
from predictionio_tpu_torch.ops import flash_attention as flash_ops
from predictionio_tpu_torch.ops import topk as topk_ops
from predictionio_tpu_torch.ops.attention import full_attention
from predictionio_tpu_torch.parallel import mesh as pmesh
from predictionio_tpu_torch.parallel.mesh import Mesh, ShardedArray
from predictionio_tpu_torch.storage.base import App, EngineInstance
from predictionio_tpu_torch.storage.registry import Storage, memory_storage
from predictionio_tpu_torch.templates import classification, ecommerce, similarproduct
from predictionio_tpu_torch.templates import recommendation as rec
from predictionio_tpu_torch.templates import sessionrec
from predictionio_tpu_torch.utils.bimap import BiMap, EntityIdIxMap
from predictionio_tpu_torch.utils.device import ieee_f32
from predictionio_tpu_torch.workflow.context import EngineContext
from predictionio_tpu_torch.workflow.deploy import (
    DeployedEngine,
    ServerConfig,
    load_deployed_engine,
)
from predictionio_tpu_torch.workflow.evaluation import run_evaluation
from predictionio_tpu_torch.workflow.fake import FakeRun
from predictionio_tpu_torch.workflow.persistence import save_models
from predictionio_tpu_torch.workflow.train import format_stage_times, run_train

SEED = 0
DEVICE = "cuda"
#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 on
#: the CUDA cores, and device-memory bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
#: kernel vs plain: f32 differs by summation order; bf16 by a rounding
#: step of the output and by the bf16 rounding of P before the PV product
TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-2, 8e-3)}  # (atol, rtol)
SERVING = dict(vocab=50_000, max_len=2048, d_model=256, n_heads=4, n_layers=4)
#: buckets of batched serving (phase 17) checked and timed with rows of
#: mixed real length, beside B = 1, 8 and 64 with every key real
MIXED_BUCKETS = (2, 4, 16, 32)
#: top-10 agreement, served (kernel) vs plain attention: logits are f32
#: sums over bf16 hidden states, which differ by bf16 rounding steps
SCORE_TOL = 0.1
#: the JAX package's training configs at full width, as engine.json
#: algorithm params: dense (bench.py:1199-1200) and long context
#: (bench.py:1261-1263); bf16 is the template's dtype
TRAIN_DENSE = dict(d_model=256, n_heads=4, n_layers=4, max_len=256, batch_size=64,
                   lr=1e-3, epochs=1, seed=SEED)
TRAIN_LONG = dict(TRAIN_DENSE, max_len=4096, batch_size=4)
#: items i1 .. i49999, so that with PAD the template derives vocab 50,000
N_ITEMS = 49_999
#: (users, events per user, start stride) of the event walks: user u views
#: i{(stride·u + t) mod N_ITEMS + 1}, t < events. Starts 98 apart with
#: walks of 257 (512 × 257 = 131,584 events: 8 steps of 64 rows of 256;
#: bench.py's 1,024 users cut to 512 to make room for phase 29)
#: and starts 3,847 apart with walks of 4,097 (13 users: 4 steps of 4 rows
#: of 4,096, 3 of them all-PAD) both cover every item.
DENSE_WALK = (512, 257, 98)
LONG_WALK = (13, 4097, 3847)
#: bf16 training computed two ways (blockwise vs full attention, tiled vs
#: flat loss): the same sums in another order, with every cast rounded to
#: bf16 as in the tests' bf16 cases (tests/test_torch_seqrec_train.py):
#: loss within 1e-3 relative, each gradient within 3e-2 relative
#: Frobenius error
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_RTOL = 3e-2
#: the JAX package's ALS benchmark at the MovieLens-20M shape
#: (bench.py:95-99, make_ratings :119-125): users, items, power-law ratings
ML20M = (138_493, 26_744, 20_000_000)
ALS_RANK, ALS_LAM, ALS_ITERS = 32, 0.08, 10
#: the iterations phase 9 times on each route (cut from bench.py's 10 to
#: 5 for phase 28 and to 3 for phase 29; ms per iteration is what it reports)
ALS_TIMED_ITERS = 3
#: bench.py:396-441: rank 200, short runs (one timed iteration, cut from
#: two to make room for phase 28; the f32 matvec timed on the user
#: half-step its float64 check solves, no longer over a whole iteration,
#: and the profiled iteration is the warm-up, to make room for phase 29)
RANK200, RANK200_ITERS = 200, 1
#: rows whose f32 CG solutions are held against float64 Cholesky on the host
CG_CHECK_ROWS = (4096, 1024)           # rank 32, rank 200
#: relative error per row against float64: the f32 CG at rank 32; the bf16
#: CG matvec on the JAX package's own rank-200 system families (it
#: measured 2.4-2.6e-3 there); and any rank-200 half-step on ML-20M rows,
#: whose systems are harder (the bf16 matvec measured 1.5e-2 on an H100:
#: PERF.md), a bound that catches breakage. bf16 vs f32 training RMSE:
#: tests/test_als.py:626
CG_F32_RTOL, CG_BF16_RTOL, RANK200_ROWS_RTOL, RMSE_BF16_TOL = 1e-4, 5e-3, 5e-2, 0.02
#: served scores vs the float64 host reference (f32 dot products of
#: rank-32 rows of magnitude ~1): absolute
ALS_SCORE_TOL = 1e-4
#: bench.py:927: batch top-k against a 2M-item catalog
TOPK_BATCH, TOPK_ITEMS = 256, 2_000_000
#: the reference template's MovieLens-100k shape (BASELINE.md): users,
#: items, rate events, buy events
ML100K = (943, 1_682, 100_000, 2_000)
REC_FACTORY = "predictionio_tpu_torch.templates.recommendation.engine_factory"
#: the sessionrec evaluation at the serving width: 128 users × 2,049 view
#: events, starts 391 apart so that every item occurs (each fold derives
#: vocab 50,000); eval_k 2 holds out 64 users a fold, whose 2,048-item
#: histories go through batch_predict as one bucket of 64 at S = 2048
EVAL_WALK = (128, 2049, 391)
EVAL_K, EVAL_TOPK = 2, 10
#: the two grid points: the serving config's widths, batch 8, one epoch
#: (16 Adam steps a fold), at each learning rate of EVAL_LRS
EVAL_POINT = dict(d_model=256, n_heads=4, n_layers=4, max_len=2048, batch_size=8, epochs=1,
                  seed=SEED)
EVAL_LRS = (1e-3, 3e-3)
#: held-out queries checked batch against single and the plain attention
EVAL_SINGLE = 16
#: Precision@10 and MAP@10 of one grid point, two runs apart (absolute).
#: Each is a mean over ~1,880 queries (943 users × 2 folds); one item of
#: a top 10 swapped at a near-tie moves a user's precision by
#: 1/min(10, |held-out|), so the mean by ~5e-5 for the users who hold out
#: 10 items or more (most: each rates 20 or more). Engine against
#: FastEvalEngine: the same card, data and seeds, summed in the same order
#: unless a library call is not repeatable: 1e-3, ~20 such swaps. The card
#: against the CPU: the card sums the bf16 products in another order (f32
#: accumulation on the tensor cores) and ten iterations carry the
#: difference, so ties flip more often: 1e-2, ~200 swaps of ~18,800 slots
REC_EVAL_RERUN_TOL, REC_EVAL_CPU_TOL = 1e-3, 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


LAUNCHES_TIMED = 100
#: calls of a kernel's plain version in phase 3's timings
PLAIN_TIMED = 20
#: keys per K/V tile of the bf16 kernel (kKvTile in csrc/flash_attention.cu)
KV_TILE = 64


def time_ms(fn, warmup: int = 10, n: int = LAUNCHES_TIMED) -> float:
    """ms per call: CUDA events around n back-to-back calls, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def profiled_ms(fn, name: str, n: int = 20) -> float | None:
    """The device time per call of the kernels whose name holds `name`,
    from torch.profiler's CUDA activity; None where it records none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.key_averages() if name in e.key)
    return total_us / n / 1e3 if total_us > 0 else None


def attention_pairs(B, S, causal, kv_mask=None) -> int:
    """The (query, key) pairs attention needs: each key real under
    ``kv_mask`` (B, S) and, causal, at or before its query. A key at
    position j meets the S - j queries from j on."""
    if kv_mask is None:
        return B * (S * (S + 1) // 2 if causal else S * S)
    real = (kv_mask > 0).double()
    per_key = (S - torch.arange(S, device=real.device, dtype=torch.float64)
               if causal else torch.full((S,), float(S), device=real.device,
                                         dtype=torch.float64))
    return int((real @ per_key).sum().item())


def seqrec_train_flops(cfg: seqrec.SeqRecConfig, n_sequences: int, batch_size: int,
                       epochs: int) -> int:
    """The matrix-product FLOPs that ``seqrec.train`` executes, from the
    model's shapes: per step of B rows × S positions (T = B·S tokens),
    each layer's QKV, output and MLP projections (8·T·d² + 4·T·d·h),
    its attention products over the full (S, S) logits on either route
    (QK^T and PV, 4·B·S²·d), and the tied logits (2·T·d·V); the backward
    pass runs two products per forward product. Inside the backward pass
    ``torch.utils.checkpoint`` re-runs a region only up to the last input
    its backward needs (its early stop): remat re-runs each block but its
    MLP output product, the blockwise route (S ≥ 4096) each tile's QK^T,
    and a sequence-tiled loss the logits."""
    S, d, V = cfg.max_len, cfg.d_model, cfg.vocab
    h = cfg.mlp_mult * d
    B = min(batch_size, n_sequences)
    steps = epochs * -(-n_sequences // B)
    T = B * S
    attention = 4 * B * S * S * d
    layer = 8 * T * d * d + 4 * T * d * h + attention
    logits = 2 * T * d * V
    forward = cfg.n_layers * layer + logits
    step = 3 * forward
    if cfg.remat:
        step += cfg.n_layers * (layer - 2 * T * h * d)
    if seqrec.train_attention(S) is not seqrec.full_attention:
        step += cfg.n_layers * attention // 2
    if seqrec._pick_loss_tile(B, S, V) is not None:
        step += logits
    return steps * step


def attention_bound_ms(B, H, S, D, dtype, causal, kv_mask=None) -> tuple[float, str]:
    """The least time of a forward attention: its real pairs (see
    attention_pairs) at 4·D flops each over the bf16/f32 peak, against
    q/k/v/o and the mask read or written once over the memory rate."""
    flops = 4 * D * attention_pairs(B, S, causal, kv_mask) * H   # QK^T and PV
    nbytes = 4 * B * H * S * D * torch.finfo(dtype).bits // 8 + B * S * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def qkv(B, H, S, D, dtype, gen):
    return [torch.randn((B, H, S, D), generator=gen, device=DEVICE).to(dtype)
            for _ in range(3)]


def mixed_length_mask(B: int, S: int) -> torch.Tensor:
    """(B, S) key mask whose rows hold real lengths spread log-evenly
    over 1..S, right-padded, in a seeded order."""
    lengths = np.unique(np.geomspace(1, S, B).round().astype(int))
    lengths = np.resize(lengths, B)
    np.random.default_rng(SEED + B).shuffle(lengths)
    return (torch.arange(S)[None, :] < torch.from_numpy(lengths)[:, None]).float().to(DEVICE)


def log_card() -> None:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])


def phase_build() -> None:
    log_card()
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(logs)} kernel(s) compiled in {time.perf_counter() - t0:.1f}s "
        f"into {_build.BUILD_DIR}")
    # the host libraries too, before any server marks its warm-up complete
    for load in (native_libs.load_bucketize, native_libs.load_eventlog):
        if load() is None:
            fail(f"[build] {load.__name__}: the C++ library did not build")
    for name, text in logs.items():
        entry = ""
        for line in text.splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                entry = found.group(1)  # mangled: flash_fwd_bf16_wgmmaILi64EE... is D=64
            elif "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build] {name} {entry}: {line.strip()}")


def phase_kernel_vs_plain() -> float:
    """Returns the max abs error at the serving shape."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    # (label, B, H, S, D, dtype, causal, mask) — mask "pad": each row a
    # different real length, row 1 fully masked; "left": the first keys
    # masked, so the first causal rows see no key at all; an int n: the
    # first n keys real and the rest right-padded, as a served history
    cases = [
        # the trained dense model's serving shape (max_len 256): a short
        # item-list query and a long user history
        ("trained serving (1,4,256,64) bf16 causal, 3 real keys",
         1, 4, 256, 64, torch.bfloat16, True, 3),
        ("trained serving (1,4,256,64) bf16 causal, 200 real keys",
         1, 4, 256, 64, torch.bfloat16, True, 200),
        ("causal f32 D64 padded", 2, 2, 256, 64, torch.float32, True, "pad"),
        # bf16 (wgmma) edges: a tile of 17 keys, one past a tile, a ring
        # wrapped many times, every head dim both ways, masked rows
        ("S=17 causal bf16 D64", 1, 2, 17, 64, torch.bfloat16, True, None),
        ("S=2049 causal bf16 D64 left-masked", 2, 2, 2049, 64, torch.bfloat16, True, "left"),
        ("S=8192 causal bf16 D64", 1, 2, 8192, 64, torch.bfloat16, True, None),
        ("causal bf16 D16 padded", 2, 2, 300, 16, torch.bfloat16, True, "pad"),
        ("non-causal bf16 D16 left-masked", 2, 2, 300, 16, torch.bfloat16, False, "left"),
        ("causal bf16 D32 left-masked", 2, 2, 300, 32, torch.bfloat16, True, "left"),
        ("non-causal bf16 D32 padded", 2, 2, 300, 32, torch.bfloat16, False, "pad"),
        ("causal bf16 D64 padded", 2, 2, 300, 64, torch.bfloat16, True, "pad"),
        ("non-causal bf16 D64 left-masked", 2, 2, 300, 64, torch.bfloat16, False, "left"),
        ("non-causal f32 D64 padded", 2, 2, 256, 64, torch.float32, False, "pad"),
        ("causal f32 D16 left-masked", 2, 3, 192, 16, torch.float32, True, "left"),
        ("causal bf16 D16", 1, 2, 512, 16, torch.bfloat16, True, None),
        ("non-causal bf16 D128 padded", 2, 2, 384, 128, torch.bfloat16, False, "pad"),
        ("causal bf16 D128 left-masked", 2, 2, 256, 128, torch.bfloat16, True, "left"),
        ("ragged S=1000 causal f32 D32 padded", 2, 2, 1000, 32, torch.float32, True, "pad"),
        ("ragged S=1000 non-causal bf16 D64", 1, 4, 1000, 64, torch.bfloat16, False, None),
        ("serving (1,4,2048,64) bf16 causal", 1, 4, 2048, 64, torch.bfloat16, True, None),
        ("bucket (8,4,2048,64) bf16 causal padded", 8, 4, 2048, 64, torch.bfloat16, True, "pad"),
        # the sessionrec evaluation's bucket: 64 held-out users, each with
        # a full 2,048-item history (phase 14)
        ("eval bucket (64,4,2048,64) bf16 causal", 64, 4, 2048, 64, torch.bfloat16, True, None),
        # the quickstart walk-through's engine (d_model 32, 2 heads,
        # max_len 16; phase 36): every key real, and a served history of
        # 12 views right-padded
        ("(1,2,16,16) bf16 causal, the quickstart's serving shape",
         1, 2, 16, 16, torch.bfloat16, True, None),
        ("(1,2,16,16) bf16 causal, the quickstart's serving shape, 12 real keys",
         1, 2, 16, 16, torch.bfloat16, True, 12),
        # a head dim with no kernel of its own (the SASRec paper's 50):
        # zero-padded into the D=64 kernel at its own scale 1/sqrt(50)
        ("causal bf16 D50 padded (the D=64 kernel)", 2, 1, 300, 50, torch.bfloat16, True, "pad"),
        ("causal f32 D50 left-masked (the D=64 kernel)",
         2, 1, 300, 50, torch.float32, True, "left"),
    ] + [
        # the buckets batched serving dispatches (phase 17), each row with
        # its own real length, right-padded, as served sessions of 1-2,048
        # items give them
        (f"serving bucket ({B},4,2048,64) bf16 causal, mixed lengths",
         B, 4, 2048, 64, torch.bfloat16, True, "mixed") for B in MIXED_BUCKETS
    ]
    serving_err = None
    for label, B, H, S, D, dtype, causal, kind in cases:
        q, k, v = qkv(B, H, S, D, dtype, gen)
        mask = None
        if kind == "pad":
            lengths = torch.linspace(S, S // 3, B).long()
            mask = (torch.arange(S)[None, :] < lengths[:, None]).float().to(DEVICE)
            if B > 1:
                mask[1] = 0.0
        elif kind == "left":
            mask = torch.ones((B, S), device=DEVICE)
            mask[:, : S // 4] = 0.0
        elif isinstance(kind, int):
            mask = torch.zeros((B, S), device=DEVICE)
            mask[:, :kind] = 1.0
        elif kind == "mixed":
            mask = mixed_length_mask(B, S)
        got = flash_ops.flash_attention(q, k, v, causal=causal, kv_mask=mask)
        want = flash_ops.flash_attention_reference(q, k, v, causal=causal, kv_mask=mask)
        torch.cuda.synchronize()
        atol, rtol = TOL[dtype]
        err = (got.float() - want.float()).abs().max().item()
        ok = bool(torch.isfinite(got.float()).all()) and torch.allclose(
            got.float(), want.float(), atol=atol, rtol=rtol)
        log(f"[check] {label}: max_abs_err={err:.3e} tol=atol {atol:g} + rtol {rtol:g}"
            f" {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"flash_attention kernel disagrees with its plain version: {label}")
        if kind == "pad" and B > 1 and got[1].abs().max().item() != 0.0:
            fail(f"fully-masked row not zero: {label}")
        if kind == "left" and causal and got[:, :, : S // 4].abs().max().item() != 0.0:
            fail(f"causal rows that see no key not zero: {label}")
        if label.startswith("serving"):
            serving_err = err
    gqa_window_cases(gen)
    return serving_err


def gqa_window_cases(gen: torch.Generator) -> None:
    """The MoE sessionrec cell's flash launches (``models/moe_seqrec``):
    q (16, 32, 8192, 128) over k, v (16, 4, 8192, 128) bf16 causal, rows
    right-padded to real lengths log-uniform over 64-8,192 as the cell's
    histories are, with no window (the full layer) and with the
    1,024-key window (the sliding layers). Each call is one counted
    launch of its kind; the plain version is computed a row and a KV
    head's group of query heads at a time, so its (S, S) logits fit."""
    B, H, H_kv, S, D = 16, 32, 4, 8192, 128
    group = H // H_kv
    lengths = np.geomspace(64, S, B).round().astype(int)
    np.random.default_rng(SEED + 27).shuffle(lengths)
    mask = (torch.arange(S)[None, :] < torch.from_numpy(lengths)[:, None]).float().to(DEVICE)
    q = torch.randn((B, H, S, D), generator=gen, device=DEVICE).bfloat16()
    k, v = (torch.randn((B, H_kv, S, D), generator=gen, device=DEVICE).bfloat16()
            for _ in range(2))
    atol, rtol = TOL[torch.bfloat16]
    for window in (None, 1024):
        kind = "full" if window is None else "window"
        label = (f"GQA ({B},{H}/{H_kv},{S},{D}) bf16 causal, window {window}, "
                 f"real lengths {int(lengths.min())}-{int(lengths.max())}")
        before, before_kind = flash_ops.LAUNCHES, dict(flash_ops.LAUNCHES_BY_KIND)
        got = flash_ops.flash_attention(q, k, v, causal=True, kv_mask=mask, window=window)
        torch.cuda.synchronize()
        counted = {n: flash_ops.LAUNCHES_BY_KIND[n] - before_kind[n] for n in before_kind}
        if flash_ops.LAUNCHES - before != 1 or counted != {n: int(n == kind) for n in counted}:
            fail(f"[check] {label}: counted {flash_ops.LAUNCHES - before} launch(es), "
                 f"by kind {counted}")
        err, ok = 0.0, bool(torch.isfinite(got.float()).all())
        for b in range(B):
            for g in range(H_kv):
                heads = slice(g * group, (g + 1) * group)
                want = flash_ops.flash_attention_reference(
                    q[b:b + 1, heads], k[b:b + 1, g:g + 1], v[b:b + 1, g:g + 1],
                    causal=True, kv_mask=mask[b:b + 1], window=window).float()
                part = got[b:b + 1, heads].float()
                err = max(err, (part - want).abs().max().item())
                ok = ok and torch.allclose(part, want, atol=atol, rtol=rtol)
                del want
        log(f"[check] {label}: max_abs_err={err:.3e} tol=atol {atol:g} + rtol {rtol:g}"
            f" {'ok' if ok else 'MISMATCH'}; one '{kind}' launch counted")
        if not ok:
            fail(f"flash_attention kernel disagrees with its plain version: {label}")


def phase_times() -> dict:
    """Kernel, plain and library times at B=1, B=8 and B=64 (the
    evaluation bucket) (S=2048, D=64, bf16, causal, every key real), at
    the serving buckets B in MIXED_BUCKETS with mixed real lengths
    (the bound counts the pairs of real keys; the kernel computes every
    causal pair, masked or not, and the log gives both bounds),
    then the B=1 envelope at S=512 and 8192. Returns the serving shape's
    numbers for the kernels line."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    atol, rtol = TOL[torch.bfloat16]
    out = {}
    for B in sorted((1, 8, 64) + MIXED_BUCKETS):
        H, S, D, dtype = 4, 2048, 64, torch.bfloat16
        q, k, v = qkv(B, H, S, D, dtype, gen)
        mixed = B in MIXED_BUCKETS
        mask = mixed_length_mask(B, S) if mixed else torch.ones((B, S), device=DEVICE)
        bool_mask = (mask[:, None, None, :] > 0) & torch.ones(
            (S, S), dtype=torch.bool, device=DEVICE).tril()
        res = torch.empty_like(q)
        want = flash_ops.flash_attention_reference(q, k, v, causal=True, kv_mask=mask)
        kernel_ms = time_ms(lambda: flash_ops._launch(q, k, v, mask, res, True))
        if not torch.allclose(res.float(), want.float(), atol=atol, rtol=rtol):
            fail(f"the timed launches disagree with the plain version at ({B},{H},{S},{D})")
        device_ms = profiled_ms(lambda: flash_ops._launch(q, k, v, mask, res, True),
                                "flash_fwd_bf16_wgmma")
        # the plain version runs 0.6-31 ms a call: 20 calls time it well
        # (100 of them took ~6 s of the script at B >= 16)
        plain_ms = time_ms(lambda: flash_ops.flash_attention_reference(
            q, k, v, causal=True, kv_mask=mask), warmup=2, n=PLAIN_TIMED)
        library_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=bool_mask))
        library_causal_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True))
        bound_ms, bound_by = attention_bound_ms(B, H, S, D, dtype, True, mask)
        pairs = attention_pairs(B, S, True, mask)
        full_ms, full_by = attention_bound_ms(B, H, S, D, dtype, True)
        log(f"[time] flash_attention ({B},{H},{S},{D}) bf16 causal"
            f"{', mixed lengths' if mixed else ''}, {LAUNCHES_TIMED} launches: "
            f"kernel_ms={kernel_ms:.4f} "
            f"kernel_device_ms={'not recorded' if device_ms is None else f'{device_ms:.4f}'} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"library_causal_ms={library_causal_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}) "
            f"roofline_share={bound_ms / kernel_ms:.4f} real_pairs={pairs} "
            f"({pairs / attention_pairs(B, S, True):.4f} of causal; every causal pair: "
            f"bound_ms={full_ms:.5f} ({full_by}))")
        out[B] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                      library_ms=library_ms, library_causal_ms=library_causal_ms)
        del bool_mask
    for S in (512, 8192):
        q, k, v = qkv(1, 4, S, 64, torch.bfloat16, gen)
        mask = torch.ones((1, S), device=DEVICE)
        bool_mask = torch.ones((S, S), dtype=torch.bool, device=DEVICE).tril()[None, None]
        res = torch.empty_like(q)
        kernel_ms = time_ms(lambda: flash_ops._launch(q, k, v, mask, res, True))
        device_ms = profiled_ms(lambda: flash_ops._launch(q, k, v, mask, res, True),
                                "flash_fwd_bf16_wgmma")
        library_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=bool_mask))
        library_causal_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True))
        log(f"[envelope] (1,4,{S},64) bf16 causal, {LAUNCHES_TIMED} launches: "
            f"kernel_ms={kernel_ms:.4f} "
            f"kernel_device_ms={'not recorded' if device_ms is None else f'{device_ms:.4f}'} "
            f"library_ms={library_ms:.4f} "
            f"library_causal_ms={library_causal_ms:.4f} "
            f"kernel/library={kernel_ms / library_ms:.3f} "
            f"kernel/library_causal={kernel_ms / library_causal_ms:.3f}")
        del bool_mask
    return out[1]


def _post(port: int, body: dict) -> tuple[int, dict, float]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, doc = resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        status, doc = e.code, json.loads(e.read() or b"{}")
    return status, doc, (time.perf_counter() - t0) * 1e3


def _reference_logits(model, tail: list[int], black: list[int]) -> torch.Tensor:
    """f32 logits (V,) of the served model with the plain attention, masked
    as the algorithm masks them."""
    S, V = model.cfg.max_len, model.cfg.vocab
    hist = torch.zeros((1, S), dtype=torch.long)
    hist[0, : len(tail)] = torch.tensor(tail)
    module = model.as_module()
    with torch.inference_mode():
        h = module(hist.to(DEVICE), attention=flash_ops.flash_attention_reference)
        logits = seqrec.logits_from_hidden(module, h[0, len(tail) - 1])
    vm = torch.zeros(V, device=DEVICE)
    vm[0] = -1e30
    vm[torch.tensor(tail + black, device=DEVICE)] = -1e30
    return logits + vm


def _check_against_plain(model, tail: list[int], black: list[int],
                         served: list[tuple[int, float]], k: int, what: str) -> str:
    """Served (dense id, score) pairs against the same model run with the
    plain attention: no history or black-listed item, the top-k scores
    within SCORE_TOL, and no item left out that beats a served one by
    more. Returns the log fragment."""
    if {i for i, _ in served} & set(tail + black):
        fail(f"{what}: served a history or black-listed item")
    ref = _reference_logits(model, tail, black)
    ref_top = torch.topk(ref, k).indices.tolist()
    kth = ref[ref_top[-1]].item()
    score_err = max(abs(s - ref[i].item()) for i, s in served[:k])
    swapped = {i for i, _ in served[:k]} - set(ref_top)
    worst_swap = min((ref[i].item() - kth for i in swapped), default=0.0)
    # the spread of the reference scores, to read SCORE_TOL against
    valid = ref[ref > -1e29]
    if score_err > SCORE_TOL or worst_swap < -SCORE_TOL:
        fail(f"{what}: served top-{k} disagrees with the plain-attention model")
    return (f"top{k}_same_set={not swapped} max_score_err={score_err:.4f} "
            f"worst_swap={worst_swap:.4f} ref_std={valid.std().item():.4f} "
            f"ref_range={(valid.max() - valid.min()).item():.4f} "
            f"ref_top{k}_gap={ref[ref_top[0]].item() - kth:.4f}")


def phase_serving() -> int:
    cfg = seqrec.SeqRecConfig(**SERVING, dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED)
    item_ids = [f"i{n}" for n in range(1, cfg.vocab)]
    users = [f"u{n}" for n in range(8)]
    histories = {u: [item_ids[j] for j in rng.integers(0, len(item_ids), 2048 + 64 * n)]
                 for n, u in enumerate(users)}
    t0 = time.perf_counter()
    model = sessionrec.init_engine_model(cfg, item_ids, histories, seed=SEED, device=DEVICE)
    model_dir = tempfile.mkdtemp(prefix="seqrec-model-")
    try:
        sessionrec.save_engine_model(model, model_dir)
        log(f"[serve] model saved in {time.perf_counter() - t0:.1f}s")
        pick = [item_ids[j] for j in rng.integers(0, len(item_ids), 300)]
        return serve_and_check(_local(model_dir=model_dir), [
            {"user": "u0", "num": 10},
            {"user": "u1", "num": 5},
            {"user": "u2", "num": 20, "blackList": pick[:30]},
            {"user": "u3", "num": 10},
            {"items": pick[30:130], "num": 10},
            {"items": pick[130:300], "num": 20, "blackList": pick[:10]},
            {"user": "u4", "num": 5, "blackList": pick[200:220]},
            {"user": "u5", "num": 10},
            {"user": "u6", "num": 20},
            {"user": "u7", "num": 10},
        ], "serve")
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)


def _local(**fields) -> ServerConfig:
    """A ServerConfig on a free local port, on the card."""
    return ServerConfig(ip="127.0.0.1", port=0, device=DEVICE, **fields)


def serve_and_check(config: ServerConfig, queries: list[dict], tag: str,
                    storage=None) -> int:
    """Deploy what ``config`` names (a model directory, or an engine
    instance in ``storage``) through the port's engine server, POST the
    queries and check every answer: n_layers kernel launches each, no
    history or black-listed item, the top-k within SCORE_TOL of the same
    model run with the plain attention. Returns the kernel's launches."""
    t0 = time.perf_counter()
    server = create_engine_server(storage, config).start()
    try:
        port = server.port
        deployed = server.deployed.models[0]
        cfg = deployed.cfg
        log(f"[{tag}] deployed and listening on :{port} in {time.perf_counter() - t0:.1f}s")
        # warm-up (first CUDA calls, allocator): outside the counted run
        status, _, _ = _post(port, queries[0])
        if status != 200:
            fail(f"warm-up query answered {status}")

        flash_ops.LAUNCHES = 0
        answers, rtts, per_query = [], [], []
        for body in queries:
            before = flash_ops.LAUNCHES
            status, doc, ms = _post(port, body)
            per_query.append(flash_ops.LAUNCHES - before)
            answers.append((status, doc))
            rtts.append(ms)
        launches = flash_ops.LAUNCHES

        index = deployed.item_index
        for body, (status, doc), n, ms in zip(queries, answers, per_query, rtts):
            if status != 200:
                fail(f"query {body} answered {status}: {doc}")
            scores = doc.get("itemScores", [])
            if len(scores) != body["num"]:
                fail(f"query asked num={body['num']}, got {len(scores)} itemScores")
            if n != cfg.n_layers:
                fail(f"query {body} launched the kernel {n} times, expected {cfg.n_layers}")
            tail = ([index[i] for i in body["items"]] if "items" in body
                    else deployed.histories[body["user"]])[-cfg.max_len:]
            black = [index[i] for i in body.get("blackList", [])]
            agreement = _check_against_plain(
                deployed, tail, black, [(index[s["item"]], s["score"]) for s in scores],
                min(10, body["num"]), f"{tag} {body}")
            log(f"[{tag}] {json.dumps(body)[:60]}...: launches={n} {agreement} rtt_ms={ms:.2f}")
        log(f"[{tag}] {len(queries)} queries, launches={launches} "
            f"({launches / len(queries):g} per query), http_p50_ms={statistics.median(rtts):.3f} "
            f"http_min_ms={min(rtts):.3f} http_max_ms={max(rtts):.3f}")
        return launches
    finally:
        server.stop()


def _walk_storage(n_users: int, length: int, stride: int):
    """A memory event store in which user u views item
    i{(stride·u + t) mod 49,999 + 1} at second t, for t < length."""
    storage = memory_storage()
    app_id = storage.get_meta_data_apps().insert(App(0, "SmokeApp"))
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
    events = [Event(event="view", entity_type="user", entity_id=f"u{u}",
                    target_entity_type="item",
                    target_entity_id=f"i{(stride * u + t) % N_ITEMS + 1}",
                    event_time=t0 + timedelta(seconds=length * u + t))
              for u in range(n_users) for t in range(length)]
    storage.get_events().init(app_id)
    storage.get_events().insert_batch(events, app_id)
    return storage, len(events)


def phase_run_train(tag: str, n_users: int, length: int, stride: int, params: dict):
    """Events → run_train → an engine instance in the memory store, on
    the card; checks the derived vocab, that no training path launched
    the flash kernel, and that every loss is finite. Returns (the
    run's losses and step times, the storage, the instance id)."""
    t0 = time.perf_counter()
    storage, n_events = _walk_storage(n_users, length, stride)
    log(f"[{tag}] {n_events} events ingested in {time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    flash_ops.LAUNCHES = 0
    outcome = run_train(variant={
        "engineFactory": "predictionio_tpu_torch.templates.sessionrec.engine_factory",
        "datasource": {"params": {"app_name": "SmokeApp"}},
        "algorithms": [{"name": "seqrec", "params": params}],
    }, ctx=EngineContext(storage=storage, device=DEVICE))
    if flash_ops.LAUNCHES:
        fail(f"training launched the forward-only flash kernel {flash_ops.LAUNCHES} times")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model = outcome.models[0]
    run = model.train_run
    if model.cfg.vocab != N_ITEMS + 1 or outcome.status != "COMPLETED":
        fail(f"{tag}: vocab {model.cfg.vocab}, status {outcome.status}")
    step = statistics.median(run.step_seconds)
    tokens = params["batch_size"] * params["max_len"]
    log(f"[{tag}] vocab={model.cfg.vocab} steps={len(run.losses)} "
        f"stages: {format_stage_times(outcome.stage_seconds)}")
    log(f"[{tag}] stage_seconds={json.dumps(outcome.stage_seconds)}")
    log(f"[{tag}] step_ms median={step * 1e3:.3f} min={min(run.step_seconds) * 1e3:.3f} "
        f"max={max(run.step_seconds) * 1e3:.3f} (first step {run.step_seconds[0] * 1e3:.3f}) "
        f"tokens_per_s={tokens / step:.0f} peak_mem_gb={peak_gb:.3f} "
        f"loss_first={run.losses[0]:.5f} loss_last={run.losses[-1]:.5f}")
    if not all(math.isfinite(x) for x in run.losses):
        fail(f"{tag}: a loss is not finite: {run.losses}")
    return run, storage, outcome.instance_id


def _config(params: dict) -> seqrec.SeqRecConfig:
    return seqrec.SeqRecConfig(vocab=N_ITEMS + 1, max_len=params["max_len"],
                               d_model=params["d_model"], n_heads=params["n_heads"],
                               n_layers=params["n_layers"], dtype=torch.bfloat16)


def _random_batch(params: dict, seed: int):
    """A trainable model at the config of ``params`` with init_params
    from SEED, and a batch of item ids drawn as bench.py draws them."""
    cfg, batch = _config(params), params["batch_size"]
    model = seqrec.SeqRec(cfg, DEVICE)
    model.load_state_dict(seqrec.init_params(cfg, torch.Generator().manual_seed(SEED)))
    rng = np.random.default_rng(seed)
    seqs, tgts = (torch.from_numpy(rng.integers(1, cfg.vocab, (batch, cfg.max_len))).to(DEVICE)
                  for _ in range(2))
    return model.requires_grad_(), seqs, tgts


def _loss_and_grads(model, seqs, tgts, attention=None):
    model.zero_grad(set_to_none=True)
    loss = seqrec.next_item_loss(model, seqs, tgts, attention=attention)
    loss.backward()
    return loss.item(), [p.grad.clone() for p in model.parameters()]


def _compare_training(tag: str, got, want) -> None:
    loss_err = abs(got[0] - want[0]) / abs(want[0])
    grad_err = max((a - b).norm().item() / b.norm().item() for a, b in zip(got[1], want[1]))
    finite = math.isfinite(got[0]) and all(bool(torch.isfinite(g).all()) for g in got[1])
    log(f"[{tag}] loss {got[0]:.6f} vs {want[0]:.6f}: rel_err={loss_err:.3e} "
        f"(tol {TRAIN_LOSS_RTOL:g}); worst gradient rel_err={grad_err:.3e} "
        f"(tol {TRAIN_GRAD_RTOL:g})")
    if not finite or loss_err > TRAIN_LOSS_RTOL or grad_err > TRAIN_GRAD_RTOL:
        fail(f"{tag}: the two computations disagree")


def _timed_steps(tag: str, model, seqs, tgts, n: int) -> None:
    step = seqrec.make_train_step(model)
    opt_m, opt_v = seqrec.adam_state(model)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for it in range(1, n + 1):
        t0 = time.perf_counter()
        losses.append(step(opt_m, opt_v, it, seqs, tgts, 1e-3).item())
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"[{tag}] {n} make_train_step steps: step_ms median={med * 1e3:.3f} "
        f"all={[round(t * 1e3, 3) for t in times]} tokens_per_s={seqs.numel() / med:.0f} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.3f} losses={losses}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{tag}: a loss is not finite")


def phase_long_context() -> None:
    """One step's loss and gradients through the blockwise route against
    the same step forced through full attention, then 4 timed steps."""
    model, seqs, tgts = _random_batch(TRAIN_LONG, 6)
    blockwise = _loss_and_grads(model, seqs, tgts)
    full = _loss_and_grads(model, seqs, tgts, attention=full_attention)
    _compare_training("long/blockwise-vs-full", blockwise, full)
    del blockwise, full
    _timed_steps("long/random-ids", model, seqs, tgts, 4)
    _profile_steps("long/profile", model, seqs, tgts, 3)


def phase_tiled_loss_and_profile() -> None:
    """The tiled loss forced at the dense shape against the flat loss,
    then a profiler trace of dense training steps."""
    model, seqs, tgts = _random_batch(TRAIN_DENSE, 7)
    (b, s), v = seqs.shape, model.cfg.vocab
    flat = _loss_and_grads(model, seqs, tgts)
    budget = seqrec._LOSS_TILE_BYTES
    tile = s // 8                                           # 32 at S = 256
    seqrec._LOSS_TILE_BYTES = b * tile * v * 4
    try:
        if seqrec._pick_loss_tile(b, s, v) != tile:
            fail(f"the lowered budget did not force a loss tile of {tile}")
        tiled = _loss_and_grads(model, seqs, tgts)
    finally:
        seqrec._LOSS_TILE_BYTES = budget
    _compare_training("dense/tiled-vs-flat", tiled, flat)
    del flat, tiled
    _profile_steps("dense/profile", model, seqs, tgts, 3)


def _profile_steps(tag: str, model, seqs, tgts, n: int) -> None:
    """After two warm-up steps, n Adam steps each timed alone between CUDA
    events without the profiler (the step's wall time as the card sees
    it), then torch.profiler over n more: device time per step, the
    device's busy share (device time over the unprofiled step, since the
    profiler slows the host), the tied-logits products' share (the
    aten::mm calls with a vocab-sized operand, forward and backward),
    and the kernels that take the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    v = model.cfg.vocab
    step = seqrec.make_train_step(model)
    opt_m, opt_v = seqrec.adam_state(model)
    for it in (1, 2):
        step(opt_m, opt_v, it, seqs, tgts, 1e-3).item()
    plain_ms = []
    for it in range(3, 3 + n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        step(opt_m, opt_v, it, seqs, tgts, 1e-3)
        end.record()
        end.synchronize()
        plain_ms.append(start.elapsed_time(end))
    step_ms = statistics.median(plain_ms)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for it in range(3 + n, 3 + 2 * n):
            step(opt_m, opt_v, it, seqs, tgts, 1e-3)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / n / 1e3
    logits_ms = sum(e.device_time_total for e in prof.key_averages(group_by_input_shape=True)
                    if e.key == "aten::mm" and any(isinstance(shape, list) and v in shape
                                                   for shape in e.input_shapes)) / n / 1e3
    log(f"[{tag}] per step (unprofiled, CUDA events, {n} steps): step_ms median={step_ms:.3f} "
        f"all={[round(t, 3) for t in plain_ms]}")
    if device_ms <= 0:
        log(f"[{tag}] torch.profiler recorded no device time; wall_ms={wall_ms:.3f}")
        return
    log(f"[{tag}] per step (profiled, {n} steps): wall_ms={wall_ms:.3f} "
        f"device_ms={device_ms:.3f} device_busy_share={device_ms / step_ms:.4f} "
        f"(of the unprofiled step; {device_ms / wall_ms:.4f} of the profiled wall) "
        f"kernel_launches={sum(e.count for e in kernels) // n} "
        f"logits_mm_device_ms={logits_ms:.3f} logits_share_of_device={logits_ms / device_ms:.4f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[{tag}]   {e.self_device_time_total / n / 1e3:9.3f} ms/step  "
            f"{e.count // n:5d} launches/step  {e.key[:90]}")


def phase_logits_product() -> None:
    """The dense step's tied-logits product, (64·256, 256) × (256, 50,000),
    as the path computes it (bf16-rounded operands as f32, TF32 off: the
    CUDA cores) and as a bf16 tensor-core product with f32 output."""
    p = TRAIN_DENSE
    rows, d, v = p["batch_size"] * p["max_len"], p["d_model"], N_ITEMS + 1
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    h = torch.randn((rows, d), generator=gen, device=DEVICE).to(torch.bfloat16)
    emb = (torch.randn((v, d), generator=gen, device=DEVICE) / 16).to(torch.bfloat16)
    hf, ef = h.float(), emb.float()
    flops = 2 * rows * d * v
    f32_ms = time_ms(lambda: hf @ ef.T, warmup=3, n=20)
    f32_bound = max(flops / PEAK_FLOPS[torch.float32],
                    ((rows + v) * d * 4 + rows * v * 4) / PEAK_BYTES) * 1e3
    line = (f"[logits] ({rows},{d})x({d},{v}) f32 path: ms={f32_ms:.4f} "
            f"bound_ms={f32_bound:.4f} tflops={flops / f32_ms / 1e9:.1f}")
    try:
        tc = torch.mm(h, emb.T, out_dtype=torch.float32)
    except (TypeError, RuntimeError) as e:
        log(line + f"; bf16 tensor cores with f32 output: not available "
            f"({str(e).splitlines()[0][:160]})")
        return
    err = (tc - hf @ ef.T).abs().max().item()
    tc_ms = time_ms(lambda: torch.mm(h, emb.T, out_dtype=torch.float32), warmup=3, n=20)
    tc_bound = max(flops / PEAK_FLOPS[torch.bfloat16],
                   ((rows + v) * d * 2 + rows * v * 4) / PEAK_BYTES) * 1e3
    log(line + f"; bf16 tensor cores, f32 out (yardstick): ms={tc_ms:.4f} "
        f"bound_ms={tc_bound:.4f} tflops={flops / tc_ms / 1e9:.1f} "
        f"max_abs_diff_vs_f32={err:.3e}")


def phase_training() -> int:
    """Phases 5-8; returns the flash kernel's launches in serving the
    trained model."""
    run, storage, instance_id = phase_run_train("train/dense", *DENSE_WALK, TRAIN_DENSE)
    steps = -(-DENSE_WALK[0] // TRAIN_DENSE["batch_size"])
    if len(run.losses) != steps or not run.losses[-1] < run.losses[0]:
        fail(f"train/dense: expected {steps} steps with a falling loss: {run.losses}")
    phase_run_train("train/long", *LONG_WALK, TRAIN_LONG)
    phase_long_context()
    phase_tiled_loss_and_profile()
    phase_logits_product()
    torch.cuda.empty_cache()
    users, _, stride = DENSE_WALK
    walk = [f"i{(stride * 300 + t) % N_ITEMS + 1}" for t in range(120)]
    rng = np.random.default_rng(SEED + 3)
    pick = [f"i{j}" for j in rng.integers(1, N_ITEMS + 1, 200)]
    return serve_and_check(_local(engine_instance_id=instance_id), [
        {"user": "u0", "num": 10},
        {"user": "u1", "num": 5},
        {"user": f"u{users // 2}", "num": 20, "blackList": pick[:30]},
        {"items": walk[:50], "num": 10},
        {"items": pick[30:130], "num": 20, "blackList": walk[50:60]},
        {"user": f"u{users - 1}", "num": 5, "blackList": pick[130:150]},
        {"items": walk[60:63], "num": 10},
        {"user": f"u{users // 13}", "num": 20},
        {"user": f"u{users * 7 // 8}", "num": 10},
    ], "serve-trained", storage)


def make_ratings(users: int, items: int, nnz: int, seed: int = 0):
    """bench.py's power-law (user, item, rating) triples, ratings 0.5-5."""
    rng = np.random.default_rng(seed)
    u = (users * rng.random(nnz) ** 1.8).astype(np.int32)
    i = (items * rng.random(nnz) ** 1.8).astype(np.int32)
    v = rng.integers(1, 11, size=nnz).astype(np.float32) / 2.0
    return u, i, v


def _events_ms(fn) -> tuple[float, object]:
    """(ms, result) of one call between CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


#: the NumPy path's check of the native packer runs on this prefix of
#: phase 9's COO (cut from all 20M ratings, whose NumPy packing took
#: 11.4-14.5 s of the script, to make room for phase 27)
LADDER_CHECK_RATINGS = 4_000_000


def ladder_native_vs_numpy(tag: str, coo: als.RatingsCOO):
    """Both orientations of ``coo`` packed by ``ladder_rows`` through the
    native packer (it must serve both: ``als.NATIVE_LADDERS`` moves by 2);
    then both orientations of the COO's first LADDER_CHECK_RATINGS
    ratings through the native packer and the NumPy path, whose layouts
    must be equal array for array. Returns (by user, by item, native
    seconds)."""
    before = als.NATIVE_LADDERS
    t0 = time.perf_counter()
    native = als.ladder_rows(coo), als.ladder_rows(coo.transpose())
    t_native = time.perf_counter() - t0
    if als.NATIVE_LADDERS != before + 2:
        fail(f"[{tag}] the native packer served {als.NATIVE_LADDERS - before} of 2 layouts")
    n = min(LADDER_CHECK_RATINGS, coo.nnz)
    sub = als.RatingsCOO(coo.rows[:n], coo.cols[:n], coo.vals[:n], coo.num_rows, coo.num_cols)
    t0 = time.perf_counter()
    sub_native = als.ladder_rows(sub), als.ladder_rows(sub.transpose())
    t_sub = time.perf_counter() - t0
    t0 = time.perf_counter()
    numpy_path = (als.ladder_rows(sub, use_native=False),
                  als.ladder_rows(sub.transpose(), use_native=False))
    t_numpy = time.perf_counter() - t0
    for side, got, want in zip(("user", "item"), sub_native, numpy_path):
        if len(got.buckets) != len(want.buckets) or any(
                not np.array_equal(getattr(g, f), getattr(w, f)) or
                getattr(g, f).dtype != getattr(w, f).dtype
                for g, w in zip(got.buckets, want.buckets)
                for f in ("row_ids", "cols", "vals", "deg")):
            fail(f"[{tag}] the native {side} layout differs from the NumPy path's")
    log(f"[{tag}] ladder_rows of {coo.nnz} ratings, both orientations: native "
        f"{t_native:.3f}s; of the first {n}: native {t_sub:.3f}s, NumPy {t_numpy:.3f}s "
        f"({t_numpy / t_sub:.1f}x), layouts equal array for array "
        f"({len(sub_native[0].buckets)} + {len(sub_native[1].buckets)} buckets)")
    return native[0], native[1], t_native


def _row_locator(bucketed: als.BucketedRatings):
    """row -> (cols, vals) of its real ratings, from the host buckets."""
    where = {}
    for b in bucketed.buckets:
        for slot, row in enumerate(b.row_ids):
            where[int(row)] = (b, slot)

    def rated(row: int):
        b, slot = where[row]
        d = int(b.deg[slot])
        return b.cols[slot, :d], b.vals[slot, :d]
    return rated, np.fromiter(where, dtype=np.int64)


def _f64_half_step_err(V: torch.Tensor, X: torch.Tensor, rated, rows: np.ndarray,
                       lam: float) -> np.ndarray:
    """Per-row relative error of the solved rows X[rows] against float64
    Cholesky solves of the ALS-WR normal equations built on the host from
    the same V."""
    Vd = V.double().cpu().numpy()
    got = X[torch.from_numpy(rows).to(X.device)].double().cpu().numpy()
    errs = np.empty(len(rows))
    k = Vd.shape[1]
    for j, row in enumerate(rows):
        cols, vals = rated(int(row))
        F = Vd[cols]
        A = F.T @ F + lam * len(cols) * np.eye(k)
        chol = np.linalg.cholesky(A)
        want = np.linalg.solve(chol.T, np.linalg.solve(chol, F.T @ vals.astype(np.float64)))
        errs[j] = np.linalg.norm(got[j] - want) / np.linalg.norm(want)
    return errs


def _normal_systems(rng, batch: int, rank: int, deg_lo: int, deg_hi: int, lam: float):
    """ALS-WR normal systems as tests/test_als.py builds them:
    A = FᵀF + λ·deg·I, b = Fᵀr, F standard normal over sqrt(rank)."""
    A = np.empty((batch, rank, rank), dtype=np.float32)
    b = np.empty((batch, rank), dtype=np.float32)
    for j in range(batch):
        deg = int(rng.integers(deg_lo, deg_hi))
        F = (rng.standard_normal((deg, rank)) / np.sqrt(rank)).astype(np.float32)
        r = rng.integers(1, 6, size=deg).astype(np.float32)
        A[j] = F.T @ F + lam * deg * np.eye(rank, dtype=np.float32)
        b[j] = F.T @ r
    return A, b


def _fmt(ms: float | None, digits: int = 3) -> str:
    return "not recorded" if ms is None else f"{ms:.{digits}f}"


def _profile(fn, top: str | None = None) -> tuple[float | None, int]:
    """(device ms, kernel launches) of one call of ``fn`` under
    torch.profiler; with ``top``, the 8 kernels that take the most time
    are logged under that tag. A trace with no device time (it happened
    once on one machine, in a phase that had profiled before) is taken
    again, twice at most; then the device time is None, "not recorded",
    and the CUDA-event times beside it stand alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # the trace's device events summed by kernel name, as key_averages()
        # sums them (same ms and counts, measured on the card) without its
        # event tree: 0.6 s instead of 9 s for a 33,000-launch trace
        kernels: dict[str, list] = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                entry = kernels.setdefault(e.name(), [0, 0])
                entry[0] += 1
                entry[1] += e.duration_ns()
        device_ms = sum(ns for _, ns in kernels.values()) / 1e6
        if device_ms > 0:
            break
    else:
        log("[profile] torch.profiler recorded no device time in 3 traces: not recorded")
        return None, 0
    for name, (count, ns) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8] if top \
            else ():
        log(f"[{top}]   {ns / 1e6:9.3f} ms  {count:6d} launches  {name[:90]}")
    return device_ms, sum(count for count, _ in kernels.values())


def _bound_ms(nbytes: float, bf16_flops: float = 0.0, f32_flops: float = 0.0) -> str:
    """The least time for the work: bytes over the memory rate against
    operations over the peak of their type (PEAK_FLOPS)."""
    t_ops = bf16_flops / PEAK_FLOPS[torch.bfloat16] + f32_flops / PEAK_FLOPS[torch.float32]
    t_bytes = nbytes / PEAK_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return f"{max(t_ops, t_bytes) * 1e3:.4f} ({by})"


def _profile_programs(tag: str, iteration, V_item, V_user, dev_user, dev_item,
                      iter_ms: float) -> tuple[float | None, int]:
    """Device time, launches and bound of the torch code that replaced each
    XLA program of the fused ALS path, for one bf16 iteration at rank
    ALS_RANK: the normal-equation build of every slab, the batched CG on
    the systems it built, and the whole iteration (the fused loop, whose
    remainder is the write-back and the masks); the busy share is the
    iteration's device time over ``iter_ms``, timed without the profiler.
    Returns the iteration's (device ms, launches)."""
    K = ALS_RANK
    halves = ((V_item, dev_user), (V_user, dev_item))

    def build_all():
        out = []
        for V, buckets in halves:
            Vm = V.to(torch.bfloat16)
            for b in buckets.buckets:
                for s in range(b.cols.shape[0]):
                    out.append(als._normal_eq_build(Vm, b.cols[s], b.vals[s], b.deg[s],
                                                    ALS_LAM, 40.0, None, False))
        return out

    systems = build_all()

    def cg_all():
        for A, b in systems:
            als._cg_solve_batched(A, b)

    entries = sum(b.cols.numel() for _, bk in halves for b in bk.buckets)
    rows = sum(b.deg.numel() for _, bk in halves for b in bk.buckets)
    tables = sum(V.numel() for V in (V_item, V_user)) * 4
    steps = min(K + 4, 16)
    build_ms, build_n = _profile(build_all)
    cg_ms, cg_n = _profile(cg_all)
    it_ms, it_n = _profile(iteration, top=tag)
    if None in (build_ms, cg_ms, it_ms):
        log(f"[{tag}] device time by program: not recorded")
        return it_ms, it_n
    log(f"[{tag}] normal-equation build (_normal_eq_build, every slab): device_ms={build_ms:.3f} "
        f"launches={build_n} bound_ms="
        f"{_bound_ms(entries * 8 + rows * (K * K + K) * 4, bf16_flops=entries * (2 * K * K + 2 * K))}")
    log(f"[{tag}] batched CG (_cg_solve_batched, {steps} steps, every slab): "
        f"device_ms={cg_ms:.3f} launches={cg_n} bound_ms="
        f"{_bound_ms(rows * (K * K + 2 * K) * 4, f32_flops=rows * steps * (2 * K * K + 8 * K))}")
    log(f"[{tag}] one iteration (_als_iterate_fused): device_ms={it_ms:.3f} launches={it_n} "
        f"(rest of the loop: {it_ms - build_ms - cg_ms:.3f} ms, "
        f"{it_n - build_n - cg_n} launches) device_busy_share={it_ms / iter_ms:.4f} "
        f"(of the unprofiled {iter_ms:.3f} ms) bound_ms="
        f"{_bound_ms(entries * 8 + 2 * tables, bf16_flops=entries * (2 * K * K + 2 * K), f32_flops=rows * steps * (2 * K * K + 8 * K))}")
    return it_ms, it_n


def phase_als_train() -> dict:
    """Phases 9-10. Returns what serving needs: the ratings and the bf16
    factors; and, under "fused", the bf16 route's ms an iteration, the
    device ms and launches of one profiled iteration and its RMSE."""
    n_users, n_items, nnz = ML20M
    t0 = time.perf_counter()
    coo = als.RatingsCOO(*make_ratings(n_users, n_items, nnz, SEED), n_users, n_items)
    log(f"[als] {nnz} ratings generated in {time.perf_counter() - t0:.1f}s")
    by_user, by_item, t_ladder = ladder_native_vs_numpy("als", coo)
    t0 = time.perf_counter()
    dev_user = als.stage_buckets(by_user, ALS_RANK, device=DEVICE)
    dev_item = als.stage_buckets(by_item, ALS_RANK, device=DEVICE)
    torch.cuda.synchronize()
    t_stage = time.perf_counter() - t0
    slabs = sum(b.cols.shape[0] for b in dev_user.buckets + dev_item.buckets)
    log(f"[als] ladder_rows (native) {t_ladder:.2f}s ({len(by_user.buckets)} user + "
        f"{len(by_item.buckets)} item buckets, {slabs} slabs at rank {ALS_RANK}), "
        f"staging {t_stage:.2f}s")
    z = torch.zeros(1024, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10_000):
        z.add_(1.0)
    torch.cuda.synchronize()
    log(f"[als] host time per small eager launch (10,000 add_): "
        f"{(time.perf_counter() - t0) * 100:.3f} us")
    fl = [als.half_step_flops(b, ALS_RANK) for b in (by_user, by_item)]
    useful = sum(f["useful_flops"] for f in fl)
    executed = sum(f["executed_flops"] for f in fl)
    item0 = als.init_item_factors(n_items, ALS_RANK, SEED).to(DEVICE)

    def train(iters: int, bf16: bool):
        return als._als_iterate_fused(item0, dev_user, dev_item, iters, ALS_LAM, 40.0, False,
                                      bf16=bf16)

    torch.cuda.reset_peak_memory_stats()
    rmse_1 = als.rmse(als.ALSFactors(*train(1, True)), coo)      # warm-up
    results = {}
    for route, bf16 in (("bf16", True), ("f32", False)):
        ms, (user, item) = _events_ms(lambda: train(ALS_TIMED_ITERS, bf16))
        per_iter = ms / ALS_TIMED_ITERS
        err = als.rmse(als.ALSFactors(user, item), coo)
        results[route] = (per_iter, user, item, err)
        log(f"[als] {route} route, {ALS_TIMED_ITERS} iterations: ms_per_iteration={per_iter:.3f} "
            f"ratings_per_s={nnz / (per_iter / 1e3):.0f} "
            f"useful_tflops={useful / (per_iter / 1e3) / 1e12:.4f} "
            f"executed_tflops={executed / (per_iter / 1e3) / 1e12:.4f} rmse={err:.5f}")
    log(f"[als] peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.3f} "
        f"rmse first iteration={rmse_1:.5f}")
    bf16_ms, user, item, rmse_bf16 = results["bf16"]
    rmse_f32 = results["f32"][3]
    if not (math.isfinite(rmse_bf16) and rmse_bf16 < rmse_1):
        fail(f"ALS RMSE {rmse_bf16} is not finite and below the first iteration's {rmse_1}")
    if abs(rmse_bf16 - rmse_f32) > RMSE_BF16_TOL:
        fail(f"bf16 RMSE {rmse_bf16} vs f32 {rmse_f32}: more than {RMSE_BF16_TOL} apart")
    log(f"[als] |rmse bf16 - f32| = {abs(rmse_bf16 - rmse_f32):.3e} (tol {RMSE_BF16_TOL})")
    it_ms, it_n = _profile_programs("als/profile", lambda: train(1, True), item, user,
                                    dev_user, dev_item, bf16_ms)
    fused = {"ms": bf16_ms, "launches": it_n, "device_ms": it_ms, "rmse": rmse_bf16}

    rated, active = _row_locator(by_user)
    rng = np.random.default_rng(SEED + 4)
    f32_item = results["f32"][2]
    X = als.solve_half(f32_item, dev_user, ALS_RANK, ALS_LAM, matmul_dtype="float32",
                       cg_matvec_dtype="float32")
    errs = _f64_half_step_err(f32_item, X, rated,
                              rng.choice(active, CG_CHECK_ROWS[0], replace=False), ALS_LAM)
    log(f"[als] f32 CG half-step vs float64 Cholesky on {CG_CHECK_ROWS[0]} rows: "
        f"max_rel_err={errs.max():.3e} median={np.median(errs):.3e} (tol {CG_F32_RTOL:g})")
    if not errs.max() <= CG_F32_RTOL:
        fail("the f32 CG half-step disagrees with float64")
    del X, results, dev_user, dev_item
    torch.cuda.empty_cache()

    # rank 200: the "auto" CG matvec streams A in bf16
    dev_user = als.stage_buckets(by_user, RANK200, device=DEVICE)
    dev_item = als.stage_buckets(by_item, RANK200, device=DEVICE)
    item0_200 = als.init_item_factors(n_items, RANK200, SEED).to(DEVICE)

    def train200(iters: int, cg_matvec: str = "auto"):
        return als._als_iterate_fused(item0_200, dev_user, dev_item, iters, ALS_LAM, 40.0,
                                      False, bf16=True,
                                      cg_bf16=als._resolve_cg_matvec(cg_matvec, RANK200))

    torch.cuda.reset_peak_memory_stats()
    dev200_ms, launches200 = _profile(lambda: train200(1))     # and the warm-up
    ms, (_, item200) = _events_ms(lambda: train200(RANK200_ITERS))
    log(f"[als200] {RANK200_ITERS} iterations (bf16 CG matvec, the auto policy): "
        f"ms_per_iteration={ms / RANK200_ITERS:.3f} "
        f"ratings_per_s={nnz / (ms / RANK200_ITERS / 1e3):.0f} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.3f}; one profiled iteration "
        f"(bf16 matvec, run first): launches={launches200} device_ms={_fmt(dev200_ms)} "
        f"device_busy_share={_fmt(dev200_ms and dev200_ms / (ms / RANK200_ITERS), 4)}")
    # the bf16 matvec on the system families the JAX package measured it
    # on (tests/test_als.py _normal_systems; ops/als.py:800-806)
    for lo, hi, lam in ((800, 2000, 0.08), (100, 400, 0.01)):
        A, b = _normal_systems(rng, 32, RANK200, lo, hi, lam)
        exact = np.linalg.solve(A.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
        x = als._cg_solve_batched(torch.from_numpy(A).to(DEVICE), torch.from_numpy(b).to(DEVICE),
                                  bf16_matvec=True).double().cpu().numpy()
        err = (np.linalg.norm(x - exact, axis=-1) / np.linalg.norm(exact, axis=-1)).max()
        log(f"[als200] bf16 CG matvec on JAX's systems (degree {lo}-{hi}, lambda {lam}): "
            f"max_rel_err={err:.3e} (tol {CG_BF16_RTOL:g})")
        if not err <= CG_BF16_RTOL:
            fail(f"the rank-{RANK200} bf16 CG matvec is more than {CG_BF16_RTOL} from float64")
    # and on rows of the ML-20M shape: f32 build, either matvec
    rows = rng.choice(active, CG_CHECK_ROWS[1], replace=False)
    heavy = np.asarray([len(rated(int(r))[0]) >= 100 for r in rows])
    for matvec in ("bfloat16", "float32"):
        half_ms, X = _events_ms(lambda: als.solve_half(
            item200, dev_user, RANK200, ALS_LAM, matmul_dtype="float32",
            cg_matvec_dtype=matvec))
        errs = _f64_half_step_err(item200, X, rated, rows, ALS_LAM)
        log(f"[als200] {matvec} CG matvec, ML-20M user half-step (f32 build) in "
            f"{half_ms:.3f} ms; vs float64 on {len(rows)} "
            f"rows: max_rel_err={errs.max():.3e} median={np.median(errs):.3e}; max over the "
            f"{heavy.sum()} rows of degree >= 100: "
            f"{errs[heavy].max() if heavy.any() else float('nan'):.3e}")
        if not errs.max() <= RANK200_ROWS_RTOL:
            fail(f"the rank-{RANK200} half-step is more than {RANK200_ROWS_RTOL} from float64")
    del dev_user, dev_item, X
    torch.cuda.empty_cache()
    return {"coo": coo, "user": user, "item": item, "fused": fused}


def _seen_lists(coo: als.RatingsCOO, rows) -> dict[int, np.ndarray]:
    """Sorted distinct items of each of ``rows``, from the COO."""
    order = np.argsort(coo.rows, kind="stable")
    su, si = coo.rows[order], coo.cols[order]
    # the probes in the table's own dtype: a mixed-dtype search casts
    # the whole 20M-row table on every call
    users = np.unique(np.asarray(rows)).astype(su.dtype)
    los, his = np.searchsorted(su, users), np.searchsorted(su, users, side="right")
    return {int(u): np.unique(si[lo:hi]).astype(np.int32)
            for u, lo, hi in zip(users, los, his)}


def _reference_topk(model: ALSModel, body: dict, item_f64: np.ndarray):
    """float64 host top-k of one query: every item scored, seen ones and
    those the white/black list rules out dropped. Returns (ids, scores)
    sorted by score, the eligible count, and all eligible scores by id."""
    uix = model.user_ids.get(body["user"])
    if uix is None:
        return [], {}
    scores = item_f64 @ model.user_factors[uix].double().cpu().numpy()
    ok = np.ones(len(scores), dtype=bool)
    ok[model.seen_by_user.get(uix, np.empty(0, np.int64))] = False
    if "whiteList" in body:
        wl = np.zeros_like(ok)
        wl[[model.item_ids[i] for i in body["whiteList"] if i in model.item_ids]] = True
        ok &= wl
    for i in body.get("blackList", []):
        if i in model.item_ids:
            ok[model.item_ids[i]] = False
    inv = model.item_ids.inverse
    eligible = {inv[int(j)]: float(scores[j]) for j in np.nonzero(ok)[0]}
    ranked = sorted(eligible.items(), key=lambda kv: -kv[1])[: body.get("num", 10)]
    return ranked, eligible


def _check_answer(tag: str, body: dict, served: list[tuple[str, float]], model: ALSModel,
                  item_f64: np.ndarray) -> float:
    """The served (item, score) list against the float64 reference: as
    many items, each eligible, scores within ALS_SCORE_TOL of the
    reference, in order, and no item left out that beats a served one by
    more than the tolerance. Returns the largest score difference."""
    ranked, eligible = _reference_topk(model, body, item_f64)
    if len(served) != len(ranked):
        fail(f"{tag} {json.dumps(body)[:80]}: {len(served)} items served, "
             f"reference has {len(ranked)}")
    if not ranked:
        return 0.0
    bad = [i for i, _ in served if i not in eligible]
    if bad:
        fail(f"{tag} {json.dumps(body)[:80]}: served seen, black-listed or "
             f"non-white-listed items {bad[:5]}")
    err = max(abs(s - eligible[i]) for i, s in served)
    scores = [s for _, s in served]
    floor = min(eligible[i] for i, _ in served)
    missed = [i for i, s in ranked if s > floor + ALS_SCORE_TOL and i not in dict(served)]
    if err > ALS_SCORE_TOL or missed or any(a < b - ALS_SCORE_TOL
                                            for a, b in zip(scores, scores[1:])):
        fail(f"{tag} {json.dumps(body)[:80]}: differs from the float64 reference "
             f"(score err {err:.3e}, missed {missed[:5]})")
    return err


def serve_als_and_check(config: ServerConfig, queries: list[dict], tag: str,
                        storage=None) -> dict:
    """Deploy what ``config`` names with the recommendation template
    behind the engine server, POST the queries and hold every answer
    against the float64 reference. Returns the server and its deployed
    engine."""
    t0 = time.perf_counter()
    server = create_engine_server(storage, config).start()
    try:
        port = server.port
        model = server.deployed.models[0]
        log(f"[{tag}] deployed and listening on :{port} in {time.perf_counter() - t0:.1f}s")
        item_f64 = model.item_factors.double().cpu().numpy()
        status, _, _ = _post(port, queries[0])               # warm-up
        if status != 200:
            fail(f"{tag}: warm-up query answered {status}")
        rtts, worst = [], 0.0
        for body in queries:
            status, doc, ms = _post(port, body)
            if status != 200:
                fail(f"{tag}: query {body} answered {status}: {doc}")
            rtts.append(ms)
            served = [(s["item"], s["score"]) for s in doc.get("itemScores", [])]
            worst = max(worst, _check_answer(tag, body, served, model, item_f64))
        log(f"[{tag}] {len(queries)} queries equal to the float64 reference "
            f"(max score err {worst:.3e}, tol {ALS_SCORE_TOL:g}); "
            f"http_p50_ms={statistics.median(rtts):.3f} http_min_ms={min(rtts):.3f} "
            f"http_max_ms={max(rtts):.3f}")
        return {"server": server, "deployed": server.deployed}
    except BaseException:
        server.stop()
        raise


def _same_answer(a, b, tol: float = ALS_SCORE_TOL) -> bool:
    """Two PredictedResults agree: scores within ``tol`` in order, and
    items equal but for near-ties at the boundary."""
    sa = [s.score for s in a.item_scores]
    sb = [s.score for s in b.item_scores]
    if len(sa) != len(sb) or any(abs(x - y) > tol for x, y in zip(sa, sb)):
        return False
    ia = {s.item: s.score for s in a.item_scores}
    ib = {s.item: s.score for s in b.item_scores}
    floor = min(sa, default=0.0)
    return all(abs(s - floor) <= tol
               for s in [ia[i] for i in set(ia) - set(ib)] + [ib[i] for i in set(ib) - set(ia)])


def phase_als_serving(trained: dict) -> ALSModel:
    """Phase 11: the ML-20M model saved, deployed and queried. Returns
    the model (phase 17b serves it under load)."""
    coo, user, item = trained["coo"], trained["user"], trained["item"]
    n_users, n_items, _ = ML20M
    rng = np.random.default_rng(SEED + 5)
    active = np.unique(coo.rows)
    heavy = int(np.bincount(coo.rows).argmax())
    asked = [int(u) for u in rng.choice(active, 20, replace=False)]
    batch_users = [int(u) for u in rng.choice(active, 255, replace=False)] + [heavy]
    seen = _seen_lists(coo, asked + batch_users + [heavy])
    if len(seen[heavy]) <= 512:
        fail(f"the heaviest user has only {len(seen[heavy])} seen items")
    model = ALSModel(rank=ALS_RANK, user_factors=user, item_factors=item,
                     user_ids=EntityIdIxMap(BiMap({f"u{i}": i for i in range(n_users)})),
                     item_ids=EntityIdIxMap(BiMap({f"i{i}": i for i in range(n_items)})),
                     seen_by_user=seen)
    model_dir = tempfile.mkdtemp(prefix="als-model-")
    try:
        t0 = time.perf_counter()
        model.save(model_dir)
        log(f"[als-serve] model saved in {time.perf_counter() - t0:.2f}s "
            f"({len(seen)} users with seen lists; heaviest user u{heavy}: "
            f"{len(seen[heavy])} seen items)")
        picks = [f"i{j}" for j in rng.integers(0, n_items, 400)]
        queries = ([{"user": f"u{u}", "num": 10} for u in asked[:8]]
                   + [{"user": f"u{u}", "num": 100} for u in asked[8:14]]
                   + [{"user": f"u{u}", "num": 1000} for u in asked[14:18]]
                   + [{"user": f"u{asked[18]}", "num": 10, "whiteList": picks[:50]},
                      {"user": f"u{asked[19]}", "num": 100, "whiteList": picks[50:90]},
                      {"user": f"u{asked[0]}", "num": 20, "blackList": picks[90:290]},
                      {"user": f"u{asked[1]}", "num": 10, "whiteList": picks[290:390],
                       "blackList": picks[290:300]},
                      {"user": "nobody", "num": 10},
                      {"user": f"u{heavy}", "num": 10},
                      {"user": f"u{heavy}", "num": 1000},
                      {"user": f"u{heavy}", "num": 10, "blackList": picks[:100]}])
        # black-list each of a few users' own unfiltered top 5
        top = {u: _reference_topk(model, {"user": f"u{u}", "num": 5},
                                  item.double().cpu().numpy())[0] for u in asked[2:6]}
        queries += [{"user": f"u{u}", "num": 10, "blackList": [i for i, _ in t]}
                    for u, t in top.items()]
        handle = serve_als_and_check(_local(model_dir=model_dir, engine_factory=REC_FACTORY),
                                     queries, "als-serve")
        server, deployed = handle["server"], handle["deployed"]
        try:
            batch = [rec.Query(user=f"u{u}", num=10) for u in batch_users]
            t0 = time.perf_counter()
            batched = deployed.query_batch(batch)
            batch_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            single = [deployed.query(q) for q in batch]
            single_s = time.perf_counter() - t0
            differ = [q.user for q, a, b in zip(batch, batched, single) if not _same_answer(a, b)]
            log(f"[als-serve] query_batch of {len(batch)}: {batch_s * 1e3:.3f} ms; the same "
                f"queries one by one: {single_s * 1e3:.3f} ms; answers that differ: {len(differ)}")
            if differ:
                fail(f"query_batch differs from the single path for {differ[:5]}")
            # the device work of one served query: the flat top-k at B=1
            m = deployed.models[0]
            uix = m.user_ids[f"u{asked[0]}"]
            cols = torch.zeros((1, 512), dtype=torch.int32, device=DEVICE)
            mask = torch.zeros((1, 512), device=DEVICE)
            allow = torch.ones((n_items,), device=DEVICE)

            def one_query():
                return topk_ops.recommend_topk(m.user_factors[uix:uix + 1], m.item_factors,
                                               cols, mask, allow, 10)

            call_ms = time_ms(one_query)
            dev_ms, n = _profile(lambda: [one_query() for _ in range(20)])
            log(f"[als-serve] recommend_topk B=1, I={n_items}, k=10: call_ms={call_ms:.4f} "
                f"device_ms={_fmt(dev_ms and dev_ms / 20, 4)} launches={n // 20} bound_ms="
                f"{_bound_ms(n_items * (ALS_RANK + 1) * 4, f32_flops=2 * n_items * ALS_RANK)}")
        finally:
            server.stop()
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    return model


def phase_topk_envelope() -> None:
    """Phase 12: flat vs chunked top-k at B=256 × I=2M, k=10."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    item_f = torch.randn((TOPK_ITEMS, ALS_RANK), generator=gen, device=DEVICE)
    uv = torch.randn((TOPK_BATCH, ALS_RANK), generator=gen, device=DEVICE)
    cols = torch.randint(0, TOPK_ITEMS, (TOPK_BATCH, 32), generator=gen, device=DEVICE)
    mask = (torch.rand((TOPK_BATCH, 32), generator=gen, device=DEVICE) < 0.5).float()
    allow = torch.ones((TOPK_ITEMS,), device=DEVICE)
    fv, fi = topk_ops.recommend_topk(uv, item_f, cols, mask, allow, 10)
    cv, ci = topk_ops.recommend_topk_chunked(uv, item_f, cols, mask, allow, 10)
    v_err = (fv - cv).abs().max().item()
    gap = (fv[:, :-1] - fv[:, 1:]).abs()
    clear = torch.cat([gap[:, :1], torch.minimum(gap[:, 1:], gap[:, :-1]), gap[:, -1:]], 1) > 1e-5
    same = bool((fi[clear] == ci[clear]).all())
    flat_ms = time_ms(lambda: topk_ops.recommend_topk(uv, item_f, cols, mask, allow, 10),
                      warmup=3, n=20)
    chunked_ms = time_ms(lambda: topk_ops.recommend_topk_chunked(uv, item_f, cols, mask,
                                                                 allow, 10), warmup=3, n=20)
    flops = 2 * TOPK_BATCH * TOPK_ITEMS * ALS_RANK
    bound_ms = max(flops / PEAK_FLOPS[torch.float32],
                   (TOPK_ITEMS * (ALS_RANK + 1) * 4) / PEAK_BYTES) * 1e3
    for name, fn in (("flat", topk_ops.recommend_topk),
                     ("chunked", topk_ops.recommend_topk_chunked)):
        dev_ms, n = _profile(lambda: fn(uv, item_f, cols, mask, allow, 10))
        log(f"[topk] {name}: device_ms={_fmt(dev_ms, 4)} launches={n}")
    log(f"[topk] B={TOPK_BATCH} I={TOPK_ITEMS} k=10: flat_ms={flat_ms:.4f} "
        f"chunked_ms={chunked_ms:.4f} bound_ms={bound_ms:.4f} (operations, f32) "
        f"max_value_diff={v_err:.3e} indices_equal_off_ties={same}")
    if v_err > 1e-4 or not same:
        fail("chunked top-k disagrees with the flat path")


def _ml100k_storage():
    """(memory storage, rng): the ML-100k-shaped events in app "ML100k",
    and the generator that drew them, for the draws that follow."""
    n_users, n_items, n_rate, n_buy = ML100K
    rng = np.random.default_rng(SEED + 7)
    # every user rates at least 20 items, as in MovieLens-100k; the rest
    # of the events fall on power-law users and items
    users = np.concatenate([np.repeat(np.arange(n_users), 20),
                            (n_users * rng.random(n_rate - 20 * n_users) ** 1.5).astype(int)])
    items = (n_items * rng.random(n_rate + n_buy) ** 1.5).astype(int)
    stars = rng.integers(1, 6, n_rate)
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
    events = [Event(event="rate", entity_type="user", entity_id=f"u{u}",
                    target_entity_type="item", target_entity_id=f"i{i}",
                    properties=DataMap({"rating": float(r)}),
                    event_time=t0 + timedelta(seconds=n))
              for n, (u, i, r) in enumerate(zip(users, items, stars))]
    events += [Event(event="buy", entity_type="user", entity_id=f"u{u}",
                     target_entity_type="item", target_entity_id=f"i{i}",
                     event_time=t0 + timedelta(seconds=n_rate + n))
               for n, (u, i) in enumerate(zip(rng.integers(0, n_users, n_buy),
                                              items[n_rate:]))]
    t_ingest = time.perf_counter()
    storage = memory_storage()
    app_id = storage.get_meta_data_apps().insert(App(0, "ML100k"))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch(events, app_id)
    log(f"[rec] {len(events)} events ingested in {time.perf_counter() - t_ingest:.1f}s")
    return storage, rng


def phase_recommendation_template() -> None:
    """Phase 13: the recommendation template end to end at the ML-100k shape."""
    n_users, n_items, _, _ = ML100K
    storage, rng = _ml100k_storage()
    outcome = run_train(variant={
        "engineFactory": REC_FACTORY,
        "datasource": {"params": {"appName": "ML100k"}},
        "algorithms": [{"name": "als", "params": {"rank": 10, "numIterations": 10,
                                                  "lambda": 0.01, "seed": 3}}],
    }, ctx=EngineContext(storage=storage, device=DEVICE))
    model = outcome.models[0]
    log(f"[rec] run_train {outcome.status}: {len(model.user_ids)} users, "
        f"{len(model.item_ids)} items; stages: {format_stage_times(outcome.stage_seconds)}")
    log(f"[rec] stage_seconds={json.dumps(outcome.stage_seconds)}")
    if outcome.status != "COMPLETED" or not bool(torch.isfinite(model.item_factors).all()):
        fail("the recommendation template did not train to finite factors")
    handle = serve_als_and_check(_local(engine_instance_id=outcome.instance_id),
                                 _ml100k_queries(rng), "rec-serve", storage)
    handle["server"].stop()


def _ml100k_queries(rng) -> list[dict]:
    """16 queries at the ML-100k shape: known users at num 5-50, white
    and black lists, and an unknown user."""
    n_users, n_items, _, _ = ML100K
    picks = [f"i{j}" for j in rng.integers(0, n_items, 300)]
    return ([{"user": f"u{u}", "num": n} for u, n in
             zip(rng.integers(0, n_users, 12), (10, 20, 5, 50) * 3)]
            + [{"user": "u0", "num": 10, "blackList": picks[:100]},
               {"user": "u1", "num": 10, "whiteList": picks[100:200]},
               {"user": "u2", "num": 20, "whiteList": picks[200:300],
                "blackList": picks[200:230]},
               {"user": "stranger", "num": 10}])


def phase_als() -> tuple[ALSModel, dict]:
    """Phases 9-13; returns the ML-20M-shape model phase 11 served and
    phase 9's fused bf16 numbers (phase 32 logs them)."""
    t0 = time.perf_counter()
    trained = phase_als_train()
    model, fused = phase_als_serving(trained), trained["fused"]
    del trained
    torch.cuda.empty_cache()
    phase_topk_envelope()
    torch.cuda.empty_cache()
    phase_recommendation_template()
    log(f"[als] phases 9-13 took {time.perf_counter() - t0:.1f}s")
    return model, fused


def _timed_engine(engine: Engine, stages: list, engine_cls: type = Engine) -> Engine:
    """An ``engine_cls`` over subclasses of ``engine``'s components whose
    read_eval, prepare, train and batch_predict append (name, seconds,
    result) to ``stages``; the seconds end when the card is done."""

    def timed(cls: type, names: tuple[str, ...]) -> type:
        def wrap(name: str):
            real = getattr(cls, name)

            def method(self, *args):
                t0 = time.perf_counter()
                out = real(self, *args)
                if DEVICE == "cuda":
                    torch.cuda.synchronize()
                stages.append((name, time.perf_counter() - t0, out))
                return out
            return method
        return type(cls.__name__, (cls,), {n: wrap(n) for n in names})

    def timed_map(class_map, *names):
        return {k: timed(c, names) for k, c in class_map.items()}

    return engine_cls(timed_map(engine.data_source_class_map, "read_eval"),
                      timed_map(engine.preparator_class_map, "prepare"),
                      timed_map(engine.algorithm_class_map, "train", "batch_predict"),
                      engine.serving_class_map)


def _bind_timed(evaluation: Evaluation, stages: list, engine_cls: type = Engine) -> list:
    """Rebinds ``evaluation`` to a timed copy of its engine (see
    :func:`_timed_engine`) whose batch_eval keeps what it returns: the
    (EngineParams, folds of (Q, P, A)) pairs, in the list returned."""
    engine = _timed_engine(evaluation.engine, stages, engine_cls)
    evaluation.engine_evaluator = (engine, evaluation.evaluator)
    kept: list = []
    real = engine.batch_eval

    def batch_eval(ctx, engine_params_list):
        kept[:] = real(ctx, engine_params_list)
        return kept
    engine.batch_eval = batch_eval
    return kept


def _log_stages(tag: str, stages: list) -> None:
    for name in ("read_eval", "prepare", "train", "batch_predict"):
        secs = [s for n, s, _ in stages if n == name]
        if secs:
            log(f"[{tag}] {name}: {len(secs)} calls, {sum(secs):.3f}s in all, each "
                f"{[round(s, 3) for s in secs]}")


def _check_outcome(tag: str, storage, outcome, engine: Engine, best_path: str) -> None:
    """The instance row is EVALCOMPLETED and its JSON holds the returned
    result's best index and scores; best.json binds back to the best
    EngineParams through the engine's params_from_variant_json."""
    result = outcome.result
    row = storage.get_meta_data_evaluation_instances().get(outcome.instance_id)
    doc = json.loads(row.evaluator_results_json)
    want = [[ms.score, *ms.other_scores] for _, ms in result.engine_params_scores]
    got = [[p["score"], *p["otherScores"]] for p in doc["engineParamsScores"]]
    if (outcome.status, row.status) != ("EVALCOMPLETED", "EVALCOMPLETED") or \
            doc["bestIdx"] != result.best_idx or got != want or \
            row.evaluator_results != result.to_one_liner():
        fail(f"{tag}: the instance row ({row.status}, bestIdx {doc['bestIdx']}, scores {got}) "
             f"disagrees with the result ({result.best_idx}, {want})")
    with open(best_path) as f:
        best = json.load(f)
    if engine.params_from_variant_json(best_json_variant(best)) != result.best_engine_params:
        fail(f"{tag}: best.json does not bind back to the best EngineParams")
    log(f"[{tag}] instance {outcome.instance_id} EVALCOMPLETED, bestIdx={result.best_idx}, "
        f"best.json binds back ({best['evaluation']})")


def _buckets(n: int) -> int:
    """Forward passes of sessionrec batch_predict for n queries: power-of-two
    buckets of at most 256."""
    return n // 256 + bin(n % 256).count("1")


def phase_eval_sessionrec() -> tuple[int, tuple[int, list, list]]:
    """Phase 14: run_evaluation of the sessionrec template at the serving
    width on the card. Returns the flash kernel's launches in it, and the
    grid's best index, scores and mean top-1 scores (phase 24's first
    serial run)."""
    t0 = time.perf_counter()
    storage, n_events = _walk_storage(*EVAL_WALK)
    log(f"[eval-sess] {n_events} events ingested in {time.perf_counter() - t0:.1f}s")
    out_dir = tempfile.mkdtemp(prefix="eval-sess-")
    try:
        best_path = os.path.join(out_dir, "best.json")
        evaluation = sessionrec.SessionRecEvaluation(k=EVAL_TOPK, output_path=best_path)
        stages: list = []
        kept = _bind_timed(evaluation, stages)
        grid = EngineParamsGenerator([EngineParams.of(
            data_source=sessionrec.DataSourceParams(app_name="SmokeApp", eval_k=EVAL_K),
            algorithms=[("seqrec", sessionrec.AlgorithmParams(**EVAL_POINT, lr=lr))])
            for lr in EVAL_LRS])
        torch.cuda.reset_peak_memory_stats()
        flash_ops.LAUNCHES = 0
        t0 = time.perf_counter()
        outcome = run_evaluation(evaluation, grid, storage=storage,
                                 ctx=EngineContext(storage=storage, device=DEVICE))
        total = time.perf_counter() - t0
        launches = flash_ops.LAUNCHES
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        result = outcome.result
        _log_stages("eval-sess", stages)
        models = [out for name, _, out in stages if name == "train"]
        for j, m in enumerate(models):
            steps = m.train_run.step_seconds
            log(f"[eval-sess] train {j} (point {j // EVAL_K}, fold {j % EVAL_K}): "
                f"vocab={m.cfg.vocab} steps={len(steps)} "
                f"step_ms median={statistics.median(steps) * 1e3:.3f} "
                f"min={min(steps) * 1e3:.3f} max={max(steps) * 1e3:.3f} "
                f"loss_first={m.train_run.losses[0]:.5f} loss_last={m.train_run.losses[-1]:.5f}")
            if m.cfg.vocab != N_ITEMS + 1 or not all(map(math.isfinite, m.train_run.losses)):
                fail(f"eval-sess: fold model {j} has vocab {m.cfg.vocab} or a loss not finite")
        log(f"[eval-sess] run_evaluation {total:.3f}s in all, peak_mem_gb={peak_gb:.3f}, "
            f"scores {[ms.score for _, ms in result.engine_params_scores]}")
        _check_outcome("eval-sess", storage, outcome, evaluation.engine, best_path)

        # the metric, recomputed on the host from the triples Engine.eval returned
        for (ep, folds), (_, ms) in zip(kept, result.engine_params_scores):
            hits = [float(a in [s.item for s in p.item_scores[:EVAL_TOPK]])
                    for _, qpa in folds for _, p, a in qpa]
            if not 0.0 <= ms.score <= 1.0 or ms.score != math.fsum(hits) / len(hits):
                fail(f"eval-sess: HitRate@{EVAL_TOPK} {ms.score} vs the host's "
                     f"{math.fsum(hits) / len(hits)} (lr {ep.algorithm_params_list[0][1].lr})")
        expected = EVAL_POINT["n_layers"] * sum(
            _buckets(len(qpa)) for _, folds in kept for _, qpa in folds)
        log(f"[eval-sess] flash_attention launches in the evaluation: {launches} "
            f"(expected {expected}: {EVAL_POINT['n_layers']} layers x the buckets)")
        if launches == 0 or launches != expected:
            fail(f"eval-sess: {launches} kernel launches, expected {expected}")

        # batch against single (B=1) and against the plain attention, on
        # the first fold's model and held-out queries
        model, algo = models[0], sessionrec.SeqRecAlgorithm()
        queries = [q for q, _, _ in kept[0][1][0][1][:EVAL_SINGLE]]
        batched = dict(algo.batch_predict(model, list(enumerate(queries))))
        worst = ""
        for i, q in enumerate(queries):
            got = batched[i]
            if len(got.item_scores) != q.num or not _same_answer(got, algo.predict(model, q),
                                                                  SCORE_TOL):
                fail(f"eval-sess: batch and single answers differ for {q.user}")
            worst = _check_against_plain(
                model, model.histories[q.user][-model.cfg.max_len:], [],
                [(model.item_index[s.item], s.score) for s in got.item_scores],
                EVAL_TOPK, f"eval-sess {q.user}")
        log(f"[eval-sess] {len(queries)} held-out queries: batch == single (B=1) and the "
            f"plain attention; last: {worst}")
        tops = [MeanTopScore().calculate(folds) for _, folds in kept]
        return launches, (result.best_idx, [ms.score for _, ms in result.engine_params_scores],
                          tops)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _precision_map(folds, k: int) -> tuple[float, float]:
    """Precision@k and MAP@k of (Q, P, A) folds, on the host: users with
    no held-out item left out, hits over min(k, |held-out|)."""
    prec, aps = [], []
    for _, qpa in folds:
        for _, p, a in qpa:
            relevant = set(a)
            if not relevant:
                continue
            top = [s.item for s in p.item_scores[:k]]
            ranks = [r for r, item in enumerate(top, start=1) if item in relevant]
            prec.append(len(ranks) / min(k, len(relevant)) if top else 0.0)
            aps.append(math.fsum((n + 1) / r for n, r in enumerate(ranks))
                       / min(k, len(relevant)))
    return math.fsum(prec) / len(prec), math.fsum(aps) / len(aps)


def phase_eval_recommendation() -> None:
    """Phase 15: run_evaluation of the recommendation template at the
    ML-100k shape with its Engine, then with a FastEvalEngine, then the
    best point again on the CPU."""
    storage, _ = _ml100k_storage()
    grid = rec.DefaultParamsList(app_name="ML100k", eval_k=EVAL_K).engine_params_list + [
        EngineParams.of(data_source=rec.DataSourceParams(app_name="ML100k", eval_k=EVAL_K),
                        algorithms=[("als", rec.ALSAlgorithmParams(
                            rank=ALS_RANK, num_iterations=ALS_ITERS, lambda_=ALS_LAM,
                            seed=3))])]
    out_dir = tempfile.mkdtemp(prefix="eval-rec-")
    runs = {}
    try:
        for engine_cls in (Engine, FastEvalEngine):
            tag = f"eval-rec/{engine_cls.__name__}"
            best_path = os.path.join(out_dir, f"{engine_cls.__name__}.json")
            evaluation = rec.RecommendationEvaluation(k=EVAL_TOPK, output_path=best_path)
            stages: list = []
            kept = _bind_timed(evaluation, stages, engine_cls)
            t0 = time.perf_counter()
            outcome = run_evaluation(evaluation, EngineParamsGenerator(grid), storage=storage,
                                     ctx=EngineContext(storage=storage, device=DEVICE))
            wall = time.perf_counter() - t0
            result = outcome.result
            reads = sum(1 for name, _, _ in stages if name == "read_eval")
            log(f"[{tag}] run_evaluation over {len(grid)} points: {wall:.3f}s, "
                f"read_eval called {reads} times")
            _log_stages(tag, stages)
            _check_outcome(tag, storage, outcome, evaluation.engine, best_path)
            for j, ((_, folds), (_, ms)) in enumerate(zip(kept, result.engine_params_scores)):
                host = _precision_map(folds, EVAL_TOPK)
                p = grid[j].algorithm_params_list[0][1]
                log(f"[{tag}] point {j} (rank {p.rank}, {p.num_iterations} iterations, "
                    f"lambda {p.lambda_}): "
                    f"Precision@{EVAL_TOPK}={ms.score} MAP@{EVAL_TOPK}={ms.other_scores[0]} "
                    f"queries={sum(len(q) for _, q in folds)}")
                if max(abs(host[0] - ms.score), abs(host[1] - ms.other_scores[0])) > 1e-9:
                    fail(f"{tag}: point {j} scores {ms} vs the host's {host}")
            if reads != (1 if engine_cls is FastEvalEngine else len(grid)):
                fail(f"{tag}: read_eval called {reads} times")
            runs[engine_cls] = (result, wall)

        plain, fast = runs[Engine][0], runs[FastEvalEngine][0]
        gap = max(abs(a - b) for (_, x), (_, y) in zip(plain.engine_params_scores,
                                                       fast.engine_params_scores)
                  for a, b in zip([x.score, *x.other_scores], [y.score, *y.other_scores]))
        log(f"[eval-rec] Engine {runs[Engine][1]:.3f}s vs FastEvalEngine "
            f"{runs[FastEvalEngine][1]:.3f}s; largest score gap {gap:.3e} "
            f"(tol {REC_EVAL_RERUN_TOL:g})")
        if gap > REC_EVAL_RERUN_TOL:
            fail("eval-rec: Engine and FastEvalEngine disagree")

        best = plain.best_engine_params
        t0 = time.perf_counter()
        cpu = _precision_map(rec.engine_factory().eval(
            EngineContext(storage=storage, device="cpu"), best), EVAL_TOPK)
        card = (plain.best_score.score, plain.best_score.other_scores[0])
        cpu_gap = max(abs(a - b) for a, b in zip(cpu, card))
        log(f"[eval-rec] best point on the CPU ({time.perf_counter() - t0:.3f}s): "
            f"Precision@{EVAL_TOPK}={cpu[0]} MAP@{EVAL_TOPK}={cpu[1]}; card {card[0]} / "
            f"{card[1]}; gap {cpu_gap:.3e} (tol {REC_EVAL_CPU_TOL:g})")
        if cpu_gap > REC_EVAL_CPU_TOL:
            fail("eval-rec: the card's scores disagree with the CPU's")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


#: phase 16: `pio` as separate processes over a fresh store (the default
#: sqlite + localfs under PIO_FS_BASEDIR). Sessionrec at the serving
#: width: 128 users × 2,049 view events (starts 391 apart, so the
#: template derives vocab 50,000), one epoch at batch 8 (16 Adam steps at
#: S = 2048), 30 queries; the recommendation template at the ML-100k shape
PIO_SESSION = (128, 2049, 391)
PIO_SESSION_TRAIN = dict(d_model=256, n_heads=4, n_layers=4, max_len=2048, batch_size=8,
                         epochs=1, lr=1e-3, seed=SEED)
PIO_QUERIES = 30
PIO_REC_ALGORITHMS = [{"name": "als", "params": {"rank": 10, "numIterations": 10,
                                                 "lambda": 0.01, "seed": 3}}]
#: the algorithms_params text the JAX package's run_train records for
#: PIO_REC_ALGORITHMS (tests/test_torch_train_deploy.py holds it against
#: that package's _algo_params_json)
PIO_REC_ALGORITHMS_JSON = (
    '[{"name": "als", "params": {"rank": 10, "num_iterations": 10, "lambda_": 0.01, '
    '"seed": 3, "implicit_prefs": false, "alpha": 1.0, "use_mesh": true, '
    '"exclude_seen": true, "shard_factors": false}}]')
#: seconds a `pio` process may take (import of 262,272 events, a train)
PIO_STEP_TIMEOUT = 600
#: F1 on the card: item tables whose rows repeat (ML-20M's catalog), the
#: chunked path in tiles of 8,192 (three tiles and an overlap tile)
TIE_ITEMS, TIE_RANK, TIE_DISTINCT, TIE_CHUNK = 26_744, 10, 97, 8_192


class _Pio:
    """`python -m predictionio_tpu_torch.cli.pio` as separate processes
    in one working directory over one PIO_FS_BASEDIR."""

    def __init__(self, base: str):
        self.base = base
        self.env = {k: v for k, v in os.environ.items()
                    if not k.startswith("PIO_STORAGE_") and k != "PIO_MODEL_DIR"}
        self.env["PIO_FS_BASEDIR"] = os.path.join(base, "store")
        repo = os.path.dirname(os.path.abspath(__file__))
        self.env["PYTHONPATH"] = os.pathsep.join(
            [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p])
        self.cmd = [sys.executable, "-m", "predictionio_tpu_torch.cli.pio"]

    def run(self, tag: str, *args: str, expect: int = 0) -> tuple[str, float]:
        """`pio <args>`, which must exit ``expect``: (its output, seconds)."""
        t0 = time.perf_counter()
        p = subprocess.run(self.cmd + list(args), cwd=self.base, env=self.env,
                           capture_output=True, text=True, timeout=PIO_STEP_TIMEOUT)
        seconds = time.perf_counter() - t0
        if p.returncode != expect:
            fail(f"[pio] `pio {' '.join(args)}` exited {p.returncode}:\n"
                 f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        log(f"[{tag}] pio {args[0]}: {seconds:.3f}s")
        return p.stdout, seconds

    def new_app(self, tag: str, name: str) -> int:
        out, _ = self.run(tag, "app", "new", name)
        return int(re.search(r"ID: (\d+)", out).group(1))

    def train(self, tag: str, engine_json: str) -> str:
        out, seconds = self.run(tag, "train", "--engine-json", engine_json, "--device", DEVICE)
        found = re.search(r"Training finished: engine instance (\w+) \((\w+)\)", out)
        if found is None or found.group(2) != "COMPLETED":
            fail(f"[{tag}] pio train did not complete: {out[-2000:]}")
        log(f"[{tag}] {out.strip().splitlines()[-1]}")
        return found.group(1)

    def start_deploy(self, tag: str, engine_json: str, *flags: str, env: dict | None = None):
        """Start `pio deploy` on a free port; (the process, its log path,
        its start time)."""
        out_path = os.path.join(self.base, f"deploy-{tag}.log")
        with open(out_path, "w") as out:
            proc = subprocess.Popen(
                self.cmd + ["deploy", "--engine-json", engine_json, "--ip", "127.0.0.1",
                            "--port", "0", "--device", DEVICE, *flags],
                cwd=self.base, env=env or self.env, stdout=out, stderr=subprocess.STDOUT)
        return proc, out_path, time.perf_counter()

    def wait_listening(self, tag: str, proc, out_path: str, t0: float):
        """(the deploy process, its port, seconds to listening)."""
        deadline = time.monotonic() + PIO_STEP_TIMEOUT
        while True:
            with open(out_path) as f:
                found = re.search(r"listening on 127\.0\.0\.1:(\d+)", f.read())
            if found:
                break
            if proc.poll() is not None or time.monotonic() > deadline:
                proc.kill()
                with open(out_path) as f:
                    fail(f"[{tag}] the server did not come up:\n{f.read()[-3000:]}")
            time.sleep(0.02)
        seconds = time.perf_counter() - t0
        command = os.path.basename(out_path).split("-")[0]
        log(f"[{tag}] pio {command}: listening on :{found.group(1)} after {seconds:.3f}s")
        return proc, int(found.group(1)), seconds

    def eventserver(self, tag: str, *flags: str, env: dict | None = None):
        """`pio eventserver` on a free port: (the process, its port,
        seconds to listening)."""
        return self.server(tag, "eventserver", *flags, env=env)

    def server(self, tag: str, command: str, *flags: str, env: dict | None = None):
        """`pio <command>` (a server: eventserver, adminserver, dashboard)
        on a free port: (the process, its port, seconds to listening)."""
        out_path = os.path.join(self.base, f"{command}-{tag}.log")
        t0 = time.perf_counter()
        with open(out_path, "w") as out:
            proc = subprocess.Popen(
                self.cmd + [command, "--ip", "127.0.0.1", "--port", "0", *flags],
                cwd=self.base, env=env or self.env, stdout=out, stderr=subprocess.STDOUT)
        return self.wait_listening(tag, proc, out_path, t0)

    def deploy(self, tag: str, engine_json: str, *flags: str):
        """(the deploy process, its port, seconds to listening)."""
        return self.wait_listening(tag, *self.start_deploy(tag, engine_json, *flags))


def _status(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=60) as resp:
        return json.loads(resp.read())


def _status_page(tag: str, port: int, instance_id: str) -> None:
    """``GET /`` as a browser asks for it must answer the HTML page."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/",
                                 headers={"Accept": "text/html,application/xhtml+xml"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        ctype, page = resp.headers.get("Content-Type", ""), resp.read().decode()
    if not ctype.startswith("text/html") or f"Engine instance {instance_id}" not in page:
        fail(f"[{tag}] GET / with Accept: text/html answered {ctype!r}: {page[:200]!r}")
    log(f"[{tag}] GET / with Accept: text/html: {ctype}, {len(page)} bytes")


def _write_json_lines(path: str, docs) -> int:
    with open(path, "w") as f:
        n = 0
        for doc in docs:
            f.write(json.dumps(doc) + "\n")
            n += 1
    return n


def _stop(proc) -> None:
    _stop_all([proc])


def _stop_all(procs) -> None:
    """SIGTERM every process at once (once: a second SIGTERM would cut a
    pool's teardown short), then wait for each, SIGKILL after 30 s."""
    live = [proc for proc in procs if proc.poll() is None]
    for proc in live:
        proc.terminate()
    for proc in live:
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def _serve_http(tag: str, port: int, queries: list[dict]) -> tuple[list[dict], list[float]]:
    docs, rtts = [], []
    for body in queries:
        status, doc, ms = _post(port, body)
        if status != 200:
            fail(f"[{tag}] query {body} answered {status}: {doc}")
        docs.append(doc)
        rtts.append(ms)
    return docs, rtts


def _kernel_at_deploy(deployed, body: dict) -> dict:
    """The flash kernel on the q/k/v of the first layer of one served
    query (captured from the in-process deploy of the same instance):
    kernel ms (CUDA events), device ms (torch.profiler), the plain
    version, SDPA with is_causal alone, and the bound."""
    captured = []
    real = seqrec.flash_attention

    def capture(q, k, v, **kw):
        if not captured:
            captured.append((q, k, v, kw.get("kv_mask")))
        return real(q, k, v, **kw)

    seqrec.flash_attention = capture
    try:
        deployed.query(sessionrec.Query(**{"user": body["user"], "num": body["num"]}))
    finally:
        seqrec.flash_attention = real
    q, k, v, kv_mask = captured[0]
    mask = (torch.ones(q.shape[0], q.shape[2], device=DEVICE) if kv_mask is None
            else kv_mask.float().contiguous())
    res = torch.empty_like(q)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kernel_ms = time_ms(lambda: flash_ops._launch(q, k, v, mask, res, True))
    device_ms = profiled_ms(lambda: flash_ops._launch(q, k, v, mask, res, True),
                            "flash_fwd_bf16_wgmma")
    plain_ms = time_ms(lambda: flash_ops.flash_attention_reference(
        q, k, v, causal=True, kv_mask=mask))
    B, H, S, D = q.shape
    bool_mask = (mask[:, None, None, :] > 0) & torch.ones(
        (S, S), dtype=torch.bool, device=DEVICE).tril()
    library_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=bool_mask))
    library_causal_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True))
    bound_ms, bound_by = attention_bound_ms(B, H, S, D, q.dtype, True, mask)
    return dict(shape=(B, H, S, D), dtype=str(q.dtype), real_keys=int(mask.sum()),
                ms=kernel_ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
                library_causal_ms=library_causal_ms, bound_ms=bound_ms, bound_by=bound_by)


def _session_docs(users):
    """Phase 16a's view events of ``users``, as event JSON."""
    _, length, stride = PIO_SESSION
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
    return ({"event": "view", "entityType": "user", "entityId": f"u{u}",
             "targetEntityType": "item", "targetEntityId": f"i{(stride * u + t) % N_ITEMS + 1}",
             "eventTime": (t0 + timedelta(seconds=length * u + t)).strftime(
                 "%Y-%m-%dT%H:%M:%S.000Z")}
            for u in users for t in range(length))


def import_sessions(pio: _Pio, users: int = PIO_SESSION[0]) -> float:
    """Phase 16a's events of the first ``users`` users, as JSON lines,
    into app SessApp through `pio import`; returns the import's seconds."""
    events_path = os.path.join(pio.base, "sessions.jsonl")
    n = _write_json_lines(events_path, _session_docs(range(users)))
    app_id = pio.new_app("pio-sess", "SessApp")
    out, import_s = pio.run("pio-sess", "import", "--appid", str(app_id),
                            "--input", events_path)
    if f"Imported {n} events" not in out:
        fail(f"[pio-sess] import: {out}")
    return import_s


def pio_sessionrec_instance(pio: _Pio) -> tuple[str, str, float]:
    """Phase 16a's stored instance: the events as JSON lines, `pio app
    new`, `pio import`, `pio train`. Returns (instance id, engine.json
    path, import seconds)."""
    import_s = import_sessions(pio)
    engine_json = sessionrec_engine_json(pio)
    return pio.train("pio-sess", engine_json), engine_json, import_s


def sessionrec_engine_json(pio: _Pio) -> str:
    """Phase 16a's engine.json (SessApp, PIO_SESSION_TRAIN); its path."""
    engine_json = os.path.join(pio.base, "sessionrec.json")
    with open(engine_json, "w") as f:
        json.dump({"id": "sessionrec", "engineFactory":
                   "predictionio_tpu_torch.templates.sessionrec.engine_factory",
                   "datasource": {"params": {"app_name": "SessApp"}},
                   "algorithms": [{"name": "seqrec", "params": PIO_SESSION_TRAIN}]}, f)
    return engine_json


def phase_pio_sessionrec(pio: _Pio, instance_id: str, engine_json: str,
                         import_s: float) -> int:
    """Phase 16a; returns the kernel's launches in the deploy process."""
    n_users = PIO_SESSION[0]
    proc, port, deploy_s = pio.deploy("pio-sess", engine_json)
    try:
        rng = np.random.default_rng(SEED + 11)
        users = [int(u) for u in rng.choice(n_users, PIO_QUERIES, replace=False)]
        picks = [f"i{j}" for j in rng.integers(1, N_ITEMS + 1, 200)]
        queries = [{"user": f"u{u}", "num": (10, 20, 5)[j % 3]} for j, u in enumerate(users)]
        for j in range(0, PIO_QUERIES, 5):
            queries[j]["blackList"] = picks[j * 5:j * 5 + 20]
        before = _status(port)
        docs, rtts = _serve_http("pio-sess", port, queries)
        after = _status(port)
        _status_page("pio-sess", port, instance_id)
    finally:
        _stop(proc)
    launches = (after["kernelLaunches"]["flash_attention"]
                - before["kernelLaunches"]["flash_attention"])
    layers = PIO_SESSION_TRAIN["n_layers"]
    log(f"[pio-sess] {PIO_QUERIES} queries over HTTP: http_p50_ms={statistics.median(rtts):.3f} "
        f"http_min_ms={min(rtts):.3f} http_max_ms={max(rtts):.3f}; the deploy process's "
        f"GET /: engineInstanceId={after['engineInstanceId']} "
        f"kernelLaunches.flash_attention={launches} (expected {layers} x {PIO_QUERIES})")
    if launches != layers * PIO_QUERIES or after["engineInstanceId"] != instance_id:
        fail(f"[pio-sess] the deploy process launched the kernel {launches} times, or serves "
             f"instance {after['engineInstanceId']} instead of {instance_id}")

    # the same instance, read back from the same store, deployed in this process
    storage = Storage({"PIO_FS_BASEDIR": pio.env["PIO_FS_BASEDIR"]})
    instance = storage.get_meta_data_engine_instances().get(instance_id)
    t1 = time.perf_counter()
    deployed = load_deployed_engine(storage, ServerConfig(engine_instance_id=instance_id,
                                                          device=DEVICE))
    log(f"[pio-sess] instance {instance_id}: {instance.status}, in-process load "
        f"{time.perf_counter() - t1:.3f}s")
    model = deployed.models[0]
    worst_diff = 0.0
    for body, doc in zip(queries, docs):
        want = deployed.query(sessionrec.Query(user=body["user"], num=body["num"],
                                               black_list=tuple(body.get("blackList", ()))))
        got = doc["itemScores"]
        if [s["item"] for s in got] != [s.item for s in want.item_scores]:
            fail(f"[pio-sess] {body}: HTTP answer differs from the in-process deploy")
        worst_diff = max([worst_diff] + [abs(s["score"] - w.score)
                                         for s, w in zip(got, want.item_scores)])
        agreement = _check_against_plain(
            model, model.histories[body["user"]][-model.cfg.max_len:],
            [model.item_index[i] for i in body.get("blackList", [])],
            [(model.item_index[s["item"]], s["score"]) for s in got],
            min(10, body["num"]), f"pio-sess {body['user']}")
    log(f"[pio-sess] every answer's items equal the in-process deploy's (max score diff "
        f"{worst_diff:.3e}); the last against the plain attention: {agreement}")
    at = _kernel_at_deploy(deployed, queries[0])
    log(f"[pio-sess] flash_attention as launched under pio deploy {at['shape']} {at['dtype']} "
        f"causal, {at['real_keys']} real keys, {LAUNCHES_TIMED} launches: "
        f"kernel_ms={at['ms']:.4f} kernel_device_ms={_fmt(at['device_ms'], 4)} "
        f"plain_ms={at['plain_ms']:.4f} library_ms={at['library_ms']:.4f} "
        f"library_causal_ms={at['library_causal_ms']:.4f} "
        f"bound_ms={at['bound_ms']:.5f} ({at['bound_by']})")
    log(f"[pio-sess] stages: import {import_s:.3f}s, deploy load {deploy_s:.3f}s, "
        f"http_p50_ms={statistics.median(rtts):.3f}")
    del deployed, model
    torch.cuda.empty_cache()
    return launches


def _ml100k_docs():
    """(phase 16b's ML-100k-shape events as event JSON, the generator
    that drew them, for the draws that follow)."""
    n_users, n_items, n_rate, n_buy = ML100K
    rng = np.random.default_rng(SEED + 12)
    users = np.concatenate([np.repeat(np.arange(n_users), 20),
                            (n_users * rng.random(n_rate - 20 * n_users) ** 1.5).astype(int)])
    items = (n_items * rng.random(n_rate + n_buy) ** 1.5).astype(int)
    stars = rng.integers(1, 6, n_rate)
    buyers = rng.integers(0, n_users, n_buy)
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)

    def stamp(n: int) -> str:
        return (t0 + timedelta(seconds=n)).strftime("%Y-%m-%dT%H:%M:%S.000Z")

    docs = [{"event": "rate", "entityType": "user", "entityId": f"u{u}",
             "targetEntityType": "item", "targetEntityId": f"i{i}",
             "properties": {"rating": float(r)}, "eventTime": stamp(j)}
            for j, (u, i, r) in enumerate(zip(users, items, stars))] + [
        {"event": "buy", "entityType": "user", "entityId": f"u{u}",
         "targetEntityType": "item", "targetEntityId": f"i{i}", "eventTime": stamp(n_rate + j)}
        for j, (u, i) in enumerate(zip(buyers, items[n_rate:]))]
    return docs, rng


def pio_recommendation_instance(pio: _Pio):
    """Phase 16b's `pio app new` → `import` → `train` of the ML-100k
    shape: (engine.json path, instance id, the store, the generator of
    the events, for the draws that follow)."""
    docs, rng = _ml100k_docs()
    events_path = os.path.join(pio.base, "ml100k.jsonl")
    n = _write_json_lines(events_path, docs)
    app_id = pio.new_app("pio-rec", "ML100k")
    out, _ = pio.run("pio-rec", "import", "--appid", str(app_id), "--input", events_path)
    if f"Imported {n} events" not in out:
        fail(f"[pio-rec] import: {out}")
    engine_json = os.path.join(pio.base, "recommendation.json")
    with open(engine_json, "w") as f:
        json.dump({"id": "ml100k", "engineFactory": REC_FACTORY,
                   "datasource": {"params": {"appName": "ML100k"}},
                   "algorithms": PIO_REC_ALGORITHMS}, f)
    instance_id = pio.train("pio-rec", engine_json)
    storage = Storage({"PIO_FS_BASEDIR": pio.env["PIO_FS_BASEDIR"]})
    instance = storage.get_meta_data_engine_instances().get(instance_id)
    if instance.status != "COMPLETED" or instance.algorithms_params != PIO_REC_ALGORITHMS_JSON:
        fail(f"[pio-rec] instance {instance_id}: {instance.status}, algorithms_params "
             f"{instance.algorithms_params}")
    log(f"[pio-rec] instance {instance_id}: COMPLETED, algorithms_params equal to the JAX "
        f"package's text")
    return engine_json, instance_id, storage, rng


def phase_pio_recommendation(pio: _Pio) -> tuple[str, str]:
    """Phase 16b: the recommendation template at the ML-100k shape;
    returns (engine.json path, instance id) for phase 23."""
    n_users = ML100K[0]
    engine_json, instance_id, storage, rng = pio_recommendation_instance(pio)
    # the training read alone, in this process, through the columnar scan on sqlite
    ctx = EngineContext(storage=storage, device=DEVICE)
    t1 = time.perf_counter()
    td = rec.RecommendationDataSource(rec.DataSourceParams(app_name="ML100k")).read_training(ctx)
    log(f"[pio-rec] read through EventStore.scan on sqlite: {len(td.users)} ratings in "
        f"{time.perf_counter() - t1:.4f}s")
    queries = _ml100k_queries(rng) + [{"user": f"u{u}", "num": 10}
                                      for u in rng.integers(0, n_users, 14)]
    proc, port, _ = pio.deploy("pio-rec", engine_json)
    try:
        docs, rtts = _serve_http("pio-rec", port, queries)
    finally:
        _stop(proc)
    deployed = load_deployed_engine(storage, ServerConfig(engine_instance_id=instance_id,
                                                          device=DEVICE))
    model, item_f64 = deployed.models[0], deployed.models[0].item_factors.double().cpu().numpy()
    for body, doc in zip(queries, docs):
        served = [(s["item"], s["score"]) for s in doc["itemScores"]]
        want = deployed.query(from_wire(rec.Query, body))
        if served != [(s.item, s.score) for s in want.item_scores]:
            fail(f"[pio-rec] {body}: HTTP answer differs from the in-process deploy")
        _check_answer("pio-rec", body, served, model, item_f64)
    log(f"[pio-rec] {len(queries)} queries over HTTP equal the in-process deploy and the "
        f"float64 reference; http_p50_ms={statistics.median(rtts):.3f}")
    return engine_json, instance_id


def _lexsort_topk(scores: np.ndarray, k: int) -> np.ndarray:
    """Host reference of the tie rule: per row, indices by (value desc,
    index asc), the first k."""
    idx = np.arange(scores.shape[1])
    return np.stack([np.lexsort((idx, -row))[:k] for row in scores])


def phase_tie_order() -> None:
    """Phase 16c: F1 on the card. Integer factors whose rows repeat every
    TIE_DISTINCT items score in exact ties; every top-k path must return
    the host's (value desc, index asc) order. Then the rule's device
    cost beside bare torch.topk."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 13)
    base = torch.randint(-3, 4, (TIE_DISTINCT, TIE_RANK), generator=gen).float()
    item_f = base[torch.arange(TIE_ITEMS) % TIE_DISTINCT].to(DEVICE)
    uv = torch.randint(-3, 4, (4, TIE_RANK), generator=gen).float().to(DEVICE)
    cols = torch.randint(0, TIE_ITEMS, (4, 32), generator=gen).to(DEVICE)
    mask = (torch.rand((4, 32), generator=gen) < 0.5).float().to(DEVICE)
    allow = (torch.rand((TIE_ITEMS,), generator=gen) < 0.9).float().to(DEVICE)
    k = 100
    host = (uv.double() @ item_f.double().T).cpu().numpy()
    host[:, allow.cpu().numpy() == 0] = -np.inf
    for r in range(4):
        host[r, cols[r][mask[r] > 0].cpu().numpy()] = -np.inf
    want = _lexsort_topk(host, k)
    checks = {}
    _, got = topk_ops.recommend_topk(uv, item_f, cols, mask, allow, k)
    checks["recommend_topk"] = np.array_equal(got.cpu().numpy(), want)
    cv, ci = topk_ops.recommend_topk_chunked(uv, item_f, cols, mask, allow, k, chunk=TIE_CHUNK)
    finite = torch.isfinite(cv).cpu().numpy()
    checks["recommend_topk_chunked"] = np.array_equal(ci.cpu().numpy()[finite], want[finite])
    qn = item_f[:3] / item_f[:3].norm(dim=-1, keepdim=True).clamp_min(1e-9)
    itn = item_f / item_f.norm(dim=-1, keepdim=True).clamp_min(1e-9)
    with torch.inference_mode():
        sims = (qn @ itn.T).cpu().numpy().astype(np.float64)
    sims[:, allow.cpu().numpy() == 0] = -np.inf
    for r in range(3):
        sims[r, cols[r][mask[r] > 0].cpu().numpy()] = -np.inf
    _, got = topk_ops.similar_topk(item_f[:3], item_f, cols[:3], mask[:3], allow, k)
    checks["similar_topk"] = np.array_equal(got.cpu().numpy(), _lexsort_topk(sims, k))
    # predict_topk_batch: a seqrec model whose item embeddings repeat
    cfg = seqrec.SeqRecConfig(vocab=2_001, max_len=128, d_model=64, n_heads=2, n_layers=2,
                              dtype=torch.bfloat16)
    params = seqrec.init_params(cfg, torch.Generator().manual_seed(SEED + 14))
    params["item_emb"] = params["item_emb"][1 + torch.arange(cfg.vocab) % TIE_DISTINCT]
    module = seqrec.SeqRec.from_state(cfg, params, torch.device(DEVICE))
    hist = torch.randint(1, cfg.vocab, (4, cfg.max_len), generator=gen).to(DEVICE)
    vmask = torch.zeros((4, cfg.vocab), device=DEVICE)
    vmask[:, 0] = -1e30
    with torch.inference_mode():
        h = module(hist)[:, -1]
        logits = (seqrec.logits_from_hidden(module, h) + vmask).cpu().numpy()
        _, got = seqrec.predict_topk_batch(module, hist, k, vmask)
    checks["predict_topk_batch"] = np.array_equal(got.cpu().numpy(), _lexsort_topk(
        logits.astype(np.float64), k))
    log(f"[ties] {TIE_ITEMS} items of {TIE_DISTINCT} distinct rows, k={k}: item ids and "
        f"order equal to the host's (value desc, index asc): {checks}")
    if not all(checks.values()):
        fail(f"[ties] a top-k path breaks ties otherwise than lax.top_k: {checks}")
    for B, n_items in ((1, TIE_ITEMS), (TOPK_BATCH, TOPK_ITEMS)):
        x = torch.randn((B, n_items), generator=torch.Generator(device=DEVICE).manual_seed(
            SEED + 15), device=DEVICE)
        bare_ms = time_ms(lambda: torch.topk(x, 10), warmup=3, n=20)
        rule_ms = time_ms(lambda: topk_ops.topk_lowest_index(x, 10), warmup=3, n=20)
        bare_dev, _ = _profile(lambda: torch.topk(x, 10))
        rule_dev, launches = _profile(lambda: topk_ops.topk_lowest_index(x, 10),
                                      top=f"ties B={B}")
        log(f"[ties] top-10 of ({B}, {n_items}) f32: torch.topk ms={bare_ms:.4f} "
            f"device_ms={_fmt(bare_dev, 4)}; topk_lowest_index ms={rule_ms:.4f} "
            f"device_ms={_fmt(rule_dev, 4)} launches={launches}")
        # where the rule's time goes: its three passes over the row
        bits = x.view(torch.int32)
        keys = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
        t = torch.topk(keys, 10).values[:, -1:]
        stages = {"keys": lambda: torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits),
                  "int32_topk": lambda: torch.topk(keys, 10),
                  "tie_count": lambda: torch.cumsum(keys == t, -1, dtype=torch.int32)}
        log(f"[ties] ({B}, {n_items}) stages, CUDA events: " + " ".join(
            f"{name}_ms={time_ms(fn, warmup=3, n=20):.4f}" for name, fn in stages.items()))
        del x, bits, keys
        torch.cuda.empty_cache()


def phase_pio(pio: _Pio) -> tuple[int, tuple[str, str, float], tuple[str, str]]:
    """Phase 16; returns the flash kernel's launches in the sessionrec
    deploy process, the sessionrec instance (phase 17 serves it) and the
    ML-100k recommendation instance (phase 23 serves it)."""
    t0 = time.perf_counter()
    instance = pio_sessionrec_instance(pio)
    launches = phase_pio_sessionrec(pio, *instance)
    rec_instance = phase_pio_recommendation(pio)
    log(f"[pio] phase 16 took {time.perf_counter() - t0:.1f}s")
    return launches, instance, rec_instance


#: phase 17: closed-loop clients in flight, and the queries each level sends
LOAD_CLIENTS = {1: 32, 8: 128, 64: 256}
LOAD_BATCH_MAX = 64
SERVER_KEY = "chip-smoke-key"
#: batched against unbatched sessionrec answers: the same model, the
#: same kernel (each row of a bucket is computed as at B=1); only the
#: GEMMs see B·S rows instead of S, which may round a bf16 hidden value
#: one step otherwise. Served against the plain attention the scores
#: differ by 0.003-0.03 (phase 4); a fifth of SCORE_TOL bounds a
#: rounding step while catching a row mixed up with another
BATCH_SCORE_TOL = SCORE_TOL / 5
#: the cache's repeated-query mix: distinct queries, each sent this often
CACHE_DISTINCT, CACHE_REPEATS = 16, 4
#: phase 17d: queries sent at C=64 at each budget: 1 ms, which most
#: queries spend before they reach the batcher's queue, and 20 ms, which
#: lets them queue behind a batch in flight (a batch of ~50 takes
#: 80-110 ms), so that the dispatcher expires them at dequeue
DEADLINE_QUERIES = 128
DEADLINE_BUDGETS_MS = (1, 20)
#: phase 17a's warm-up queries (stored user, num), kept out of the levels
WARM_COMBOS = ((0, 5), (1, 10))


def _get(port: int, path: str) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _closed_loop(port: int, bodies: list[dict], clients: int,
                 headers: dict | None = None) -> tuple[list[tuple], float]:
    """``clients`` threads, each on its own keep-alive connection, send
    the next unsent body as soon as their last answer is in. Returns
    ((status, doc, ms, Retry-After, X-PIO-Trace-Id) per body, wall
    seconds)."""
    import http.client
    import itertools
    import threading

    results: list = [None] * len(bodies)
    order = itertools.count()

    def client() -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            while (i := next(order)) < len(bodies):
                t0 = time.perf_counter()
                try:
                    conn.request("POST", "/queries.json", json.dumps(bodies[i]).encode(),
                                 {"Content-Type": "application/json", **(headers or {})})
                    resp = conn.getresponse()
                    doc = json.loads(resp.read() or b"{}")
                    results[i] = (resp.status, doc, (time.perf_counter() - t0) * 1e3,
                                  resp.getheader("Retry-After"),
                                  resp.getheader("X-PIO-Trace-Id"))
                except (OSError, http.client.HTTPException) as e:
                    results[i] = (0, {"message": repr(e)}, (time.perf_counter() - t0) * 1e3,
                                  None, None)
                    conn.close()
                    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        finally:
            conn.close()

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, time.perf_counter() - t0


def _quantile(values: list[float], q: float) -> float:
    return float(np.quantile(np.asarray(values), q))


def _hist(stats: dict) -> dict[int, int]:
    return {int(n): c for n, c in stats["serving"]["batchSizeHistogram"].items()}


def _hist_delta(after: dict, before: dict) -> dict[int, int]:
    a, b = _hist(after), _hist(before)
    return {n: a[n] - b.get(n, 0) for n in sorted(a) if a[n] != b.get(n, 0)}


def _sum_ms(stats: dict, name: str) -> tuple[int, float]:
    """(count, total ms) of a /stats.json latency summary."""
    h = stats["serving"][name]
    return h["count"], h["count"] * (h["meanMs"] or 0.0)


def _launches_for(hist: dict[int, int], layers: int) -> int:
    """Flash launches of sessionrec batches: n_layers per power-of-two
    bucket, popcount(n) buckets for a batch of n."""
    return layers * sum(c * bin(n).count("1") for n, c in hist.items())


def _retries(stats: dict) -> int:
    return stats.get("resilience", {}).get("serving/query-batcher", {}).get("fallbacks", 0)


def _as_result(doc: dict):
    return rec.PredictedResult(tuple(rec.ItemScore(s["item"], s["score"])
                                     for s in doc.get("itemScores", [])))


def _drive_level(tag: str, port: int, bodies: list[dict], clients: int,
                 batched: bool) -> dict:
    """One closed-loop level of distinct queries; returns its numbers
    (and the answers). A server with a result cache must hit nothing:
    a hit would answer without the predict path being compared."""
    before = _get(port, "/stats.json")[1]
    results, wall = _closed_loop(port, bodies, clients)
    after = _get(port, "/stats.json")[1]
    bad = [(b, r[:2]) for b, r in zip(bodies, results) if r[0] != 200]
    if bad:
        fail(f"[{tag}] C={clients}: {len(bad)} queries failed, first {bad[0]}")
    hits = after["serving"]["cacheHits"] - before["serving"]["cacheHits"]
    if hits:
        fail(f"[{tag}] C={clients}: {hits} of the level's distinct queries hit the cache")
    ms = [r[2] for r in results]
    row = dict(clients=clients, batching=batched, n=len(bodies),
               p50_ms=_quantile(ms, 0.5), p99_ms=_quantile(ms, 0.99),
               qps=len(bodies) / wall, answers=[r[1] for r in results])
    if batched:
        (n0, d0), (n1, d1) = _sum_ms(before, "deviceDispatch"), _sum_ms(after, "deviceDispatch")
        (q0, w0), (q1, w1) = _sum_ms(before, "queueWait"), _sum_ms(after, "queueWait")
        row.update(hist=_hist_delta(after, before),
                   dispatch_ms_per_batch=(d1 - d0) / max(1, n1 - n0),
                   queue_wait_share=(w1 - w0) / sum(ms))
    log(f"[{tag}] C={clients} batching={'on' if batched else 'off'}: n={len(bodies)} "
        f"p50_ms={row['p50_ms']:.3f} p99_ms={row['p99_ms']:.3f} qps={row['qps']:.2f}"
        + (f" batch_hist={row['hist']} dispatch_ms_per_batch="
           f"{row['dispatch_ms_per_batch']:.3f} queue_wait_share={row['queue_wait_share']:.4f}"
           if batched else ""))
    return row


def _sess_mix(rng, n: int, combos: list, n_items: int = N_ITEMS) -> list[dict]:
    """n distinct sessionrec queries: stored users and `items` sessions
    in turn, sessions of 1-2,048 real items (log-uniform) of the first
    ``n_items``, every fifth query with a black list."""
    out = []
    for j in range(n):
        if j % 2 == 0:
            u, num = combos.pop()
            body = {"user": f"u{u}", "num": num}
        else:
            length = int(np.clip(round(math.exp(rng.uniform(0, math.log(2048)))), 1, 2048))
            body = {"items": [f"i{i}" for i in rng.integers(1, n_items + 1, length)],
                    "num": (5, 10, 20)[j % 3]}
        if j % 5 == 0:
            body["blackList"] = [f"i{i}" for i in rng.integers(1, n_items + 1, 20)]
        out.append(body)
    return out


def _sess_tail(model, body: dict) -> list[int]:
    if "items" in body:
        return [model.item_index[i] for i in body["items"]][-model.cfg.max_len:]
    return model.histories[body["user"]][-model.cfg.max_len:]


def _load_table(tag: str, rows: list[dict]) -> None:
    """The levels' numbers as one JSON line, for PERF.md."""
    log(f"[{tag}] table " + json.dumps([{k: v for k, v in r.items() if k != "answers"}
                                        for r in rows]))


def _deadline_level(port: int, bodies: list[dict], budget_ms: int, fresh: dict) -> int:
    """Phase 17d at one budget: the bodies at C=64 under
    X-PIO-Deadline-Ms; 503s with Retry-After and no other error. Returns
    the queries the dispatcher expired at dequeue: the `expired` count
    beyond the 503s whose query was refused before the queue (their
    message names a budget of 0.000 s), read after ``fresh``, a query
    the cache does not hold, has queued behind any batch in flight."""
    expired0 = _get(port, "/stats.json")[1]["serving"]["expired"]
    results, _ = _closed_loop(port, bodies, 64, {"X-PIO-Deadline-Ms": str(budget_ms)})
    _closed_loop(port, [fresh], 1)
    expired = _get(port, "/stats.json")[1]["serving"]["expired"] - expired0
    codes = sorted({r[0] for r in results})
    shed = sum(1 for r in results if r[0] == 503 and r[3] is not None)
    at_submit = sum(1 for r in results if r[0] == 503
                    and "(0.000s budget)" in r[1].get("message", ""))
    log(f"[serve-deadline] {len(bodies)} queries at C=64 with X-PIO-Deadline-Ms {budget_ms}: "
        f"{shed} x 503 with Retry-After, {sum(r[0] == 200 for r in results)} x 200; "
        f"statuses {codes}; expired {expired}: {at_submit} before the queue, "
        f"{expired - at_submit} at dequeue")
    if shed == 0 or set(codes) - {200, 503}:
        fail(f"[serve-deadline] expected 503s with Retry-After and no other error: {codes}")
    return expired - at_submit


#: phase 17a's rows of this run (phase 27 logs its pools beside them)
PHASE17_ROWS: list[dict] = []


def phase_serve_sessionrec(pio: _Pio, instance: tuple[str, str, float]) -> int:
    """Phase 17a, c, d, e: phase 16a's instance behind two `pio deploy`
    processes, batched and unbatched, each with the result cache and the
    server key. Returns the kernel's launches in both."""
    instance_id, engine_json, _ = instance
    layers = PIO_SESSION_TRAIN["n_layers"]
    procs = {}
    try:
        # both processes start together, then report their ports
        for mode, flags in (("batched", ("--batching", "--batch-max", str(LOAD_BATCH_MAX))),
                            ("unbatched", ("--no-batching",))):
            procs[mode] = pio.start_deploy(f"serve-{mode}", engine_json, "--cache",
                                           "--server-key", SERVER_KEY, *flags)
        ports = {mode: pio.wait_listening(f"serve-{mode}", *started)[1]
                 for mode, started in procs.items()}
        bport, uport = ports["batched"], ports["unbatched"]

        storage = Storage({"PIO_FS_BASEDIR": pio.env["PIO_FS_BASEDIR"]})
        deployed = load_deployed_engine(storage, ServerConfig(engine_instance_id=instance_id,
                                                              device=DEVICE))
        model = deployed.models[0]
        rng = np.random.default_rng(SEED + 17)
        combos = [(u, num) for u in range(PIO_SESSION[0]) for num in (5, 10, 20)
                  if (u, num) not in WARM_COMBOS]
        rng.shuffle(combos)
        for port in (bport, uport):                       # warm-up, outside the levels
            _closed_loop(port, _sess_mix(np.random.default_rng(SEED + 18), 4,
                                         list(WARM_COMBOS)), 1)

        # 17a: each level's distinct queries to both servers
        rows, worst, sizes = [], 0.0, {}
        for clients, n in LOAD_CLIENTS.items():
            bodies = _sess_mix(rng, n, combos)
            off = _drive_level("serve-sess", uport, bodies, clients, False)
            on = _drive_level("serve-sess", bport, bodies, clients, True)
            rows += [off, on]
            if clients >= 8 and max(on["hist"], default=1) <= 1:
                fail(f"[serve-sess] C={clients}: no batch above 1 was dispatched: {on['hist']}")
            for body, a, b in zip(bodies, on["answers"], off["answers"]):
                if len(a["itemScores"]) != body["num"] or not _same_answer(
                        _as_result(a), _as_result(b), BATCH_SCORE_TOL):
                    fail(f"[serve-sess] batched and unbatched answers differ: "
                         f"{json.dumps(body)[:200]}")
                worst = max([worst] + [abs(x["score"] - y["score"]) for x, y in
                                       zip(a["itemScores"], b["itemScores"])
                                       if x["item"] == y["item"]])
            for size in on["hist"]:
                sizes.setdefault(size, bodies[:size])
        _load_table("serve-sess", rows)
        PHASE17_ROWS[:] = [{k: v for k, v in r.items() if k != "answers"} for r in rows]
        log(f"[serve-sess] every batched answer agrees with the unbatched one "
            f"(max score diff {worst:.3e}, tol {BATCH_SCORE_TOL:g})")
        # the last answer of a batch of each dispatched size, in this
        # process, against the plain attention
        agreement = ""
        for size, bodies in sorted(sizes.items()):
            queries = [from_wire(sessionrec.Query, b) for b in bodies]
            last = deployed.query_batch(queries)[-1]
            body = bodies[-1]
            agreement = _check_against_plain(
                model, _sess_tail(model, body),
                [model.item_index[i] for i in body.get("blackList", [])],
                [(model.item_index[x.item], x.score) for x in last.item_scores],
                min(10, body["num"]), f"serve-sess batch of {size}")
        log(f"[serve-sess] the last answer of a batch of each dispatched size "
            f"{sorted(sizes)} holds against the plain attention; the last: {agreement}")

        # 17c: the cache, then /reload
        base = _sess_mix(rng, CACHE_DISTINCT, combos)
        mix = [base[j % CACHE_DISTINCT] for j in range(CACHE_DISTINCT * CACHE_REPEATS)]
        rng.shuffle(mix)
        s0, l0 = _get(bport, "/stats.json")[1], _status(bport)["kernelLaunches"]["flash_attention"]
        results, _ = _closed_loop(bport, mix, 8)
        s1, l1 = _get(bport, "/stats.json")[1], _status(bport)["kernelLaunches"]["flash_attention"]
        hits = s1["serving"]["cacheHits"] - s0["serving"]["cacheHits"]
        misses = s1["serving"]["cacheMisses"] - s0["serving"]["cacheMisses"]
        hist = _hist_delta(s1, s0)
        log(f"[serve-cache] {len(mix)} queries ({CACHE_DISTINCT} distinct) at C=8: hits={hits} "
            f"misses={misses} hit_ratio={hits / len(mix):.4f} batch_hist={hist} "
            f"launches={l1 - l0} (expected {_launches_for(hist, layers)})")
        if any(r[0] != 200 for r in results) or hits == 0 \
                or l1 - l0 != _launches_for(hist, layers):
            fail("[serve-cache] the repeated mix failed, hit nothing, or a hit launched")
        repeat = base[0]
        before = _status(bport)["kernelLaunches"]["flash_attention"]
        _closed_loop(bport, [repeat], 1)
        if _status(bport)["kernelLaunches"]["flash_attention"] != before:
            fail("[serve-cache] a cache hit launched the kernel")
        if _get(bport, "/reload")[0] != 401:
            fail("[serve-cache] /reload without the key was not refused")
        gen0 = _get(bport, "/stats.json")[1]["cache"]["generation"]
        status, doc = _get(bport, f"/reload?accessKey={SERVER_KEY}")
        ready = _get(bport, "/readyz")
        s2 = _get(bport, "/stats.json")[1]
        results, _ = _closed_loop(bport, [repeat], 1)
        s3 = _get(bport, "/stats.json")[1]
        missed = s3["serving"]["cacheMisses"] - s2["serving"]["cacheMisses"]
        log(f"[serve-cache] /reload: {status} {doc}; cache generation {gen0} -> "
            f"{s2['cache']['generation']}; /readyz {ready[0]} {ready[1]}; the next repeat: "
            f"{'miss' if missed == 1 else 'hit'}")
        if status != 200 or s2["cache"]["generation"] != gen0 + 1 or ready[0] != 200 \
                or missed != 1 or results[0][0] != 200:
            fail("[serve-cache] /reload did not swap, invalidate and come back ready")

        # 17d: tight budgets at C=64; the longer one must reach the queue
        # and be expired there
        at_dequeue = [_deadline_level(bport, _sess_mix(rng, DEADLINE_QUERIES, combos), ms,
                                      _sess_mix(rng, 1, combos)[0])
                      for ms in DEADLINE_BUDGETS_MS]
        if not at_dequeue[-1]:
            fail(f"[serve-deadline] no query expired at dequeue at "
                 f"{DEADLINE_BUDGETS_MS[-1]} ms")

        # the launch identity and the retries, then 17e: pio undeploy
        launches = {}
        for mode, port in (("batched", bport), ("unbatched", uport)):
            stats, status_doc = _get(port, "/stats.json")[1], _status(port)
            launches[mode] = status_doc["kernelLaunches"]["flash_attention"]
            # unbatched, each answered query that missed the cache ran alone
            expected = (_launches_for(_hist(stats), layers) if mode == "batched"
                        else layers * (status_doc["requestCount"]
                                       - stats["serving"]["cacheHits"]))
            log(f"[serve-sess] {mode}: kernelLaunches.flash_attention={launches[mode]} "
                f"(expected {expected}); batch retries {_retries(stats)}; "
                f"batch_hist={_hist(stats)}; requestCount={status_doc['requestCount']}")
            if launches[mode] != expected or _retries(stats):
                fail(f"[serve-sess] {mode}: launches {launches[mode]} != {expected}, "
                     f"or a failed batch was retried ({_retries(stats)})")
        for mode, port in (("batched", bport), ("unbatched", uport)):
            pio.run("serve-undeploy", "undeploy", "--ip", "127.0.0.1", "--port", str(port),
                    "--server-key", SERVER_KEY)
            code = procs[mode][0].wait(timeout=60)
            log(f"[serve-undeploy] pio undeploy stopped the {mode} deploy process: "
                f"exit code {code}")
            if code != 0:
                fail(f"[serve-undeploy] the {mode} deploy process exited {code}")
        del deployed, model
        torch.cuda.empty_cache()
        return launches["batched"] + launches["unbatched"]
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                _stop(proc)


def random_als_model(n_queries: int = 512) -> ALSModel:
    """An ALS model at the ML-20M shape from seeded random factors, with
    seen lists of 10-600 items for the users phase 17b asks about (the
    model of phase 11 when phases 9-13 did not run)."""
    n_users, n_items, _ = ML20M
    gen = torch.Generator(device="cpu").manual_seed(SEED + 19)
    rng = np.random.default_rng(SEED + 19)
    seen = {int(u): np.unique(rng.integers(0, n_items, int(rng.integers(10, 600)))).astype(
        np.int32) for u in rng.choice(n_users, n_queries, replace=False)}
    return ALSModel(rank=ALS_RANK,
                    user_factors=(torch.randn((n_users, ALS_RANK), generator=gen)
                                  / ALS_RANK ** 0.5).to(DEVICE),
                    item_factors=(torch.randn((n_items, ALS_RANK), generator=gen)
                                  / ALS_RANK ** 0.5).to(DEVICE),
                    user_ids=EntityIdIxMap(BiMap({f"u{i}": i for i in range(n_users)})),
                    item_ids=EntityIdIxMap(BiMap({f"i{i}": i for i in range(n_items)})),
                    seen_by_user=seen)


def _store_als_instance(storage, model: ALSModel, location: str) -> str:
    """``model`` as a COMPLETED recommendation engine instance in
    ``storage``: the model saved at ``location``, a manifest of it as the
    instance's model blob. Returns the instance id."""
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
    instance_id = storage.get_meta_data_engine_instances().insert(EngineInstance(
        id="", status="COMPLETED", start_time=t0, completion_time=t0, engine_id="ml20m",
        engine_version="1", engine_variant="ml20m", engine_factory=REC_FACTORY,
        algorithms_params=json.dumps([{"name": "als", "params": {"rank": ALS_RANK}}])))
    model.save(location)
    save_models(storage, instance_id, [PersistentModelManifest(
        "predictionio_tpu_torch.templates.recommendation.ALSAlgorithm", location)])
    return instance_id


def phase_serve_als(model: ALSModel) -> None:
    """Phase 17b: the ML-20M-shape model, stored as an engine instance,
    behind the in-process server, batching on and off, at the same
    client counts (server and clients share this process)."""
    from predictionio_tpu_torch.utils.resilience import registry_snapshot

    n_items = model.item_factors.shape[0]
    users = sorted(model.seen_by_user)
    rng = np.random.default_rng(SEED + 20)
    model_dir = tempfile.mkdtemp(prefix="als-serve-")
    servers = []
    try:
        storage = memory_storage()
        instance_id = _store_als_instance(storage, model, model_dir)
        for batching in (True, False):
            servers.append(create_engine_server(storage, _local(
                engine_instance_id=instance_id, batching=batching,
                batch_max=LOAD_BATCH_MAX)).start())
        on, off = (s.port for s in servers)
        for port in (on, off):
            _closed_loop(port, [{"user": f"u{users[0]}", "num": 10}], 1)
        rows = []
        for clients, n in LOAD_CLIENTS.items():
            bodies = []
            for j in range(n):
                body = {"user": f"u{rng.choice(users)}", "num": (10, 20, 100)[j % 3]}
                if j % 5 == 0:
                    body["blackList"] = [f"i{i}" for i in rng.integers(0, n_items, 20)]
                bodies.append(body)
            a = _drive_level("serve-als", off, bodies, clients, False)
            b = _drive_level("serve-als", on, bodies, clients, True)
            rows += [a, b]
            differ = [body for body, x, y in zip(bodies, b["answers"], a["answers"])
                      if not _same_answer(_as_result(x), _as_result(y))]
            if differ:
                fail(f"[serve-als] batched and unbatched answers differ for {differ[:3]}")
        _load_table("serve-als", rows)
        retries = registry_snapshot().get("serving/query-batcher", {}).get("fallbacks", 0)
        log(f"[serve-als] every batched answer equals the unbatched one (tol "
            f"{ALS_SCORE_TOL:g}); batch retries {retries}")
        if retries:
            fail(f"[serve-als] {retries} failed batches were retried query by query")
    finally:
        for server in servers:
            server.stop()
        shutil.rmtree(model_dir, ignore_errors=True)


def phase_serve(pio: _Pio, instance: tuple[str, str, float], als_model: ALSModel) -> int:
    """Phase 17; returns the flash kernel's launches in its deploy processes."""
    t0 = time.perf_counter()
    launches = phase_serve_sessionrec(pio, instance)
    phase_serve_als(als_model)
    log(f"[serve] phase 17 took {time.perf_counter() - t0:.1f}s")
    return launches


#: phase 18: the event server. 18b sends the view events of 32 of phase
#: 16a's 128 users (2,049 each, 65,568 events) over REST, 50 a request from
#: 8 keep-alive clients: every 4th user, whose walks still cover every
#: item, so the model trained from them keeps vocab 50,000 (the user count
#: is the depth cut; the widths stay). 32 users at batch 8 are 4 Adam steps
#: at S = 2048. 18e sends the first 5,000 of phase 16b's ML-100k events
INGEST_USERS = tuple(range(0, PIO_SESSION[0], 4))
INGEST_BATCH, INGEST_CLIENTS, INGEST_SINGLES = 50, 8, 200
INGEST_QUERIES = 30
#: 18e's first burst (cut from 20,000 to 10,000 for phase 28 and to 5,000
#: for phase 29)
INGEST_WAL_EVENTS = 5_000
#: seconds within which the deploy's feedback events must be readable
FEEDBACK_WAIT_S = 10.0
#: events acknowledged in 18e's second burst before the server is killed
KILL_AFTER_ACKS = 2_000


def _http(port: int, method: str, path: str, body=None,
          content_type: str = "application/json") -> tuple[int, object, float]:
    """One request on a fresh connection: (status, JSON body, ms)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    data = None
    if body is not None:
        data = body.encode() if isinstance(body, str) else json.dumps(body).encode()
    t0 = time.perf_counter()
    try:
        conn.request(method, path, data, {"Content-Type": content_type} if data else {})
        resp = conn.getresponse()
        doc = json.loads(resp.read() or b"null")
        return resp.status, doc, (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()


def _send_batches(port: int, key: str, docs: list[dict], clients: int,
                  acked: list | None = None) -> tuple[list, float]:
    """``docs`` over POST /batch/events.json, INGEST_BATCH a request, from
    ``clients`` keep-alive connections, each taking the next unsent
    batch. Returns (the per-event status entries in the order of
    ``docs``, None where no answer came; wall seconds). With ``acked``,
    each answered batch appends its size there, and a failed connection
    ends its client quietly (the server is being killed) rather than the
    run."""
    import http.client
    import itertools
    import threading

    batches = [docs[i:i + INGEST_BATCH] for i in range(0, len(docs), INGEST_BATCH)]
    results: list = [None] * len(docs)
    order = itertools.count()
    errors: list[str] = []
    path = f"/batch/events.json?accessKey={key}"

    def client() -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            while (b := next(order)) < len(batches):
                try:
                    conn.request("POST", path, json.dumps(batches[b]).encode(),
                                 {"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    doc = json.loads(resp.read())
                except (OSError, http.client.HTTPException, ValueError) as e:
                    if acked is None:
                        errors.append(f"batch {b}: {e!r}")
                    return
                if resp.status != 200 or len(doc) != len(batches[b]):
                    errors.append(f"batch {b}: {resp.status} {str(doc)[:300]}")
                    return
                results[b * INGEST_BATCH:b * INGEST_BATCH + len(doc)] = doc
                if acked is not None:
                    acked.append(len(doc))
        finally:
            conn.close()

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail("[ingest] " + "; ".join(errors[:5]))
    return results, time.perf_counter() - t0


def _event_fields(e) -> tuple:
    """An event's fields as the client sent them (ids and creation
    times are the server's)."""
    return (e.event, e.entity_type, e.entity_id, e.target_entity_type, e.target_entity_id,
            dict(e.properties.fields), e.event_time, tuple(e.tags), e.pr_id)


def _doc_fields(doc: dict) -> tuple:
    return _event_fields(Event(
        event=doc["event"], entity_type=doc["entityType"], entity_id=doc["entityId"],
        target_entity_type=doc.get("targetEntityType"),
        target_entity_id=doc.get("targetEntityId"),
        properties=DataMap(doc.get("properties", {})),
        event_time=datetime.strptime(doc["eventTime"], "%Y-%m-%dT%H:%M:%S.000Z").replace(
            tzinfo=timezone.utc)))


def _app_events(storage, app_id: int, channel_id=None) -> list:
    """The app's events through the columnar scan of the training read."""
    return [e for batch in storage.get_events().find_columnar(app_id, channel_id)
            for e in batch.to_events()]


def _binevents_env(pio: _Pio) -> dict:
    """The `pio` environment with event data on a binevents source;
    metadata stays in the same sqlite, models in the same localfs."""
    store = pio.env["PIO_FS_BASEDIR"]
    return {**pio.env,
            "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_DB_PATH": os.path.join(store, "pio.sqlite"),
            "PIO_STORAGE_SOURCES_BIN_TYPE": "binevents",
            "PIO_STORAGE_SOURCES_BIN_PATH": os.path.join(pio.base, "binevents"),
            "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
            "PIO_STORAGE_SOURCES_FS_PATH": os.path.join(store, "models"),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "BIN",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS"}


def ingest_setup(pio: _Pio) -> tuple[int, str, str]:
    """18a: app `ingest`, a full key and a key whitelisted to `view`, the
    channel `side`. Returns (app id, full key, whitelisted key)."""
    out, _ = pio.run("ingest", "app", "new", "ingest")
    app_id = int(re.search(r"ID: (\d+)", out).group(1))
    key = re.search(r"Access Key: (\S+)", out).group(1)
    out, _ = pio.run("ingest", "accesskey", "new", "ingest", "--event", "view")
    view_key = re.search(r"Created new access key: (\S+)", out).group(1)
    pio.run("ingest", "app", "channel-new", "ingest", "side")
    return app_id, key, view_key


def phase_ingest_rest(pio: _Pio, port: int, app_id: int, key: str) -> None:
    """18b: 65,568 events over POST /batch/events.json, every status 201,
    the ingest counters, the app's read against 16a's import; then 200
    single POSTs (to the channel `side`, so the training read stays
    16a's)."""
    docs = list(_session_docs(INGEST_USERS))
    results, seconds = _send_batches(port, key, docs, INGEST_CLIENTS)
    bad = [r for r in results if r is None or r["status"] != 201]
    if bad:
        fail(f"[ingest-rest] {len(bad)} events without a 201, first {bad[:3]}")
    log(f"[ingest-rest] {len(docs)} events over POST /batch/events.json, {INGEST_BATCH} a "
        f"request, {INGEST_CLIENTS} keep-alive clients: {seconds:.3f}s, "
        f"events_per_s={len(docs) / seconds:.1f}, every status 201")
    status, stats, _ = _http(port, "GET", f"/stats.json?accessKey={key}")
    ingest = stats["ingest"]
    if status != 200 or ingest["events"] != len(docs) or ingest["batchSizeHistogram"] != {
            str(INGEST_BATCH): len(docs) // INGEST_BATCH, str(len(docs) % INGEST_BATCH): 1}:
        fail(f"[ingest-rest] /stats.json ingest counters {ingest} for {len(docs)} events")
    log(f"[ingest-rest] /stats.json ingest: events={ingest['events']} "
        f"batches={ingest['batches']} insertLatency={ingest['insertLatency']} "
        f"statusCode={stats['currentHour']['statusCode']}")
    storage = Storage({"PIO_FS_BASEDIR": pio.env["PIO_FS_BASEDIR"]})
    t0 = time.perf_counter()
    got = sorted(_event_fields(e) for e in _app_events(storage, app_id))
    read_s = time.perf_counter() - t0
    sess_app = storage.get_meta_data_apps().get_by_name("SessApp").id
    users = {f"u{u}" for u in INGEST_USERS}
    want = sorted(_event_fields(e) for e in _app_events(storage, sess_app)
                  if e.entity_id in users)
    if got != want or len(got) != len(docs):
        fail(f"[ingest-rest] the app's read ({len(got)} events) differs from 16a's import "
             f"of the same users ({len(want)})")
    log(f"[ingest-rest] the app's columnar read ({read_s:.3f}s) equals 16a's imported events "
        f"of those {len(users)} users, field for field (ids and creation times aside)")
    storage.close()
    rtts = []
    for n in range(INGEST_SINGLES):
        status, doc, ms = _http(port, "POST", f"/events.json?accessKey={key}&channel=side",
                                {"event": "view", "entityType": "user", "entityId": f"s{n}",
                                 "targetEntityType": "item", "targetEntityId": f"i{n + 1}"})
        if status != 201:
            fail(f"[ingest-rest] single POST answered {status}: {doc}")
        rtts.append(ms)
    log(f"[ingest-rest] {INGEST_SINGLES} single POST /events.json: "
        f"p50_ms={statistics.median(rtts):.3f} p99_ms={_quantile(rtts, 0.99):.3f} "
        f"min_ms={min(rtts):.3f}")


def phase_ingest_refusals(port: int, key: str, view_key: str) -> None:
    """18c: the refusals and the other routes, each with the reference's
    status; everything written goes to the channel `side`."""
    ev = {"event": "view", "entityType": "user", "entityId": "c1",
          "targetEntityType": "item", "targetEntityId": "i7"}
    side = f"accessKey={key}&channel=side"
    checks = [
        ("no key", 401, "POST", "/events.json", ev),
        ("bad key", 401, "POST", "/events.json?accessKey=nope", ev),
        ("whitelisted key, other event", 403, "POST",
         f"/events.json?accessKey={view_key}&channel=side", {**ev, "event": "buy"}),
        ("whitelisted key, its event", 201, "POST",
         f"/events.json?accessKey={view_key}&channel=side", ev),
        ("malformed", 400, "POST", f"/events.json?{side}", {"event": "view"}),
        ("batch over the cap", 400, "POST", f"/batch/events.json?{side}", [ev] * 51),
        ("unknown channel", 401, "POST", f"/events.json?accessKey={key}&channel=nope", ev),
    ]
    for name, want, method, path, body in checks:
        status, doc, _ = _http(port, method, path, body)
        if status != want:
            fail(f"[ingest-api] {name}: {status} {doc}, expected {want}")
    status, doc, _ = _http(port, "POST", f"/events.json?{side}", {**ev, "entityId": "only-side"})
    eid = doc["eventId"]
    in_side = _http(port, "GET", f"/events.json?{side}&entityType=user&entityId=only-side")
    in_default = _http(port, "GET", f"/events.json?accessKey={key}&entityType=user"
                                    f"&entityId=only-side")
    if status != 201 or in_side[0] != 200 or len(in_side[1]) != 1 or in_default[0] != 404:
        fail(f"[ingest-api] channel POST read back: {in_side[:2]}, default {in_default[:2]}")
    steps = [_http(port, "GET", f"/events/{eid}.json?{side}")[0],
             _http(port, "DELETE", f"/events/{eid}.json?{side}")[0],
             _http(port, "GET", f"/events/{eid}.json?{side}")[0]]
    if steps != [200, 200, 404]:
        fail(f"[ingest-api] GET/DELETE/GET /events/{{id}}.json: {steps}")
    user = f"u{INGEST_USERS[1]}"
    status, found, _ = _http(port, "GET", f"/events.json?accessKey={key}&event=view"
                                          f"&entityType=user&entityId={user}&limit=5&reversed=true")
    want = sorted(_session_docs([INGEST_USERS[1]]), key=lambda d: d["eventTime"])[-5:][::-1]
    if status != 200 or [(d["targetEntityId"], d["eventTime"]) for d in found] != [
            (d["targetEntityId"], d["eventTime"]) for d in want]:
        fail(f"[ingest-api] filtered GET /events.json of {user}: {status} {str(found)[:300]}")
    seg = _http(port, "POST", f"/webhooks/segmentio.json?{side}",
                {"version": "2", "type": "track", "userId": "seg-1", "event": "Played",
                 "properties": {"song": "a"}, "timestamp": "2026-01-02T00:00:00.000Z"})
    mail = _http(port, "POST", f"/webhooks/mailchimp.form?{side}",
                 "type=subscribe&fired_at=2026-01-02+00%3A00%3A00&data%5Bemail%5D=a%40b.c",
                 content_type="application/x-www-form-urlencoded")
    if seg[0] != 201 or mail[0] != 201:
        fail(f"[ingest-api] webhooks: segmentio {seg[:2]}, mailchimp {mail[:2]}")
    log(f"[ingest-api] {len(checks)} refusals and writes with the reference's statuses "
        f"(401 x3, 403, 201, 400 x2); a channel POST read back only from its channel; "
        f"GET/DELETE/GET /events/{{id}}.json {steps}; filtered GET with limit 5 and "
        f"reversed; SegmentIO and MailChimp webhooks 201")


def phase_feedback_loop(pio: _Pio, es_port: int, key: str) -> int:
    """18d: `pio train` from the REST-ingested app, `pio deploy
    --feedback`, 30 queries through the flash kernel, one `predict` event
    per query back in the event store, `pio undeploy`. Returns the deploy
    process's kernel launches."""
    engine_json = os.path.join(pio.base, "ingest.json")
    with open(engine_json, "w") as f:
        json.dump({"id": "ingest", "engineFactory":
                   "predictionio_tpu_torch.templates.sessionrec.engine_factory",
                   "datasource": {"params": {"app_name": "ingest"}},
                   "algorithms": [{"name": "seqrec", "params": PIO_SESSION_TRAIN}]}, f)
    instance_id = pio.train("ingest-loop", engine_json)
    proc, port, _ = pio.deploy("ingest-loop", engine_json, "--engine-instance-id", instance_id,
                               "--no-batching", "--feedback", "--event-server-ip",
                               "127.0.0.1", "--event-server-port", str(es_port),
                               # one key in 64 starts with "-", which argparse
                               # takes for an option unless it is joined by "="
                               f"--accesskey={key}")
    try:
        rng = np.random.default_rng(SEED + 18)
        users = [int(u) for u in rng.choice(INGEST_USERS, INGEST_QUERIES, replace=False)]
        queries = [{"user": f"u{u}", "num": (10, 20, 5)[j % 3]} for j, u in enumerate(users)]
        for j in range(0, INGEST_QUERIES, 2):
            queries[j]["prId"] = f"pr-{j}"
        before = _status(port)
        docs, rtts = _serve_http("ingest-loop", port, queries)
        after = _status(port)
        t_sent = time.perf_counter()
        predict = []
        while time.perf_counter() - t_sent < FEEDBACK_WAIT_S:
            status, predict, _ = _http(es_port, "GET", f"/events.json?accessKey={key}"
                                                       "&event=predict&entityType=pio_pr&limit=-1")
            if status == 200 and len(predict) >= INGEST_QUERIES:
                break
            time.sleep(0.1)
        feedback_s = time.perf_counter() - t_sent
        pio.run("ingest-loop", "undeploy", "--ip", "127.0.0.1", "--port", str(port))
        if proc.wait(timeout=30) != 0:
            fail(f"[ingest-loop] the deploy process exited {proc.returncode} after undeploy")
    finally:
        if proc.poll() is None:
            _stop(proc)
    launches = (after["kernelLaunches"]["flash_attention"]
                - before["kernelLaunches"]["flash_attention"])
    layers = PIO_SESSION_TRAIN["n_layers"]
    if launches != layers * INGEST_QUERIES or after["engineInstanceId"] != instance_id:
        fail(f"[ingest-loop] {launches} kernel launches for {INGEST_QUERIES} queries, or "
             f"instance {after['engineInstanceId']} instead of {instance_id}")
    by_pr = {}
    for e in predict:
        by_pr.setdefault(e["entityId"], []).append(e)
    for body, doc in zip(queries, docs):
        pr_id = doc.get("prId")
        if not pr_id or ("prId" in body and pr_id != body["prId"]):
            fail(f"[ingest-loop] {body}: the answer's prId is {pr_id!r}")
        got = by_pr.get(pr_id, [])
        query = {k: v for k, v in body.items() if k != "prId"}
        if len(got) != 1 or got[0]["properties"] != {"query": query, "prediction": doc}:
            fail(f"[ingest-loop] {body}: {len(got)} predict events for prId {pr_id}: "
                 f"{str(got)[:500]}")
    if len(predict) != INGEST_QUERIES:
        fail(f"[ingest-loop] {len(predict)} predict events for {INGEST_QUERIES} queries")
    log(f"[ingest-loop] {INGEST_QUERIES} queries (half with a prId): "
        f"http_p50_ms={statistics.median(rtts):.3f}; kernelLaunches.flash_attention={launches} "
        f"({layers} a query); exactly one predict event per query, carrying its query and "
        f"prediction, readable {feedback_s:.3f}s after the last answer; `pio undeploy` exit 0")
    storage = Storage({"PIO_FS_BASEDIR": pio.env["PIO_FS_BASEDIR"]})
    deployed = load_deployed_engine(storage, ServerConfig(engine_instance_id=instance_id,
                                                          device=DEVICE))
    model = deployed.models[0]
    if model.cfg.vocab != N_ITEMS + 1 or model.cfg.max_len != PIO_SESSION_TRAIN["max_len"]:
        fail(f"[ingest-loop] the trained model has vocab {model.cfg.vocab}, "
             f"max_len {model.cfg.max_len}")
    for body, doc in zip(queries, docs):
        want = deployed.query(sessionrec.Query(user=body["user"], num=body["num"]))
        if [s["item"] for s in doc["itemScores"]] != [s.item for s in want.item_scores]:
            fail(f"[ingest-loop] {body}: HTTP answer differs from the in-process deploy")
        agreement = _check_against_plain(
            model, model.histories[body["user"]][-model.cfg.max_len:], [],
            [(model.item_index[s["item"]], s["score"]) for s in doc["itemScores"]],
            min(10, body["num"]), f"ingest-loop {body['user']}")
    log(f"[ingest-loop] instance {instance_id} (vocab {model.cfg.vocab}, S "
        f"{model.cfg.max_len}): every answer equals the in-process deploy; the last against "
        f"the plain attention: {agreement}")
    del deployed, model
    storage.close()
    torch.cuda.empty_cache()
    return launches


def _drain(pio: _Pio, wal_dir: str, t0: float) -> float:
    """Seconds from ``t0`` until the journal has nothing pending."""
    from predictionio_tpu_torch.data.wal import scan_status

    deadline = time.monotonic() + PIO_STEP_TIMEOUT
    while scan_status(wal_dir)["depth"] > 0:
        if time.monotonic() > deadline:
            fail(f"[ingest-wal] the journal did not drain: {scan_status(wal_dir)}")
        time.sleep(0.05)
    return time.perf_counter() - t0


def phase_durable_ingest(pio: _Pio, app_id: int, key: str) -> None:
    """18e: the event server over binevents with the write-through WAL:
    INGEST_WAL_EVENTS events all 202, drained into the store and read back through
    the native scanner; then SIGKILL during a second burst, a restart,
    and every acknowledged event read back."""
    from predictionio_tpu_torch.storage import binevents

    env = _binevents_env(pio)
    wal_dir = os.path.join(pio.base, "wal")
    flags = ("--stats", "--wal-dir", wal_dir, "--wal-policy", "write-through",
             "--wal-fsync", "interval")
    docs = _ml100k_docs()[0]
    proc, port, start_s = pio.eventserver("ingest-wal", *flags, env=env)
    try:
        results, seconds = _send_batches(port, key, docs[:INGEST_WAL_EVENTS], INGEST_CLIENTS)
        t_sent = time.perf_counter()
        bad = [r for r in results if r is None or r["status"] != 202]
        if bad:
            fail(f"[ingest-wal] {len(bad)} events without a 202, first {bad[:3]}")
        drain_s = _drain(pio, wal_dir, t_sent)
        out, _ = pio.run("ingest-wal", "wal", "status", "--wal-dir", wal_dir)
        if "pending: 0 record(s)" not in out:
            fail(f"[ingest-wal] pio wal status: {out}")
        log(f"[ingest-wal] {INGEST_WAL_EVENTS} events into binevents through the write-through "
            f"WAL: {seconds:.3f}s, events_per_s={INGEST_WAL_EVENTS / seconds:.1f}, every "
            f"status 202; drained {drain_s:.3f}s after the last 202 (`pio wal status`: 0 "
            f"pending)")
        storage = Storage(env)
        events = storage.get_events()
        scans = binevents.NATIVE_SCANS
        t0 = time.perf_counter()
        stored = {e.event_id: e for e in events.find(app_id)}
        read_s = time.perf_counter() - t0
        if not events.native_active or binevents.NATIVE_SCANS != scans + 1:
            fail("[ingest-wal] the binevents read did not go through the native scanner")
        sent = {r["eventId"]: d for r, d in zip(results, docs)}
        if stored.keys() != sent.keys() or any(
                _event_fields(stored[i]) != _doc_fields(d) for i, d in sent.items()):
            fail(f"[ingest-wal] the store holds {len(stored)} events, not the "
                 f"{len(sent)} sent")
        log(f"[ingest-wal] the app's read equals what was sent ({len(stored)} events, "
            f"{read_s:.3f}s, served by the native scanner)")
        # a second burst, killed under load
        import threading

        box: list = []
        progress: list[int] = []
        burst = threading.Thread(target=lambda: box.append(_send_batches(
            port, key, docs[INGEST_WAL_EVENTS:], INGEST_CLIENTS, acked=progress)))
        burst.start()
        deadline = time.monotonic() + 60
        while (sum(progress) < KILL_AFTER_ACKS and burst.is_alive()
               and time.monotonic() < deadline):
            time.sleep(0.005)
        proc.kill()
        proc.wait(timeout=30)
        burst.join(timeout=120)
        acked = {r["eventId"] for r in box[0][0] if r is not None and r["status"] == 202}
        log(f"[ingest-wal] SIGKILL after {len(acked)} acknowledged events of the second burst")
        if not acked:
            fail("[ingest-wal] no event of the second burst was acknowledged before the kill")
        proc, port, restart_s = pio.eventserver("ingest-wal-restart", *flags, env=env)
        drain_s = _drain(pio, wal_dir, time.perf_counter())
        after = {e.event_id for e in events.find(app_id)}
        lost = acked - after
        if lost or not set(sent) <= after:
            fail(f"[ingest-wal] {len(lost)} acknowledged events lost after the kill")
        log(f"[ingest-wal] restart {restart_s:.3f}s, drained {drain_s:.3f}s: every one of the "
            f"{len(acked)} acknowledged events read back ({len(after) - len(sent)} stored in "
            f"all from the burst)")
        storage.close()
    finally:
        _stop(proc)
    log(f"[ingest-wal] event server start {start_s:.3f}s")


def phase_ingest(pio: _Pio) -> int:
    """Phase 18 over phase 16a's import; returns the flash kernel's
    launches in 18d's deploy process."""
    t0 = time.perf_counter()
    app_id, key, view_key = ingest_setup(pio)
    proc, port, start_s = pio.eventserver("ingest", "--stats")
    try:
        for path in ("/", "/readyz"):
            status, doc, _ = _http(port, "GET", path)
            if status != 200:
                fail(f"[ingest] GET {path}: {status} {doc}")
        log(f"[ingest] pio eventserver: listening after {start_s:.3f}s; GET / and /readyz 200")
        phase_ingest_rest(pio, port, app_id, key)
        phase_ingest_refusals(port, key, view_key)
        launches = phase_feedback_loop(pio, port, key)
    finally:
        _stop(proc)
    if proc.returncode != 0:
        fail(f"[ingest] the event server exited {proc.returncode} on SIGTERM")
    phase_durable_ingest(pio, app_id, key)
    log(f"[ingest] phase 18 took {time.perf_counter() - t0:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# Phases 19-21: the rest of the template gallery
# ---------------------------------------------------------------------------

#: item categories at the ML-20M shape: ML-20M has 20 genre labels; each
#: item gets 1-3 of them, seeded
N_CATEGORIES = 20
#: phase 20's ML-100k-shape shop: users, items, view events, buy events;
#: its views cut from 100,000 to 50,000 to make room for phase 27 (the
#: `pio import` of the shop took ~17 s of the script) and to 25,000 for
#: phase 29 (every user still views 20 items)
SHOP = (943, 1_682, 25_000, 2_000)
SIM_FACTORY = "predictionio_tpu_torch.templates.similarproduct.engine_factory"
ECOMM_FACTORY = "predictionio_tpu_torch.templates.ecommerce.engine_factory"
CLASS_FACTORY = "predictionio_tpu_torch.templates.classification.engine_factory"
#: UCI Covertype's shape: rows, features (10 integer-valued + 44 binary),
#: classes; its class shares (covtype.info), which the data keeps
COVTYPE = (581_012, 54, 7)
COVTYPE_SHARES = (0.3646, 0.4876, 0.0615, 0.0047, 0.0163, 0.0299, 0.0354)
#: rows the host grows the forest on and runs float64 Adam on (a depth
#: cut: CART over all rows is minutes of NumPy; halved from 58,101 to make
#: room for phase 28) and the forest: 10 trees, depth 5, sqrt features
FOREST_SAMPLE, FOREST_TREES, FOREST_DEPTH = 29_050, 10, 5
#: logreg at the JAX template's defaults
LOGREG_STEPS, LOGREG_LR, LOGREG_L2 = 300, 0.1, 1e-4
#: entities of the classification template in sqlite (a depth cut of
#: the 581,012 rows) and its HTTP queries
CLASS_ENTITIES, CLASS_QUERIES = 20_000, 32
#: the f32 card against float64 on the host: naive Bayes logs (sums of
#: integer counts, exact in f32 below 2^24), the logreg trajectory on
#: the forest's sample (relative Frobenius distance of W after 300 steps,
#: and the loss), the full-data loss at the trained W (relative)
NB_LOG_TOL, LOGREG_W_RTOL, LOGREG_LOSS_RTOL = 1e-4, 1e-3, 1e-4


def _ids(prefix: str, n: int) -> EntityIdIxMap:
    return EntityIdIxMap(BiMap({f"{prefix}{i}": i for i in range(n)}))


def _all_seen(coo: als.RatingsCOO) -> dict[int, np.ndarray]:
    """Every row's sorted distinct columns, from the COO."""
    order = np.argsort(coo.rows, kind="stable")
    su, si = coo.rows[order], coo.cols[order]
    bounds = np.searchsorted(su, np.arange(coo.num_rows + 1))
    return {u: np.unique(si[bounds[u]:bounds[u + 1]]).astype(np.int32)
            for u in range(coo.num_rows) if bounds[u + 1] > bounds[u]}


def _categories(n_items: int, seed: int) -> dict[str, tuple]:
    rng = np.random.default_rng(seed)
    return {f"i{j}": tuple(f"g{c}" for c in sorted(rng.choice(N_CATEGORIES, k, replace=False)))
            for j, k in enumerate(rng.integers(1, 4, n_items))}


def _train_timed(tag: str, algo, ctx: EngineContext, pd) -> tuple[object, dict]:
    """``algo.train`` on the card: seconds, the iterations' ms (CUDA events
    around ``_als_iterate_fused``), peak memory; both layouts must come
    from the native packer."""
    real, timed = als._als_iterate_fused, {}

    def iterate(*args, **kw):
        timed["ms"], out = _events_ms(lambda: real(*args, **kw))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = als.NATIVE_LADDERS
    als._als_iterate_fused = iterate
    t0 = time.perf_counter()
    try:
        model = algo.train(ctx, pd)
        torch.cuda.synchronize()
    finally:
        als._als_iterate_fused = real
    seconds = time.perf_counter() - t0
    if als.NATIVE_LADDERS != before + 2:
        fail(f"[{tag}] training packed {als.NATIVE_LADDERS - before} of 2 layouts natively")
    p = algo.params
    stats = dict(train_s=seconds, ms_per_iteration=timed["ms"] / p.num_iterations,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"[{tag}] train (rank {p.rank}, {p.num_iterations} iterations, lambda {p.lambda_}, "
        f"alpha {p.alpha}, implicit): train_s={seconds:.3f} "
        f"ms_per_iteration={stats['ms_per_iteration']:.3f} (layout and staging "
        f"{seconds - timed['ms'] / 1e3:.3f}s) peak_mem_gb={stats['peak_mem_gb']:.3f}")
    if not bool(torch.isfinite(model.als.item_factors).all()):
        fail(f"[{tag}] the factors are not finite")
    return model, stats


def _hold(tag: str, body: dict, served: list, ref: np.ndarray, ok: np.ndarray, num: int,
          item_ids: EntityIdIxMap) -> tuple[float, bool]:
    """A served [(item, score)] against float64 scores of every item
    (``ref``) where ``ok``, ranked by the tie rule (score desc, index
    asc) and cut to ``num``: as many items, each eligible, each score
    within ALS_SCORE_TOL, and at every position the reference's item or
    one whose reference score is within ALS_SCORE_TOL of it (a near-tie
    f32 cannot order). Returns (largest score error, ids and order
    exactly the reference's)."""
    idx = np.nonzero(ok)[0]
    order = idx[np.lexsort((idx, -ref[idx]))][:num]
    if len(served) != len(order):
        fail(f"[{tag}] {json.dumps(body)[:90]}: {len(served)} items served, the float64 "
             f"reference has {len(order)}")
    err, exact = 0.0, True
    for (item, score), want in zip(served, order):
        j = item_ids.get(item)
        if j is None or not ok[j]:
            fail(f"[{tag}] {json.dumps(body)[:90]}: served {item}, which the rules exclude")
        err = max(err, abs(score - ref[j]))
        if j != want:
            exact = False
            if abs(ref[j] - ref[want]) > ALS_SCORE_TOL:
                fail(f"[{tag}] {json.dumps(body)[:90]}: {item} where the float64 reference "
                     f"ranks {item_ids.inverse[int(want)]} ({ref[j]} vs {ref[want]})")
    if err > ALS_SCORE_TOL:
        fail(f"[{tag}] {json.dumps(body)[:90]}: score error {err:.3e} > {ALS_SCORE_TOL}")
    return err, exact


def _allow_ok(n_items: int, allow) -> np.ndarray:
    return np.ones(n_items, dtype=bool) if allow is None else np.asarray(allow) > 0


def _similar_ref(als_model: ALSModel, items: list, allow, item_f64: np.ndarray):
    """float64 cosine scores of every item against the mean of the known
    query items, and the eligible mask (the query items excluded); None
    when no query item is known."""
    ixs = [als_model.item_ids.get(i) for i in items]
    ixs = [i for i in ixs if i is not None]
    if not ixs:
        return None
    q = item_f64[ixs].mean(0)
    itn = item_f64 / np.maximum(np.linalg.norm(item_f64, axis=1, keepdims=True), 1e-9)
    ref = itn @ (q / max(np.linalg.norm(q), 1e-9))
    ok = _allow_ok(len(ref), allow)
    ok[ixs[:512]] = False
    return ref, ok


def _recommend_ref(als_model: ALSModel, user: str, allow, exclude_seen: bool,
                   item_f64: np.ndarray):
    uix = als_model.user_ids[user]
    ref = item_f64 @ als_model.user_factors[uix].double().cpu().numpy()
    ok = _allow_ok(len(ref), allow)
    if exclude_seen:
        ok[als_model.seen_by_user.get(uix, np.empty(0, np.int64))] = False
    return ref, ok


def _sim_queries(rng, n_items: int, category_map: dict) -> list[dict]:
    """64 similar-product queries: 1-5 query items; categories, white and
    black lists; an empty category set and unknown items (empty
    answers)."""
    pick = lambda n: [f"i{j}" for j in rng.choice(n_items, min(n, n_items), replace=False)]
    cats = lambda: [f"g{c}" for c in rng.choice(N_CATEGORIES, int(rng.integers(1, 3)),
                                                replace=False)]
    qs = [{"items": pick(1), "num": 10} for _ in range(16)]
    qs += [{"items": pick(int(rng.integers(2, 6))), "num": 20} for _ in range(16)]
    qs += [{"items": pick(2), "num": 10, "categories": cats()} for _ in range(8)]
    qs += [{"items": pick(1), "num": 10, "whiteList": pick(300)} for _ in range(8)]
    qs += [{"items": pick(3), "num": 10, "blackList": pick(200)} for _ in range(8)]
    qs += [{"items": pick(1), "num": 25, "categories": cats(), "blackList": pick(500)}
           for _ in range(4)]
    qs += [{"items": pick(2), "num": 10, "categories": []},
           {"items": pick(1), "num": 10, "whiteList": []},
           {"items": ["nope"], "num": 10}, {"items": [], "num": 10}]
    return qs


def _ecomm_queries(rng, n_users: int, n_items: int, newcomers: list) -> list[dict]:
    """64 e-commerce queries: known users at num 10, 100 and 1000; categories,
    white and black lists; newcomers who fall back to their recent views;
    a user with no views and an empty category set (empty answers)."""
    pick = lambda n: [f"i{j}" for j in rng.choice(n_items, min(n, n_items), replace=False)]
    user = lambda: f"u{int(rng.integers(0, n_users))}"
    cats = lambda: [f"g{c}" for c in rng.choice(N_CATEGORIES, int(rng.integers(1, 3)),
                                                replace=False)]
    qs = [{"user": user(), "num": 10} for _ in range(20)]
    qs += [{"user": user(), "num": 100} for _ in range(8)]
    qs += [{"user": user(), "num": 10, "categories": cats()} for _ in range(8)]
    qs += [{"user": user(), "num": 10, "whiteList": pick(300)} for _ in range(8)]
    qs += [{"user": user(), "num": 10, "blackList": pick(200)} for _ in range(8)]
    qs += [{"user": user(), "num": 20, "categories": cats(), "whiteList": pick(2000),
            "blackList": pick(100)} for _ in range(4)]
    qs += [{"user": u, "num": 10} for u in newcomers[:2]]
    qs += [{"user": u, "num": 10, "categories": cats()} for u in newcomers[2:4]]
    qs += [{"user": newcomers[0], "num": 25, "blackList": pick(100)},
           {"user": user(), "num": 1000}]
    qs += [{"user": "nobody", "num": 10}, {"user": user(), "num": 10, "categories": []}]
    return qs


def _serve_checked(tag: str, algo, model, queries: list[dict], query_cls, reference) -> dict:
    """Every query through ``algo.predict`` on the card, held against
    ``reference(body) -> (scores, ok) | None`` (None: an empty answer);
    then device ms and launches per query (torch.profiler over 16)."""
    worst, exact, empty = 0.0, 0, 0
    for body in queries:
        served = [(s.item, s.score) for s in algo.predict(model, from_wire(query_cls,
                                                                             body)).item_scores]
        ref = reference(body)
        if ref is None:
            if served:
                fail(f"[{tag}] {json.dumps(body)[:90]}: expected no answer, got {served[:3]}")
            empty += 1
            continue
        err, same = _hold(tag, body, served, *ref, body["num"], model.als.item_ids)
        worst, exact = max(worst, err), exact + same
    sample = [from_wire(query_cls, b) for b in queries[:16]]
    dev_ms, n = _profile(lambda: [algo.predict(model, q) for q in sample])
    out = dict(queries=len(queries), exact=exact, empty=empty, max_score_err=worst,
               device_ms_per_query=dev_ms and dev_ms / len(sample),
               launches_per_query=n / len(sample))
    log(f"[{tag}] {len(queries)} queries held against float64 ({exact} equal in ids and "
        f"order, {len(queries) - exact - empty} within near-ties, {empty} empty as expected; "
        f"max score err {worst:.3e}, tol {ALS_SCORE_TOL:g}); device_ms_per_query="
        f"{_fmt(out['device_ms_per_query'], 4)} launches_per_query={out['launches_per_query']:.1f}")
    return out


#: phase 19's ALS iterations a template (cut from the JAX package's default
#: 20 to make room for phase 28; rank, λ and α stay the defaults)
TEMPLATE_ITERS = 10
#: phase 19's power-law views over the ML-20M users x items (cut from 20M
#: to make room for phase 29; the widths stay)
TEMPLATE_VIEWS = 10_000_000


def phase_als_templates() -> None:
    """Phase 19: similar product and e-commerce at the ML-20M shape."""
    n_users, n_items, _ = ML20M
    nnz = TEMPLATE_VIEWS
    t0 = time.perf_counter()
    u, i, _ = make_ratings(n_users, n_items, nnz, SEED)
    coo = als.RatingsCOO(u, i, np.ones(nnz, dtype=np.float32), n_users, n_items)
    category_map = _categories(n_items, SEED + 19)
    seen = _all_seen(coo)
    base = dict(coo=coo, user_ids=_ids("u", n_users), item_ids=_ids("i", n_items),
                seen_by_user=seen, categories=category_map)
    log(f"[templates] {nnz} views of {n_users} users x {n_items} items as implicit "
        f"feedback, {N_CATEGORIES} categories, prepared in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(SEED + 19)
    # the e-commerce algorithm's live reads: a small store holding the
    # constraint and the recent views of four users the model never saw
    store = memory_storage()
    app_id = store.get_meta_data_apps().insert(App(0, "ML20M"))
    store.get_events().init(app_id)
    t_ev = datetime(2026, 1, 1, tzinfo=timezone.utc)
    newcomers = [f"new{k}" for k in range(4)]
    recent = {u: [f"i{j}" for j in rng.choice(n_items, 12, replace=False)] for u in newcomers}
    unavailable = [f"i{j}" for j in rng.choice(n_items, 50, replace=False)]
    store.get_events().insert_batch(
        [Event(event="view", entity_type="user", entity_id=u, target_entity_type="item",
               target_entity_id=item, event_time=t_ev + timedelta(seconds=k))
         for u in newcomers for k, item in enumerate(recent[u])]
        + [Event(event="$set", entity_type="constraint", entity_id="unavailableItems",
                 properties=DataMap({"items": unavailable}),
                 event_time=t_ev + timedelta(seconds=100))], app_id)
    ctx = EngineContext(storage=store, device=DEVICE)

    sim_algo = similarproduct.SimilarALSAlgorithm(
        similarproduct.ALSAlgorithmParams(num_iterations=TEMPLATE_ITERS))
    sim_model, sim_stats = _train_timed("similarproduct", sim_algo, ctx,
                                        similarproduct.SimilarPreparedData(**base))
    item_f64 = sim_model.als.item_factors.double().cpu().numpy()

    def sim_reference(body):
        q = from_wire(similarproduct.Query, body)
        return _similar_ref(sim_model.als, list(q.items), sim_algo._allow_vector(sim_model, q),
                            item_f64)

    _serve_checked("similarproduct", sim_algo, sim_model,
                   _sim_queries(rng, n_items, category_map), similarproduct.Query,
                   sim_reference)
    del sim_model
    torch.cuda.empty_cache()

    ecomm_algo = ecommerce.ECommAlgorithm(
        ecommerce.ECommAlgorithmParams(app_name="ML20M", num_iterations=TEMPLATE_ITERS))
    ecomm_model, ecomm_stats = _train_timed("ecommerce", ecomm_algo, ctx,
                                            ecommerce.ECommPreparedData(**base))
    als_model = ecomm_model.als
    item_f64 = als_model.item_factors.double().cpu().numpy()
    gone = {als_model.item_ids[i] for i in unavailable}

    def ecomm_reference(body):
        q = from_wire(ecommerce.Query, body)
        allow = build_allow_vector(als_model.item_ids, categories=q.categories,
                                   category_map=ecomm_model.categories,
                                   white_list=q.white_list, black_list=q.black_list)
        allow = np.ones(n_items, np.float32) if allow is None else allow
        allow[list(gone)] = 0.0
        if q.user in als_model.user_ids:
            return _recommend_ref(als_model, q.user, allow, True, item_f64)
        views = recent.get(q.user)
        return None if not views else _similar_ref(als_model, views[::-1][:10], allow,
                                                   item_f64)

    queries = _ecomm_queries(rng, n_users, n_items, newcomers)
    _serve_checked("ecommerce", ecomm_algo, ecomm_model, queries, ecommerce.Query,
                   ecomm_reference)
    del ecomm_model, als_model
    torch.cuda.empty_cache()
    log(f"[templates] phase 19 took {time.perf_counter() - t0:.1f}s")


def _shop_docs():
    """Phase 20's ML-100k-shape shop as event JSON: view events (every
    user views at least 20 items), 2,000 buys, each item's categories
    and an ``unavailableItems`` constraint; and the generator."""
    n_users, n_items, n_view, n_buy = SHOP
    rng = np.random.default_rng(SEED + 20)
    users = np.concatenate([np.repeat(np.arange(n_users), 20),
                            (n_users * rng.random(n_view - 20 * n_users) ** 1.5).astype(int)])
    items = (n_items * rng.random(n_view + n_buy) ** 1.5).astype(int)
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)

    def stamp(n: int) -> str:
        return (t0 + timedelta(seconds=n)).strftime("%Y-%m-%dT%H:%M:%S.000Z")

    docs = [{"event": "$set", "entityType": "item", "entityId": item,
             "properties": {"categories": list(cats)}, "eventTime": stamp(0)}
            for item, cats in _categories(n_items, SEED + 20).items()]
    docs += [{"event": "view", "entityType": "user", "entityId": f"u{u}",
              "targetEntityType": "item", "targetEntityId": f"i{i}", "eventTime": stamp(1 + j)}
             for j, (u, i) in enumerate(zip(users, items))]
    docs += [{"event": "buy", "entityType": "user", "entityId": f"u{u}",
              "targetEntityType": "item", "targetEntityId": f"i{i}",
              "eventTime": stamp(1 + n_view + j)}
             for j, (u, i) in enumerate(zip(rng.integers(0, n_users, n_buy), items[n_view:]))]
    docs.append({"event": "$set", "entityType": "constraint", "entityId": "unavailableItems",
                 "properties": {"items": [f"i{j}" for j in range(0, 40, 2)]},
                 "eventTime": stamp(2 + n_view + n_buy)})
    return docs, rng


def _items_of(doc: dict) -> list[str]:
    return [s["item"] for s in doc.get("itemScores", [])]


def phase_shop_end_to_end(pio: _Pio) -> None:
    """Phase 20: e-commerce through `pio import` → `pio train` → `pio
    deploy` → HTTP, with an ``unavailableItems`` $set and a newcomer's
    views POSTed to the event server after deploy; then similar product
    in process: `run_train` → stored instance → engine server."""
    n_users, n_items, _, _ = SHOP
    t_phase = time.perf_counter()
    docs, rng = _shop_docs()
    events_path = os.path.join(pio.base, "shop.jsonl")
    n = _write_json_lines(events_path, docs)
    out, _ = pio.run("shop", "app", "new", "shop")
    app_id = int(re.search(r"ID: (\d+)", out).group(1))
    key = re.search(r"Access Key: (\S+)", out).group(1)
    out, _ = pio.run("shop", "import", "--appid", str(app_id), "--input", events_path)
    if f"Imported {n} events" not in out:
        fail(f"[shop] import: {out}")
    engine_json = os.path.join(pio.base, "ecommerce.json")
    with open(engine_json, "w") as f:
        json.dump({"id": "shop", "engineFactory": ECOMM_FACTORY,
                   "datasource": {"params": {"appName": "shop"}},
                   "algorithms": [{"name": "ecomm", "params": {"appName": "shop"}}]}, f)
    instance_id = pio.train("shop", engine_json)
    storage = Storage({"PIO_FS_BASEDIR": pio.env["PIO_FS_BASEDIR"]})
    deployed = load_deployed_engine(storage, ServerConfig(engine_instance_id=instance_id,
                                                          device=DEVICE))
    model = deployed.models[0].als
    pick = lambda k: [f"i{j}" for j in rng.choice(n_items, min(k, n_items), replace=False)]
    users = [f"u{u}" for u in rng.choice(n_users, 24, replace=False)]
    queries = ([{"user": u, "num": 10} for u in users[:12]]
               + [{"user": u, "num": 10, "categories": [f"g{int(rng.integers(0, 20))}"]}
                  for u in users[12:16]]
               + [{"user": u, "num": 10, "whiteList": pick(400)} for u in users[16:20]]
               + [{"user": u, "num": 10, "blackList": pick(100)} for u in users[20:24]]
               + [{"user": "newbie", "num": 10}])
    proc, port, _ = pio.deploy("shop", engine_json)
    es_proc = None
    try:
        first, rtts = _serve_http("shop", port, queries)
        old = {f"i{j}" for j in range(0, 40, 2)}
        if any(set(_items_of(d)) & old for d in first) or _items_of(first[-1]):
            fail("[shop] an answer holds an unavailable item, or the newcomer was answered")
        # the items the first answers ranked highest become unavailable
        new = sorted({_items_of(d)[0] for d in first[:12] if _items_of(d)})
        es_proc, es_port, _ = pio.eventserver("shop-es")
        later = [{"event": "$set", "entityType": "constraint", "entityId": "unavailableItems",
                  "properties": {"items": new}},
                 *({"event": "view", "entityType": "user", "entityId": "newbie",
                    "targetEntityType": "item", "targetEntityId": f"i{j}"} for j in (1, 3, 5))]
        for body in later:
            status, doc, _ = _http(es_port, "POST", f"/events.json?accessKey={key}", body)
            if status != 201:
                fail(f"[shop] POST /events.json answered {status}: {doc}")
        second, more = _serve_http("shop", port, queries)
        rtts += more
        moved = sum(a != b for a, b in zip(first, second))
        if any(set(_items_of(d)) & set(new) for d in second) or not _items_of(second[-1]):
            fail("[shop] the answers after the POSTed constraint hold a newly unavailable "
                 "item, or the newcomer got no answer")
        for body, doc in zip(queries, second):
            want = deployed.query(from_wire(ecommerce.Query, body))
            if [(s["item"], s["score"]) for s in doc["itemScores"]] != [
                    (s.item, s.score) for s in want.item_scores]:
                fail(f"[shop] {body}: the HTTP answer differs from the in-process deploy")
        log(f"[shop] {len(queries)} queries before and after POSTing a new unavailableItems "
            f"({len(new)} items) and a newcomer's views: {moved} answers moved, none holds an "
            f"unavailable item, all equal the in-process deploy of the instance; "
            f"http_p50_ms={statistics.median(rtts):.3f}")
    finally:
        _stop(proc)
        if es_proc is not None:
            _stop(es_proc)
    item_f64 = model.item_factors.double().cpu().numpy()
    worst = 0.0
    for body in queries[:-1]:
        q = from_wire(ecommerce.Query, body)
        allow = build_allow_vector(model.item_ids, categories=q.categories,
                                   category_map=deployed.models[0].categories,
                                   white_list=q.white_list, black_list=q.black_list)
        allow = np.ones(n_items, np.float32) if allow is None else allow
        allow[[model.item_ids[i] for i in new if i in model.item_ids]] = 0.0
        served = [(s.item, s.score) for s in deployed.query(q).item_scores]
        worst = max(worst, _hold("shop", body, served,
                                 *_recommend_ref(model, q.user, allow, True, item_f64), q.num,
                                 model.item_ids)[0])
    log(f"[shop] the known users' answers held against float64 (max score err {worst:.3e})")

    # similar product in process over the same store
    t0 = time.perf_counter()
    outcome = run_train(variant={
        "engineFactory": SIM_FACTORY, "datasource": {"params": {"appName": "shop"}},
        "algorithms": [{"name": "als", "params": {}}]},
        ctx=EngineContext(storage=storage, device=DEVICE))
    log(f"[shop-sim] run_train {outcome.status} in {time.perf_counter() - t0:.3f}s: "
        f"{format_stage_times(outcome.stage_seconds)}")
    server = create_engine_server(storage, _local(engine_instance_id=outcome.instance_id)).start()
    try:
        sim = server.deployed.models[0]
        item_f64 = sim.als.item_factors.double().cpu().numpy()
        mix = _sim_queries(rng, n_items, sim.categories)
        sim_queries = mix[:8] + mix[16:24] + mix[32:48] + mix[60:]
        worst, docs_ = 0.0, _serve_http("shop-sim", server.port, sim_queries)[0]
        for body, doc in zip(sim_queries, docs_):
            served = [(s["item"], s["score"]) for s in doc["itemScores"]]
            q = from_wire(similarproduct.Query, body)
            if served != [(s.item, s.score) for s in server.deployed.query(q).item_scores]:
                fail(f"[shop-sim] {body}: the HTTP answer differs from the deployed engine")
            ref = _similar_ref(sim.als, list(q.items),
                               server.deployed.algorithms[0]._allow_vector(sim, q), item_f64)
            if ref is None:
                if served:
                    fail(f"[shop-sim] {body}: expected no answer, got {served[:3]}")
                continue
            worst = max(worst, _hold("shop-sim", body, served, *ref, q.num,
                                     sim.als.item_ids)[0])
        log(f"[shop-sim] {len(sim_queries)} HTTP queries equal the deployed engine and the "
            f"float64 reference (max score err {worst:.3e})")
    finally:
        server.stop()
    log(f"[shop] phase 20 took {time.perf_counter() - t_phase:.1f}s")


def covtype_data(rows: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Covertype-shaped rows: 10 integer-valued features (class-conditional
    Poisson means around 1-50) then 44 binary ones (class-conditional
    Bernoulli), 7 classes in Covertype's shares; f32 / int32."""
    n_feat, n_cls = COVTYPE[1], COVTYPE[2]
    rng = np.random.default_rng(seed)
    y = rng.choice(n_cls, rows, p=np.asarray(COVTYPE_SHARES) / sum(COVTYPE_SHARES))
    # classes overlap as Covertype's do: each class moves a shared
    # profile by ~20-30 %
    means = rng.uniform(1.0, 50.0, 10) * np.exp(0.2 * rng.standard_normal((n_cls, 10)))
    probs = np.clip(rng.uniform(0.05, 0.5, n_feat - 10)
                    * np.exp(0.3 * rng.standard_normal((n_cls, n_feat - 10))), 0.01, 0.95)
    X = np.empty((rows, n_feat), dtype=np.float32)
    X[:, :10] = rng.poisson(means[y])
    X[:, 10:] = rng.random((rows, n_feat - 10)) < probs[y]
    return X, y.astype(np.int32)


def _host_adam(X: np.ndarray, y: np.ndarray, n_cls: int, steps: int) -> tuple[np.ndarray, float]:
    """The logreg fit in float64 NumPy: (W, the last step's loss)."""
    Xb = np.concatenate([X, np.ones((len(X), 1))], axis=1).astype(np.float64)
    onehot = np.eye(n_cls)[y]
    W, m, v = (np.zeros((Xb.shape[1], n_cls)) for _ in range(3))
    loss = 0.0
    for t in range(1, steps + 1):
        z = Xb @ W
        z -= z.max(1, keepdims=True)
        logp = z - np.log(np.exp(z).sum(1, keepdims=True))
        reg = W.copy()
        reg[-1] = 0.0
        loss = -(onehot * logp).sum() / len(X) + LOGREG_L2 * (reg * reg).sum()
        g = Xb.T @ (np.exp(logp) - onehot) / len(X) + 2 * LOGREG_L2 * reg
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        W = W - LOGREG_LR * (m / (1 - 0.9 ** t)) / (np.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
    return W, loss


def _host_loss(X: np.ndarray, y: np.ndarray, W: np.ndarray) -> float:
    Xb = np.concatenate([X, np.ones((len(X), 1), np.float32)], axis=1).astype(np.float64)
    z = Xb @ W
    z -= z.max(1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(1, keepdims=True))
    reg = W.copy()
    reg[-1] = 0.0
    return float(-logp[np.arange(len(y)), y].mean() + LOGREG_L2 * (reg * reg).sum())


def _host_votes(forest, X: np.ndarray) -> np.ndarray:
    """The forest's votes walked on the host (f32 comparisons, as on the
    card)."""
    votes = np.zeros((len(X), forest.num_classes), dtype=np.float32)
    rows = np.arange(len(X))
    for t in range(forest.num_trees):
        idx = np.zeros(len(X), dtype=np.int64)
        for _ in range(forest.max_depth + 1):
            f = forest.feature[t][idx]
            nxt = np.where(X[rows, np.maximum(f, 0)] <= forest.threshold[t][idx],
                           forest.left[t][idx], forest.right[t][idx])
            idx = np.where(f < 0, idx, nxt)
        np.add.at(votes, (rows, forest.leaf_class[t][idx]), 1.0)
    return votes


def phase_classification_models() -> None:
    """Phase 21a-c: naive Bayes, logreg and the forest at the Covertype
    shape, each against float64 on the host."""
    rows, n_feat, n_cls = COVTYPE
    t0 = time.perf_counter()
    X, y = covtype_data(rows, SEED + 21)
    Xd, yd = torch.from_numpy(X).to(DEVICE), torch.from_numpy(y).to(DEVICE)
    log(f"[class] {rows} x {n_feat} rows, {n_cls} classes, made in "
        f"{time.perf_counter() - t0:.1f}s")
    # (a) multinomial naive Bayes: train, score every row
    nb_ms, nb = _events_ms(lambda: naive_bayes.train_multinomial(Xd, yd, n_cls))
    score_ms, scores = _events_ms(lambda: naive_bayes.predict_multinomial_scores(
        nb.log_prior, nb.log_theta, Xd))
    counts = np.bincount(y, minlength=n_cls).astype(np.float64)
    sums = np.zeros((n_cls, n_feat))
    np.add.at(sums, y, X.astype(np.float64))
    prior = np.log(counts + 1.0) - np.log(counts.sum() + n_cls)
    theta = np.log(sums + 1.0) - np.log(sums.sum(1, keepdims=True) + n_feat)
    err = max(np.abs(nb.log_prior.double().cpu().numpy() - prior).max(),
              np.abs(nb.log_theta.double().cpu().numpy() - theta).max())
    ref_scores = prior[None, :] + X.astype(np.float64) @ theta.T
    got = scores.cpu().numpy()
    ref_sorted = np.sort(ref_scores, 1)
    decided = ref_sorted[:, -1] - ref_sorted[:, -2] > NB_LOG_TOL * np.abs(ref_scores).max()
    flips = int((got.argmax(1) != ref_scores.argmax(1))[decided].sum())
    nb_dev, nb_n = _profile(lambda: naive_bayes.train_multinomial(Xd, yd, n_cls))
    nb_bound = _bound_ms(X.nbytes + rows * 4, f32_flops=2 * rows * n_cls * n_feat)
    log(f"[class-nb] train_multinomial: ms={nb_ms:.3f} device_ms={_fmt(nb_dev, 4)} "
        f"launches={nb_n} bound_ms={nb_bound}; "
        f"scores of all rows: ms={score_ms:.3f}; log prior and log theta vs float64: max abs "
        f"err {err:.3e} (tol {NB_LOG_TOL:g}); argmax flips where float64 decides: {flips}; "
        f"accuracy {(got.argmax(1) == y).mean():.4f}")
    if err > NB_LOG_TOL or flips:
        fail("[class-nb] naive Bayes disagrees with float64")

    # (b) logreg: 300 full-batch Adam steps over every row
    torch.cuda.reset_peak_memory_stats()
    losses: list = []
    fit = lambda steps, out=None: logreg._fit(Xd, yd, torch.ones(rows, device=DEVICE), n_cls,
                                              steps, LOGREG_LR, LOGREG_L2, out)
    fit_ms, W = _events_ms(lambda: fit(LOGREG_STEPS, losses))
    step_ms = fit_ms / LOGREG_STEPS
    dev10, n10 = _profile(lambda: fit(10))
    dev20, n20 = _profile(lambda: fit(20))
    bound = _bound_ms(2 * rows * (n_feat + 1) * 4,
                      f32_flops=2 * 2 * rows * (n_feat + 1) * n_cls)
    per_step_dev = None if None in (dev10, dev20) else (dev20 - dev10) / 10
    with ieee_f32():
        full_loss = float(logreg._loss_and_grad(
            logreg._add_bias(Xd), torch.nn.functional.one_hot(yd.long(), n_cls).float(),
            torch.ones(rows, device=DEVICE), torch.tensor(float(rows), device=DEVICE), W,
            LOGREG_L2)[0])
    host_full = _host_loss(X, y, W.double().cpu().numpy())
    log(f"[class-lr] {LOGREG_STEPS} Adam steps (lr {LOGREG_LR}, l2 {LOGREG_L2}) over "
        f"{rows} rows: ms_per_step={step_ms:.4f} device_ms_per_step={_fmt(per_step_dev, 4)} "
        f"launches_per_step={(n20 - n10) / 10:.1f} bound_ms_per_step={bound} (X read twice a "
        f"step: {2 * rows * (n_feat + 1) * 4 / 1e6:.1f} MB) peak_mem_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f}; final loss {full_loss:.6f}, float64 "
        f"loss at the same W {host_full:.6f}")
    if not abs(full_loss - host_full) <= LOGREG_LOSS_RTOL * abs(host_full):
        fail("[class-lr] the card's loss disagrees with float64 at the trained W")
    sample = np.random.default_rng(SEED + 22).choice(rows, FOREST_SAMPLE, replace=False)
    Xs, ys = X[sample], y[sample]
    t1 = time.perf_counter()
    W64, loss64 = _host_adam(Xs, ys, n_cls, LOGREG_STEPS)
    host_s = time.perf_counter() - t1
    s_losses: list = []
    Ws = logreg._fit(torch.from_numpy(Xs).to(DEVICE), torch.from_numpy(ys).to(DEVICE),
                     torch.ones(len(ys), device=DEVICE), n_cls, LOGREG_STEPS, LOGREG_LR,
                     LOGREG_L2, s_losses).double().cpu().numpy()
    w_err = np.linalg.norm(Ws - W64) / np.linalg.norm(W64)
    l_err = abs(float(s_losses[-1]) - loss64) / abs(loss64)
    log(f"[class-lr] on {FOREST_SAMPLE} sampled rows against float64 Adam on the host "
        f"({host_s:.1f}s): W rel err {w_err:.3e} (tol {LOGREG_W_RTOL:g}), loss rel err "
        f"{l_err:.3e} (tol {LOGREG_LOSS_RTOL:g})")
    if w_err > LOGREG_W_RTOL or l_err > LOGREG_LOSS_RTOL:
        fail("[class-lr] the Adam trajectory disagrees with float64")

    # (c) the forest: grown on the host, votes walked on the card
    t1 = time.perf_counter()
    forest = random_forest.train_forest(Xs, ys, n_cls, num_trees=FOREST_TREES,
                                        max_depth=FOREST_DEPTH, feature_subset="sqrt", seed=SEED)
    grow_s = time.perf_counter() - t1
    tables = random_forest.device_tables(forest, DEVICE)
    walk = lambda: random_forest._forest_votes(*tables, Xd, FOREST_DEPTH, n_cls)
    walk_ms = time_ms(walk, warmup=2, n=10)
    walk_dev, walk_n = _profile(walk)
    votes = walk().cpu().numpy()
    want = _host_votes(forest, X)
    nodes = forest.feature.shape[1]
    log(f"[class-rf] {FOREST_TREES} trees of depth {FOREST_DEPTH} ({nodes} nodes a tree at "
        f"most) grown on the host in {grow_s:.2f}s on {FOREST_SAMPLE} rows; the vote walk "
        f"over {rows} rows: ms={walk_ms:.4f} device_ms={_fmt(walk_dev, 4)} "
        f"launches={walk_n} bound_ms={_bound_ms(X.nbytes + rows * n_cls * 4)}; votes equal "
        f"to the host walk: {np.array_equal(votes, want)}; accuracy "
        f"{(votes.argmax(1) == y).mean():.4f}")
    if not np.array_equal(votes, want):
        fail("[class-rf] the card's votes differ from the host walk")


def phase_classification_template(pio: _Pio) -> None:
    """Phase 21d: 20,000 entities' ``$set`` properties in sqlite →
    `run_train` with naive Bayes and logreg under BlendedServing → the
    engine server → HTTP queries; the Accuracy grid through
    `run_evaluation` on the card and on the CPU."""
    rows, n_feat, _ = COVTYPE
    X, y = covtype_data(CLASS_ENTITIES, SEED + 23)
    attrs = tuple(f"a{j}" for j in range(n_feat))
    storage = Storage({"PIO_FS_BASEDIR": pio.env["PIO_FS_BASEDIR"]})
    app_id = storage.get_meta_data_apps().insert(App(0, "covtype"))
    storage.get_events().init(app_id)
    t0 = time.perf_counter()
    t_ev = datetime(2026, 1, 1, tzinfo=timezone.utc)
    storage.get_events().insert_batch([
        Event(event="$set", entity_type="user", entity_id=f"e{n:05d}",
              properties=DataMap({**{a: float(v) for a, v in zip(attrs, X[n])},
                                  "cover": f"t{int(y[n]) + 1}"}),
              event_time=t_ev + timedelta(seconds=n)) for n in range(CLASS_ENTITIES)], app_id)
    log(f"[class-tmpl] {CLASS_ENTITIES} entities x {n_feat + 1} properties into sqlite in "
        f"{time.perf_counter() - t0:.1f}s")
    ds_params = {"appName": "covtype", "attrs": list(attrs), "label": "cover"}
    outcome = run_train(variant={
        "engineFactory": CLASS_FACTORY, "datasource": {"params": ds_params},
        "algorithms": [{"name": "naive", "params": {}}, {"name": "logreg", "params": {}}],
        "serving": {"name": "blended"}}, ctx=EngineContext(storage=storage, device=DEVICE))
    log(f"[class-tmpl] run_train {outcome.status}: "
        f"{format_stage_times(outcome.stage_seconds)}")
    if outcome.status != "COMPLETED":
        fail("[class-tmpl] training did not complete")
    server = create_engine_server(storage, _local(engine_instance_id=outcome.instance_id)).start()
    try:
        picks = np.random.default_rng(SEED + 24).choice(CLASS_ENTITIES, CLASS_QUERIES,
                                                        replace=False)
        queries = [{"attrs": [float(v) for v in X[j]]} for j in picks]
        docs, rtts = _serve_http("class-tmpl", server.port, queries)
        right = 0
        for j, body, doc in zip(picks, queries, docs):
            want = server.deployed.query(from_wire(classification.Query, body))
            if doc["label"] != want.label or doc["scores"] != want.scores or \
                    doc["label"] != max(doc["scores"], key=doc["scores"].get):
                fail(f"[class-tmpl] {j}: the HTTP answer {doc} differs from the deployed "
                     f"engine's {want}")
            right += doc["label"] == f"t{int(y[j]) + 1}"
        log(f"[class-tmpl] {CLASS_QUERIES} HTTP queries (blended naive Bayes + logreg) equal "
            f"the deployed engine; {right} labels right; http_p50_ms="
            f"{statistics.median(rtts):.3f}")
    finally:
        server.stop()
    reports = {}
    for device in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        result = run_evaluation(
            classification.ClassificationEvaluation(output_path=None),
            classification.DefaultParamsList(app_name="covtype", eval_k=3, attrs=attrs,
                                             label="cover"),
            storage=storage, ctx=EngineContext(storage=storage, device=device)).result
        reports[device] = [s.score for _, s in result.engine_params_scores]
        log(f"[class-eval] Accuracy grid (smoothing 0.5 / 1.0 / 2.0, 3 folds) on {device}: "
            f"{reports[device]} best {result.best_idx} in {time.perf_counter() - t0:.1f}s")
    if reports[DEVICE] != reports["cpu"]:
        fail("[class-eval] the card's Accuracy report differs from the CPU's")


def phase_templates(pio: _Pio) -> None:
    """Phases 19-21; none launches the flash kernel."""
    before = flash_ops.LAUNCHES
    t0 = time.perf_counter()
    phase_als_templates()
    torch.cuda.empty_cache()
    phase_shop_end_to_end(pio)
    torch.cuda.empty_cache()
    phase_classification_models()
    torch.cuda.empty_cache()
    phase_classification_template(pio)
    if flash_ops.LAUNCHES != before:
        fail(f"the template gallery launched the flash kernel {flash_ops.LAUNCHES - before} "
             "times")
    log(f"[templates] phases 19-21 took {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 22: ANN retrieval
# ---------------------------------------------------------------------------

#: the JAX package's own ANN point (bench_serving.py:1563-1623), its
#: 1,000,000 items cut to 262,144 (the host k-means of the index build
#: took 42-56 s of the script at the full catalog), then to 131,072 to
#: make room for phase 28 (~10 s of build at 262,144) and to 65,536 for
#: phase 29 (3.1-3.9 s of build at 131,072): items at rank 32 from
#: its factor mixture (256 taste clusters, noise 0.5, seeds 7 and 8),
#: 2,048 users with 8 seen items each
ANN_ITEMS, ANN_RANK, ANN_CLUSTERS, ANN_USERS, ANN_SEEN, ANN_SEED = (
    65_536, 32, 256, 2_048, 8, 7)
#: queries held against brute force at full probe and against a float64
#: rescore of their shortlist at the auto probe; the quality sample (the
#: JAX bench's quality_queries)
ANN_CHECK_QUERIES = 64
ANN_BATCHES = (1, 32)
#: f32 rescore against float64: |err| <= this × Σ_k |u_k v_k| (a 32-term
#: f32 dot product errs by at most ~32 × 2^-24 of that sum)
ANN_RESCORE_RTOL = 1e-5
#: the ML-20M-shape model over HTTP: users queried a round
ANN_HTTP_USERS = 32


def _clustered_factors(n: int, rank: int, clusters: int, seed: int,
                       noise: float = 0.5) -> np.ndarray:
    """The JAX bench's factor mixture (bench_serving._clustered_factors,
    copied): cluster centres × 2.0 plus gaussian noise."""
    rng = np.random.default_rng(seed)
    centers = (rng.standard_normal((clusters, rank)) * 2.0).astype(np.float32)
    asg = rng.integers(0, clusters, size=n)
    out = centers[asg] + rng.standard_normal((n, rank)).astype(np.float32) * noise
    return np.ascontiguousarray(out, dtype=np.float32)


def _ann_model() -> ALSModel:
    """22a: the catalog saved through ALSModel.save (the index built at
    persist time, its build seconds logged), loaded on the card, with
    retrieval=ann."""
    t0 = time.perf_counter()
    item_f = _clustered_factors(ANN_ITEMS, ANN_RANK, ANN_CLUSTERS, ANN_SEED)
    user_f = _clustered_factors(ANN_USERS, ANN_RANK, ANN_CLUSTERS, ANN_SEED + 1)
    rng = np.random.default_rng(ANN_SEED)
    seen = {u: np.unique(rng.integers(0, ANN_ITEMS, ANN_SEEN)).astype(np.int32)
            for u in range(ANN_USERS)}
    model = ALSModel(rank=ANN_RANK, user_factors=torch.from_numpy(user_f).to(DEVICE),
                     item_factors=torch.from_numpy(item_f).to(DEVICE),
                     user_ids=EntityIdIxMap(BiMap({f"u{i}": i for i in range(ANN_USERS)})),
                     item_ids=EntityIdIxMap(BiMap({f"i{i}": i for i in range(ANN_ITEMS)})),
                     seen_by_user=seen)
    log(f"[ann] {ANN_ITEMS} items x rank {ANN_RANK} ({ANN_CLUSTERS} clusters), {ANN_USERS} "
        f"users x {ANN_SEEN} seen: made in {time.perf_counter() - t0:.2f}s")
    real_build, build_s = ann_ops.build_index, []

    def timed_build(*args, **kwargs):
        t = time.perf_counter()
        out = real_build(*args, **kwargs)
        build_s.append(time.perf_counter() - t)
        return out

    model_dir = tempfile.mkdtemp(prefix="ann-")
    try:
        ann_ops.build_index = timed_build
        t = time.perf_counter()
        model.save(model_dir)
        save_s = time.perf_counter() - t
        ann_ops.build_index = real_build
        with open(os.path.join(model_dir, "model.json")) as f:
            meta = json.load(f)
        if len(build_s) != 1 or meta.get("ann", {}).get("nlist") != ann_ops.auto_nlist(
                ANN_ITEMS):
            fail(f"[ann] save built {len(build_s)} indexes, model.json ann={meta.get('ann')}")
        index = model.ann_index
        log(f"[ann] ALSModel.save built the IVF index at persist time: build_s={build_s[0]:.2f} "
            f"(host NumPy k-means, nlist={index.nlist}, max cell {index.max_cell}, mean "
            f"{ANN_ITEMS / index.nlist:.1f}); save_s={save_s:.2f} in all")
        t = time.perf_counter()
        loaded = ALSModel.load(model_dir, device=DEVICE)
        loaded.configure_retrieval("ann")
        load_s = time.perf_counter() - t
    finally:
        ann_ops.build_index = real_build
        shutil.rmtree(model_dir, ignore_errors=True)
    for name, arr in index.to_arrays().items():
        if not np.array_equal(loaded.ann_index.to_arrays()[name], arr):
            fail(f"[ann] the loaded index's {name} differs from the saved one")
    if not loaded.ann_enabled or loaded.device.type != torch.device(DEVICE).type:
        fail("[ann] the loaded model does not serve through its index on the card")
    log(f"[ann] ALSModel.load on the card + configure_retrieval('ann'): {load_s:.2f}s; the "
        f"index arrays equal the saved ones")
    return loaded


def _ann_inputs(model: ALSModel, b: int):
    """(user vectors, seen cols, seen mask) of the first ``b`` users."""
    cols = np.zeros((b, ANN_SEEN), dtype=np.int64)
    mask = np.zeros((b, ANN_SEEN), dtype=np.float32)
    for u in range(b):
        s = model.seen_by_user[u]
        cols[u, : len(s)] = s
        mask[u, : len(s)] = 1.0
    return (model.user_factors[:b], torch.from_numpy(cols).to(DEVICE),
            torch.from_numpy(mask).to(DEVICE))


def _fullest_profile(fn, top: str | None = None) -> tuple[float | None, int]:
    """Of three traces of ``fn``, the one that kept the most launches:
    late in a long run the profiler has kept only part of a trace (§7 of
    PERF.md), and a trace never holds more launches than ran."""
    return max((_profile(fn, top=top if i == 0 else None) for i in range(3)),
               key=lambda r: (r[1], r[0] or 0.0))


def phase_ann_exact(model: ALSModel) -> None:
    """22b: full probe against brute force, the auto probe against a
    float64 rescore of its shortlist, and recall/MAP@10 at three probe
    counts."""
    index, itf = model.ann_index, model.item_factors
    arrays = index.device_arrays(model.device)
    nprobe = index.clamp_nprobe(0)
    allow = model._allow_or_default(None)
    uv, cols, mask = _ann_inputs(model, ANN_CHECK_QUERIES)
    # a full probe's shortlist is the whole catalog: one query at a time
    differ, worst = [], 0.0
    for r in range(ANN_CHECK_QUERIES):
        one = (uv[r:r + 1], cols[r:r + 1], mask[r:r + 1])
        av, ai = ann_ops.ann_topk(one[0], itf, *arrays, one[1], one[2], allow, 10,
                                  index.nlist)
        bv, bi = topk_ops.recommend_topk(one[0], itf, one[1], one[2], allow, 10)
        if not torch.equal(ai, bi):
            differ.append(r)
        worst = max(worst, float((av - bv).abs().max()))
    if differ:
        fail(f"[ann] full probe (nprobe={index.nlist}) differs from brute force for queries "
             f"{differ[:8]}")
    log(f"[ann] nprobe=nlist={index.nlist}: {ANN_CHECK_QUERIES} answers equal brute force, "
        f"ids and order; max |value diff| {worst:.3g}")
    cand, pad, _ = ann_ops._shortlist(uv, *arrays, nprobe, 0)
    av, ai = ann_ops.ann_topk(uv, itf, *arrays, cols, mask, allow, 10, nprobe)
    cand_h, pad_h = cand.long().cpu().numpy(), pad.cpu().numpy()
    av_h, ai_h = av.cpu().numpy(), ai.cpu().numpy()
    item64 = itf.double().cpu().numpy()
    u64 = uv.double().cpu().numpy()
    worst_ratio = 0.0
    for r in range(ANN_CHECK_QUERIES):
        vecs = item64[cand_h[r]]
        s64 = vecs @ u64[r]
        s64[pad_h[r] == 0] = -np.inf
        s64[np.isin(cand_h[r], model.seen_by_user[r])] = -np.inf
        order = np.lexsort((np.arange(len(s64)), -s64))[:10]
        if not np.array_equal(ai_h[r], cand_h[r][order]):
            fail(f"[ann] query {r} at nprobe={nprobe}: ids {ai_h[r].tolist()} differ from the "
                 f"float64 rescore of its shortlist {cand_h[r][order].tolist()}")
        scale = np.abs(vecs[order]) @ np.abs(u64[r])
        worst_ratio = max(worst_ratio, float((np.abs(av_h[r] - s64[order]) / scale).max()))
    if worst_ratio > ANN_RESCORE_RTOL:
        fail(f"[ann] rescore error {worst_ratio:.3g} x sum|u v| over {ANN_RESCORE_RTOL:g}")
    log(f"[ann] nprobe={nprobe} (auto), shortlist width {index.shortlist_width(nprobe)}: "
        f"{ANN_CHECK_QUERIES} answers equal a float64 rescore of their shortlists, ids and "
        f"order; max |err| / sum|u v| = {worst_ratio:.3g} (tol {ANN_RESCORE_RTOL:g})")
    for p in (nprobe, 2 * nprobe, 4 * nprobe):
        q = ann_ops.quality_vs_brute(index, uv, itf, k=10, nprobe=p)
        log(f"[ann] quality nprobe={p}: recall_at_shortlist={q['recall_at_shortlist']:.4f} "
            f"map_at_10={q['map_at_k']:.4f} width={q['shortlist_width']} "
            f"queries={q['queries']}")


def phase_ann_times(model: ALSModel) -> None:
    """22c: ann_topk's CUDA-event and profiled device time and launches at
    B = 1 and 32 beside brute recommend_topk (with the tie rule), the
    probe's bytes bound, and at B = 32 the row-at-a-time loop (the JAX
    package's lax.map order) beside the vectorized batch."""
    index, itf = model.ann_index, model.item_factors
    arrays = index.device_arrays(model.device)
    nprobe = index.clamp_nprobe(0)
    width = index.shortlist_width(nprobe)
    allow = model._allow_or_default(None)
    rows = []
    for b in ANN_BATCHES:
        uv, cols, mask = _ann_inputs(model, b)

        def ann_fn():
            return ann_ops.ann_topk(uv, itf, *arrays, cols, mask, allow, 10, nprobe)

        def brute_fn():
            return topk_ops.recommend_topk(uv, itf, cols, mask, allow, 10)

        ann_ms, brute_ms = time_ms(ann_fn, n=50), time_ms(brute_fn, n=50)
        ann_dev, ann_launches = _fullest_profile(ann_fn, top=f"ann B={b}")
        brute_dev, brute_launches = _fullest_profile(brute_fn)
        # each probed candidate's vector and id read once, the centroids once
        probe_bytes = b * width * (ANN_RANK * 4 + 4) + index.nlist * ANN_RANK * 4
        brute_bytes = ANN_ITEMS * ANN_RANK * 4
        row = dict(b=b, width=width, ann_ms=ann_ms, ann_device_ms=ann_dev,
                   ann_launches=ann_launches, bound_ms=probe_bytes / PEAK_BYTES * 1e3,
                   brute_ms=brute_ms, brute_device_ms=brute_dev,
                   brute_launches=brute_launches, brute_bound_ms=brute_bytes / PEAK_BYTES * 1e3)
        if b > 1:
            def loop():
                for i in range(b):
                    ann_ops.ann_topk(uv[i:i + 1], itf, *arrays, cols[i:i + 1],
                                     mask[i:i + 1], allow, 10, nprobe)
            row["row_loop_ms"] = time_ms(loop, warmup=3, n=10)
        rows.append(row)
        log(f"[ann] B={b}: ann_topk ms={ann_ms:.4f} device_ms={_fmt(ann_dev, 4)} "
            f"launches={ann_launches} bound_ms={row['bound_ms']:.4f} (bytes: width {width} x "
            f"(K x 4 + 4) + centroids); brute recommend_topk ms={brute_ms:.4f} "
            f"device_ms={_fmt(brute_dev, 4)} launches={brute_launches} "
            f"bound_ms={row['brute_bound_ms']:.4f}"
            + (f"; row-at-a-time loop ms={row['row_loop_ms']:.4f}" if b > 1 else ""))
    log("[ann] " + json.dumps({"ann_topk": rows}))


def phase_ann_http(als_model: ALSModel) -> None:
    """22d: the ML-20M-shape model of phase 17 behind the engine server
    with retrieval=ann: annShortlistHistogram counts its queries, POST
    /retrieval switches to brute and back, and at full probe the answers
    equal brute force."""
    users = sorted(als_model.seen_by_user)[:ANN_HTTP_USERS]
    bodies = [{"user": f"u{u}", "num": 10} for u in users]
    model_dir = tempfile.mkdtemp(prefix="ann-http-")
    server = None
    try:
        storage = memory_storage()
        instance_id = _store_als_instance(storage, als_model, model_dir)
        server = create_engine_server(storage, _local(
            engine_instance_id=instance_id, retrieval="ann", server_key=SERVER_KEY,
            cache_enabled=True)).start()
        port, key = server.port, f"?accessKey={SERVER_KEY}"
        index = server.deployed.models[0].ann_index
        nprobe = index.clamp_nprobe(0)

        def one_round(tag: str) -> list:
            answers = []
            for body in bodies:
                status, doc, _ = _post(port, body)
                if status != 200:
                    fail(f"[ann-http] {tag} {body} answered {status}: {doc}")
                answers.append(_as_result(doc))
            return answers

        def switch(doc: dict, enabled: bool) -> None:
            status, out, _ = _http(port, "POST", f"/retrieval{key}", doc)
            if status != 200 or out.get("annEnabled") is not enabled:
                fail(f"[ann-http] POST /retrieval {doc}: {status} {out}")

        auto = one_round("ann")
        stats = _get(port, "/stats.json")[1]
        hist = stats["serving"]["annShortlistHistogram"]
        if not stats["annEnabled"] or hist != {str(index.shortlist_width(nprobe)): len(bodies)}:
            fail(f"[ann-http] annEnabled={stats['annEnabled']} annShortlistHistogram={hist}")
        switch({"retrieval": "brute"}, False)
        brute = one_round("brute")
        switch({"retrieval": "ann", "annNprobe": index.nlist}, True)
        full = one_round("full probe")
        differ = [b for b, x, y in zip(bodies, full, brute) if not _same_answer(x, y)]
        if differ:
            fail(f"[ann-http] full-probe answers differ from brute force for {differ[:3]}")
        switch({"retrieval": "ann", "annNprobe": 0}, True)
        stats = _get(port, "/stats.json")[1]["serving"]
        want = {}
        for p in (nprobe, index.nlist):
            width = str(index.shortlist_width(p))
            want[width] = want.get(width, 0) + len(bodies)
        if stats["annShortlistHistogram"] != want or stats["annQueries"] != 2 * len(bodies):
            fail(f"[ann-http] annShortlistHistogram {stats['annShortlistHistogram']} after "
                 f"an auto and a full-probe round (want {want})")
        agree = sum(_same_answer(x, y) for x, y in zip(auto, brute))
        served = server.deployed.models[0]
        uv = served.user_factors[torch.as_tensor(users, device=served.device)]
        for p in (nprobe, 4 * nprobe):
            q = ann_ops.quality_vs_brute(index, uv, served.item_factors, k=10, nprobe=p)
            log(f"[ann-http] quality nprobe={p}: recall_at_shortlist="
                f"{q['recall_at_shortlist']:.4f} map_at_10={q['map_at_k']:.4f} "
                f"width={q['shortlist_width']} queries={q['queries']}")
        log(f"[ann-http] {len(index.flat_items)} items, nlist={index.nlist}: POST /retrieval "
            f"ann -> brute -> ann (nprobe {index.nlist}) -> ann (auto); annShortlistHistogram "
            f"{stats['annShortlistHistogram']}; full-probe answers equal brute force for all "
            f"{len(bodies)} users; auto-probe answers equal brute for {agree}/{len(bodies)}")
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(model_dir, ignore_errors=True)


def phase_ann(als_model: ALSModel) -> None:
    """Phase 22; launches no flash kernel."""
    before = flash_ops.LAUNCHES
    t0 = time.perf_counter()
    model = _ann_model()
    phase_ann_exact(model)
    phase_ann_times(model)
    del model
    torch.cuda.empty_cache()
    phase_ann_http(als_model)
    if flash_ops.LAUNCHES != before:
        fail(f"the ANN phase launched the flash kernel {flash_ops.LAUNCHES - before} times")
    log(f"[ann] phase 22 took {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 23: the online freshness plane
# ---------------------------------------------------------------------------

#: known users whose rating is folded (8, cut from 32 to 16 to make room
#: for phase 28 and to 8 for phase 29: each waits for its changed answer
#: in turn), users whose cache
#: entries must survive, the tail interval, the longest a fold may take
#: to reach an answer
ONLINE_USERS, ONLINE_BYSTANDERS, ONLINE_INTERVAL_S, ONLINE_WAIT_S = 8, 32, 0.2, 15.0
#: a folded vector against the float64 solve of the same normal
#: equations: max |diff| / max(1, max |ref|)
ONLINE_VEC_TOL = 1e-4


def _query_items(port: int, user: str, num: int = 10) -> list[str]:
    status, doc, _ = _post(port, {"user": user, "num": num})
    if status != 200:
        fail(f"[online] query of {user} answered {status}: {doc}")
    return [s["item"] for s in doc["itemScores"]]


def _until(port: int, user: str, done, num: int = 10) -> tuple[list[str], float]:
    """Query ``user`` until ``done(items)``: (items, seconds)."""
    t0 = time.perf_counter()
    while True:
        items = _query_items(port, user, num)
        if done(items):
            return items, time.perf_counter() - t0
        if time.perf_counter() - t0 > ONLINE_WAIT_S:
            fail(f"[online] {user}'s answer did not change within {ONLINE_WAIT_S}s")
        time.sleep(0.01)


def _history(storage, app_id: int, user: str) -> list:
    from predictionio_tpu_torch.storage.base import EventFilter

    return list(storage.get_events().find(app_id, None, EventFilter(
        entity_type="user", entity_id=user, event_names=["rate", "buy"])))


def _f64_fold(storage, app_id: int, model: ALSModel, user: str, lam: float) -> np.ndarray:
    """The user's ALS-WR normal equations over the full history in the
    store (rate: its rating; buy: 4.0), solved in float64."""
    ixs, ratings = [], []
    for e in _history(storage, app_id, user):
        ix = model.item_ids.get(e.target_entity_id)
        if ix is None:
            continue
        ixs.append(ix)
        ratings.append(float(e.properties.fields["rating"]) if e.event == "rate" else 4.0)
    Y = model.item_factors.double().cpu().numpy()[np.asarray(ixs)]
    A = Y.T @ Y + lam * len(ixs) * np.eye(Y.shape[1])
    return np.linalg.solve(A, np.asarray(ratings) @ Y)


def phase_online(pio: _Pio, rec_instance: tuple[str, str]) -> None:
    """Phase 23: phase 16b's instance behind `pio deploy --online
    --online-interval-s 0.2 --cache` (entries live 600 s, so that only an
    invalidation ends one), `pio eventserver` on the same sqlite store."""
    from predictionio_tpu_torch.online.follower import TailCursor
    from predictionio_tpu_torch.online.service import OnlineFoldIn

    before_launches = flash_ops.LAUNCHES
    t0 = time.perf_counter()
    engine_json, instance_id = rec_instance
    out, _ = pio.run("online", "accesskey", "new", "ML100k")
    key = re.search(r"Created new access key: (\S+)", out).group(1)
    es_proc, es_port, _ = pio.eventserver("online")
    proc, port, _ = pio.deploy("online", engine_json, "--online", "--online-interval-s",
                               str(ONLINE_INTERVAL_S), "--cache", "--cache-ttl-s", "600")
    storage = Storage({"PIO_FS_BASEDIR": pio.env["PIO_FS_BASEDIR"]})
    twin = None
    try:
        # the same fold in this process, on the card: vectors to check
        deployed = load_deployed_engine(storage, ServerConfig(engine_instance_id=instance_id,
                                                              device=DEVICE))
        model = deployed.models[0]
        app_id = storage.get_meta_data_apps().get_by_name("ML100k").id
        twin = OnlineFoldIn(storage=storage, deployed_fn=lambda: deployed,
                            generation_fn=lambda: 0, interval_s=3600,
                            initial_cursor=TailCursor(int(time.time() * 1_000_000), ""))
        twin.start()
        if not twin.enabled:
            fail("[online] the in-process fold-in did not bind to the ML-100k deployment")
        folded = [f"u{u}" for u in range(ONLINE_USERS)]
        bystanders = [f"u{u}" for u in range(100, 100 + ONLINE_BYSTANDERS)]
        before = {u: _query_items(port, u) for u in folded + bystanders}

        def post(user: str, item: str, rating: float = 5.0) -> None:
            status, doc, _ = _http(es_port, "POST", f"/events.json?accessKey={key}", {
                "event": "rate", "entityType": "user", "entityId": user,
                "targetEntityType": "item", "targetEntityId": item,
                "properties": {"rating": rating}})
            if status != 201:
                fail(f"[online] POST /events.json answered {status}: {doc}")

        lags = []
        for u in folded:
            target = before[u][0]
            post(u, target)
            after, lag = _until(port, u, lambda items, b=before[u]: items != b)
            if target in after:
                fail(f"[online] {u} rated {target}, and it is still served to {u}")
            lags.append(lag)
        log(f"[online] {len(folded)} known users each rated their first answer: seconds from "
            f"the 201 to a changed answer p50={statistics.median(lags):.3f} "
            f"max={max(lags):.3f} (tail interval {ONLINE_INTERVAL_S}s, no retrain)")
        for item in ("i0", "i1", "i2"):
            post("newbie", item)
        for u in range(200, 204):
            post(f"u{u}", "fresh-item")
        posted = time.perf_counter()
        newbie, lag_new = _until(port, "newbie", bool)
        # a new item invalidates no one's cache entries: query u300 (not
        # queried before) once the overlay holds the item
        while _get(port, "/stats.json")[1]["online"]["overlayItems"] < 1:
            if time.perf_counter() - posted > ONLINE_WAIT_S:
                fail(f"[online] fresh-item was not folded within {ONLINE_WAIT_S}s")
            time.sleep(0.01)
        if "fresh-item" not in _query_items(port, "u300", num=2000):
            fail("[online] the new item is not served to u300")
        lag_item = time.perf_counter() - posted
        log(f"[online] cold start: the new user served {newbie[:3]}... after {lag_new:.3f}s; "
            f"the new item fresh-item served to u300 {lag_item:.3f}s after its last 201")
        c0 = _get(port, "/stats.json")[1]["serving"]
        again = {u: _query_items(port, u) for u in bystanders}
        c1 = _get(port, "/stats.json")[1]
        hits = c1["serving"]["cacheHits"] - c0["cacheHits"]
        misses = c1["serving"]["cacheMisses"] - c0["cacheMisses"]
        if (hits, misses) != (len(bystanders), 0) or again != {u: before[u]
                                                                for u in bystanders}:
            fail(f"[online] bystanders after the folds: {hits} hits, {misses} misses")
        if c1["serving"]["cacheUserInvalidations"] < len(folded):
            fail(f"[online] cacheUserInvalidations={c1['serving']['cacheUserInvalidations']}")
        section = {k: c1["online"][k] for k in ("generation", "overlayUsers", "overlayItems",
                                                "foldedEventsTotal", "foldCycles",
                                                "lagSeconds")}
        log(f"[online] {len(bystanders)} users who posted nothing: {hits} cache hits, "
            f"{misses} misses after the folds (hit ratio {c1['serving']['cacheHitRatio']}, "
            f"cacheUserInvalidations {c1['serving']['cacheUserInvalidations']}); online "
            f"section {json.dumps(section)}")
        # the twin folds the same events: its vectors against float64, its
        # answers against the deploy process's
        t = time.perf_counter()
        n_events = twin.tick()
        fold_s = time.perf_counter() - t
        users_folded = twin.metrics()["usersFoldedTotal"]
        lam = twin._binding.lam
        worst = 0.0
        for u in folded + ["newbie"]:
            ref = _f64_fold(storage, app_id, model, u, lam)
            got = twin.overlay.user(u).vector
            worst = max(worst, float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max())))
            # fresh-item's vector is solved from the raters of the cycle
            # that tailed them, which may differ between the two folds:
            # compare the catalog items, one slot short
            served = [i for i in _query_items(port, u) if i != "fresh-item"][:9]
            mine = [i for i, _ in model.recommend(u, 10) if i != "fresh-item"][:9]
            if served != mine:
                fail(f"[online] {u}: the deploy process serves {served}, the same fold in "
                     f"this process {mine}")
        if worst > ONLINE_VEC_TOL:
            fail(f"[online] a folded vector is {worst:.3g} from its float64 solve")
        log(f"[online] in-process fold of the same {n_events} events: {users_folded} users in "
            f"{fold_s * 1e3:.2f} ms ({fold_s * 1e3 / max(1, users_folded):.3f} ms per user); "
            f"every folded vector within {worst:.3g} (tol {ONLINE_VEC_TOL:g}) of the float64 "
            f"solve over the user's history in the store; answers equal the deploy process's")
        ixs = [i for i in (model.item_ids.get(e.target_entity_id)
                           for e in _history(storage, app_id, "u0")) if i is not None]
        gather_ms = time_ms(lambda: twin._gather_rows(model.item_factors, ixs), n=50)
        gather_dev, gather_launches = _fullest_profile(
            lambda: twin._gather_rows(model.item_factors, ixs))
        log(f"[online] _gather_rows of {len(ixs)} rows x rank {model.rank}: ms={gather_ms:.4f} "
            f"(index_select + copy to the host) device_ms={_fmt(gather_dev, 4)} "
            f"launches={gather_launches}")
        # /reload: the generation moves, the overlay refolds
        status, doc, _ = _http(port, "GET", "/reload")
        online = _get(port, "/stats.json")[1]["online"]
        if status != 200 or online["generation"] != 1:
            fail(f"[online] /reload {status} {doc}; online generation {online['generation']}")
        for u in folded[:4]:
            _until(port, u, lambda items, t=before[u][0]: t not in items)
        stale = twin.overlay.user(folded[0])
        twin.on_model_swapped(1)
        if twin.overlay.put_user(folded[0], stale, generation=0) or \
                twin.metrics()["fenced"] != 1:
            fail("[online] a delta computed against generation 0 was applied after a reload")
        log(f"[online] /reload: overlay generation 0 -> {online['generation']}, the folded "
            f"users' answers still hide what they rated (refolded); a generation-0 delta "
            f"offered after the swap is discarded (fenced={twin.metrics()['fenced']})")
    finally:
        if twin is not None:
            twin.close()
        storage.close()
        _stop(proc)
        _stop(es_proc)
    if flash_ops.LAUNCHES != before_launches:
        fail("the online phase launched the flash kernel")
    log(f"[online] phase 23 took {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# Phase 24: the parallel evaluation grid through `pio eval`
# ---------------------------------------------------------------------------

#: the JSON-lines file a grid process appends one row to per fold it
#: predicts (the environment variable is set by phase 24 only)
GRID_LOG_ENV = "PIO_SMOKE_GRID_LOG"
#: HitRate@10 of one grid point counts 2 folds × 64 held-out users: one
#: user's hit moves it by 1/128, the floor of the tolerance between the
#: forked and the serial grid (the spread of two serial runs, when wider).
#: The mean top-1 score (a secondary metric that moves with every weight,
#: where one epoch at vocab 50,000 leaves HitRate@10 at 0) is held to the
#: spread of two serial runs, floored at GRID_TOP_TOL (absolute, on
#: scores of order 1-10 summed in f32 over bf16 hidden states)
GRID_USER_STEP = 1 / (2 * 64)
GRID_TOP_TOL = 1e-3
GRID_SPEC = "chip_smoke.GridEvaluation"


class _LoggedSeqRec(sessionrec.SeqRecAlgorithm):
    """The template's algorithm; each ``batch_predict`` (one fold of a
    grid point) appends the process id, its flash launches, its device,
    and whether the kernel library was built before and left unchanged
    (a process that rebuilt it would have replaced the file) to the file
    named by ``PIO_SMOKE_GRID_LOG``."""

    def batch_predict(self, model, queries):
        lib = _build.library_path("flash_attention")
        mtime = lib.stat().st_mtime_ns if lib.exists() else None
        before = flash_ops.LAUNCHES
        out = super().batch_predict(model, queries)
        path = os.environ.get(GRID_LOG_ENV)
        if path:
            with open(path, "a") as f:
                f.write(json.dumps({
                    "pid": os.getpid(), "queries": len(queries),
                    "launches": flash_ops.LAUNCHES - before, "device": str(model.device),
                    "lib_built_before": mtime is not None,
                    "lib_rebuilt": (lib.stat().st_mtime_ns if lib.exists() else None) != mtime,
                }) + "\n")
        return out


class MeanTopScore(AverageMetric):
    """The mean of each held-out query's top-1 score."""

    def calculate_qpa(self, q, p, a) -> float:
        return p.item_scores[0].score if p.item_scores else 0.0


class GridEvaluation(Evaluation):
    """Phase 14's HitRate@10 evaluation of sessionrec, with the mean top-1
    score beside it, as a `pio eval` spec (no best.json)."""

    def __init__(self):
        super().__init__()
        engine = sessionrec.engine_factory()
        engine.algorithm_class_map = {"seqrec": _LoggedSeqRec}
        self.engine_evaluator = (engine, MetricEvaluator(sessionrec.HitRateAtK(k=EVAL_TOPK),
                                                         [MeanTopScore()]))


def _grid_point(lr: float, **changes) -> EngineParams:
    return EngineParams.of(
        data_source=sessionrec.DataSourceParams(app_name="SessApp", eval_k=EVAL_K),
        algorithms=[("seqrec", sessionrec.AlgorithmParams(**{**EVAL_POINT, "lr": lr,
                                                            **changes}))])


class GridParams(EngineParamsGenerator):
    """Phase 14's two grid points, over 16a's app."""

    def __init__(self):
        super().__init__([_grid_point(lr) for lr in EVAL_LRS])


class PoisonedGridParams(EngineParamsGenerator):
    """The first point, and one with 3 heads, which do not divide
    d_model 256: its eval worker raises."""

    def __init__(self):
        super().__init__([_grid_point(EVAL_LRS[0]), _grid_point(EVAL_LRS[1], n_heads=3)])


def _fake_on_card(ctx) -> None:
    if ctx.device.type != "cuda":
        raise AssertionError(f"FakeRun got device {ctx.device}, not the card")
    total = float(torch.arange(1024, dtype=torch.float32, device=ctx.device).sum())
    print(f"[INFO] FakeRun on {torch.cuda.get_device_name(ctx.device)}: sum {total}")


class SmokeFakeRun(FakeRun):
    """A FakeRun whose function must see the card."""

    def __init__(self):
        super().__init__(_fake_on_card)


def _pio_eval(pio: _Pio, tag: str, evaluation: str, generator: str, *flags: str) -> dict:
    """`pio eval` as a process over ``pio``'s store, polling its
    evaluation row every 20 ms while it runs. Returns its exit code,
    output, seconds, pid, the (status, points landed) pairs the row went
    through, its final row and the grid log's rows."""
    log_path = os.path.join(pio.base, f"grid-{tag}.jsonl")
    out_path = os.path.join(pio.base, f"eval-{tag}.log")
    env = dict(pio.env, **{GRID_LOG_ENV: log_path})
    storage = Storage({"PIO_FS_BASEDIR": pio.env["PIO_FS_BASEDIR"]})
    instances = storage.get_meta_data_evaluation_instances()
    known = {i.id for i in instances.get_all()}
    seen: list[tuple[str, int | None]] = []
    t0 = time.perf_counter()
    with open(out_path, "w") as out:
        proc = subprocess.Popen(pio.cmd + ["eval", evaluation, generator, "--device", DEVICE,
                                           *flags],
                                cwd=pio.base, env=env, stdout=out, stderr=subprocess.STDOUT)
    row = None
    try:
        while True:
            done = proc.poll() is not None
            rows = [i for i in instances.get_all() if i.id not in known]
            if rows:
                row = rows[0]
                landed = (json.loads(row.evaluator_results_json).get("gridDone")
                          if row.status == "EVALUATING" else None)
                if not seen or seen[-1] != (row.status, landed):
                    seen.append((row.status, landed))
            if done:
                break
            if time.perf_counter() - t0 > PIO_STEP_TIMEOUT:
                fail(f"[{tag}] pio eval ran past {PIO_STEP_TIMEOUT}s")
            time.sleep(0.02)
    finally:
        if proc.poll() is None:
            _stop(proc)
        storage.close()
    seconds = time.perf_counter() - t0
    with open(out_path) as f:
        output = f.read()
    grid_rows = []
    if os.path.exists(log_path):
        with open(log_path) as f:
            grid_rows = [json.loads(line) for line in f]
    log(f"[{tag}] pio eval {generator.rsplit('.', 1)[-1]} {' '.join(flags)}: exit "
        f"{proc.returncode} in {seconds:.3f}s; rows seen {seen}")
    return dict(rc=proc.returncode, output=output, seconds=seconds, pid=proc.pid, seen=seen,
                row=row, grid_rows=grid_rows)


def _grid_scores(tag: str, run: dict) -> tuple[int, list, list]:
    """(best index, scores, mean top-1 scores) of a completed grid's
    evaluation row; the point docs and exit codes are logged."""
    if run["rc"] != 0 or run["row"] is None or run["row"].status != "EVALCOMPLETED":
        fail(f"[{tag}] pio eval exited {run['rc']}, row "
             f"{run['row'] and run['row'].status}:\n{run['output'][-3000:]}")
    doc = json.loads(run["row"].evaluator_results_json)
    scores = [p["score"] for p in doc["engineParamsScores"]]
    tops = [p["otherScores"][0] for p in doc["engineParamsScores"]]
    for p in doc.get("points", []):
        log(f"[{tag}]   point {p['idx']}: {p['status']} score={p['score']} "
            f"in {p['durationS']}s (child exit "
            f"{0 if p['status'] == 'COMPLETED' else p.get('error')})")
    log(f"[{tag}] best point {doc['bestIdx']}, HitRate@{EVAL_TOPK} {scores}, mean top-1 "
        f"score {tops}")
    return doc["bestIdx"], scores, tops


def _check_fold_rows(tag: str, rows: list, pids: set) -> int:
    """Every fold predicted on the card in ``pids``, with 4 launches per
    layer bucket and the kernel library loaded as built; returns the
    launches."""
    per_layer = EVAL_POINT["n_layers"]
    for r in rows:
        want = per_layer * _buckets(r["queries"])
        if (r["pid"] not in pids or not r["device"].startswith("cuda")
                or r["launches"] != want or not r["lib_built_before"] or r["lib_rebuilt"]):
            fail(f"[{tag}] fold row {r}: expected pid in {pids}, cuda, {want} launches, the "
                 "library built before and not rebuilt")
    launches = sum(r["launches"] for r in rows)
    log(f"[{tag}] {len(rows)} folds in {len({r['pid'] for r in rows})} process(es) "
        f"{sorted({r['pid'] for r in rows})}: flash launches {[r['launches'] for r in rows]} "
        f"= {launches}; kernel library rebuilt by none")
    return launches


def phase_grid(pio: _Pio, phase14: tuple[int, list, list] | None) -> int:
    """Phase 24: phase 14's grid through `pio eval --parallel 2` over 16a's
    store (SessApp imported), then serially, then poisoned, then a
    FakeRun. Returns the flash launches of every grid process."""
    t0 = time.perf_counter()
    gen = "chip_smoke.GridParams"
    forked = _pio_eval(pio, "grid-par", GRID_SPEC, gen, "--parallel", "2")
    best_par, par_scores, par_tops = _grid_scores("grid-par", forked)
    GRID_INSTANCE[:] = [forked["row"].id]
    children = {r["pid"] for r in forked["grid_rows"]}
    if len(children) != 2 or forked["pid"] in children or len(forked["grid_rows"]) != 2 * EVAL_K:
        fail(f"[grid-par] expected {2 * EVAL_K} folds in 2 forked workers, got "
             f"{forked['grid_rows']} (pio eval pid {forked['pid']})")
    launches = _check_fold_rows("grid-par", forked["grid_rows"], children)
    log(f"[grid-par] EVALUATING seen mid-run: "
        f"{any(s == 'EVALUATING' for s, _ in forked['seen'])}")

    serial_runs = [_pio_eval(pio, f"grid-ser{j}", GRID_SPEC, gen, "--parallel", "1")
                   for j in range(1 if phase14 is not None else 2)]
    serial = []
    for j, run in enumerate(serial_runs):
        serial.append(_grid_scores(f"grid-ser{j}", run))
        launches += _check_fold_rows(f"grid-ser{j}", run["grid_rows"], {run["pid"]})
        if any(s == "EVALUATING" for s, _ in run["seen"]):
            fail(f"[grid-ser{j}] a serial grid wrote an EVALUATING row")
    if phase14 is not None:
        serial.insert(0, phase14)
    first = "phase 14 in process" if phase14 is not None else "`pio eval --parallel 1`"
    serial_s = ", ".join(f"{r['seconds']:.3f}s" for r in serial_runs)
    log(f"[grid] wall: forked {forked['seconds']:.3f}s, serial {serial_s}; serial runs: "
        f"{first} and `pio eval --parallel 1`")
    for name, k, got, floor in (("HitRate", 1, par_scores, GRID_USER_STEP),
                                ("mean top-1 score", 2, par_tops, GRID_TOP_TOL)):
        spread = max(abs(a - b) for a, b in zip(serial[0][k], serial[1][k]))
        tol = max(spread, floor)
        worst = max(abs(a - b) for a, b in zip(got, serial[-1][k]))
        log(f"[grid] {name}: forked {got} against serial {serial[-1][k]}: max diff "
            f"{worst:.6g}; tolerance {tol:.6g} = max(spread of the two serial runs "
            f"{spread:.6g}, floor {floor:.6g})")
        if worst > tol:
            fail(f"[grid] the forked grid's {name} differs from the serial one's by {worst} "
                 f"> {tol}")
    if best_par != serial[-1][0] and max(abs(a - b) for a, b in zip(par_scores,
                                                                     serial[-1][1])) > 0:
        fail(f"[grid] the forked grid's best point {best_par} is not the serial one's "
             f"{serial[-1][0]}")

    poisoned = _pio_eval(pio, "grid-poison", GRID_SPEC, "chip_smoke.PoisonedGridParams",
                         "--parallel", "2")
    doc = json.loads(poisoned["row"].evaluator_results_json) if poisoned["row"] else {}
    statuses = [p["status"] for p in doc.get("points", [])]
    if (poisoned["rc"] != 0 or poisoned["row"].status != "EVALCOMPLETED"
            or statuses != ["COMPLETED", "FAILED"] or doc.get("bestIdx") != 0
            or "exited with code 1" not in doc["points"][1].get("error", "")):
        fail(f"[grid-poison] expected one COMPLETED and one FAILED point: rc "
             f"{poisoned['rc']}, {doc}\n{poisoned['output'][-3000:]}")
    if ("EVALUATING", 1) not in poisoned["seen"]:
        fail(f"[grid-poison] no EVALUATING row with one point landed: {poisoned['seen']}")
    log(f"[grid-poison] point 1 FAILED: {doc['points'][1]['error'][:300]}")
    launches += _check_fold_rows("grid-poison", poisoned["grid_rows"],
                                 {r["pid"] for r in poisoned["grid_rows"]})
    log(f"[grid-poison] the EVALUATING row held 1 of 2 points mid-run; point 0 score "
        f"{doc['points'][0]['score']}")

    fake_run = _pio_eval(pio, "grid-fake", "chip_smoke.SmokeFakeRun",
                         "predictionio_tpu_torch.workflow.fake.FakeEngineParamsGenerator",
                         "--parallel", "2")
    if (fake_run["rc"] != 0 or "[INFO] FakeRun completed" not in fake_run["output"]
            or "[INFO] FakeRun on " not in fake_run["output"]
            or fake_run["row"] is None or fake_run["row"].status != "INIT"):
        fail(f"[grid-fake] rc {fake_run['rc']}:\n{fake_run['output'][-3000:]}")
    log(f"[grid-fake] "
        f"{[l for l in fake_run['output'].splitlines() if 'FakeRun on' in l][0]}; row INIT")
    log(f"[grid] phase 24 took {time.perf_counter() - t0:.1f}s; flash launches in the grid "
        f"processes: {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 25: the e2 library and the quality-parity harness
# ---------------------------------------------------------------------------

#: the JAX package's quality point (bench.py:1115-1121) and the tolerances
#: of tests/test_quality_parity.py: held-out RMSE within 0.05 of the NumPy
#: reference estimator's, MAP@10 inside the reference's seed band widened
#: by its width
QUALITY_POINT = dict(rank=10, iterations=10, lam=0.05, k_fold=5)
QUALITY_RMSE_TOL = 0.05
QUALITY_SEEDS = (11, 12, 13)
SAMPLE_RATINGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "data",
                              "sample_movielens.txt")
#: the Markov build: ML-20M's item count and the template's top 10;
#: probabilities against float64 (an f32 quotient of integer counts)
MARKOV_TOP, MARKOV_PROB_TOL = 10, 1e-6
#: the ratings the Markov transitions come from: the first 2.5M of phase
#: 9's (cut from all 20M to 10M to make room for phase 27, whose host
#: list and float64 reference took ~18 s of the script, then to 2.5M for
#: phase 28); the states stay 26,744
MARKOV_RATINGS = 2_500_000


def phase_quality() -> None:
    """Phase 25a-b: compare_quality at the ML-100k reconstruction with the
    ALS on the card, and the implicit path against popularity on the
    sample ratings file."""
    t0 = time.perf_counter()
    ds = movielens.synthesize_ml100k()
    got = quality.compare_quality(ds, **QUALITY_POINT)
    took = time.perf_counter() - t0
    train, test = quality.kfold_split(ds, k_fold=QUALITY_POINT["k_fold"])
    maps = []
    for seed in QUALITY_SEEDS:
        U, V = quality.numpy_als_wr(train, rank=10, iterations=10, lam=0.05, seed=seed)
        maps.append(quality.ranking_eval(quality.factor_score_fn(U, V), train, test)["map@10"])
    lo, hi = min(maps), max(maps)
    width = max(hi - lo, 1e-4)
    log(f"[quality] compare_quality (ALS on the card) in {took:.3f}s: {json.dumps(got)}")
    log(f"[quality] reference MAP@10 over seeds {QUALITY_SEEDS}: {maps}; band "
        f"[{lo - width:.4f}, {hi + width:.4f}]")
    if (abs(got["rmse_tpu"] - got["rmse_ref"]) > QUALITY_RMSE_TOL
            or not lo - width <= got["map10_tpu"] <= hi + width
            or not got["map10_implicit"] > got["map10_popularity"]):
        fail(f"[quality] the card's ALS is off the reference: {got}")
    t0 = time.perf_counter()
    real = quality.implicit_vs_popularity_kfold(movielens.load_ratings_file(SAMPLE_RATINGS))
    log(f"[quality] sample_movielens.txt, 5 folds, implicit ALS on the card in "
        f"{time.perf_counter() - t0:.3f}s: {real}")
    if not real["map10_implicit"] > real["map10_popularity"]:
        fail(f"[quality] implicit ALS does not beat popularity on the sample file: {real}")


def _markov_reference(rows: np.ndarray, cols: np.ndarray, n: int, k: int):
    """The top-k transitions per row in float64 on the host, from the
    sparse counts: (ids, probabilities), probability descending, index
    ascending among equals, -1 past a row's transitions."""
    key = rows.astype(np.int64) * n + cols
    uniq, counts = np.unique(key, return_counts=True)
    r, c = uniq // n, uniq % n
    p = counts / np.bincount(r, weights=counts, minlength=n)[r]
    order = np.lexsort((c, -p, r))
    r, c, p = r[order], c[order], p[order]
    rank = np.arange(len(r)) - np.searchsorted(r, np.arange(n))[r]
    keep = rank < k
    ids, probs = np.full((n, k), -1, np.int64), np.zeros((n, k))
    ids[r[keep], rank[keep]] = c[keep]
    probs[r[keep], rank[keep]] = p[keep]
    return ids, probs


def phase_markov() -> None:
    """Phase 25c: MarkovChain.train over ML-20M's 26,744 items (a 2.86 GB
    dense f32 table on the card) from the first MARKOV_RATINGS of phase
    9's power-law ratings as
    per-user consecutive transitions, against float64 on the host."""
    n_users, n_items, nnz = ML20M
    t0 = time.perf_counter()
    u, i, _ = make_ratings(n_users, n_items, nnz, SEED)
    u, i = u[:MARKOV_RATINGS], i[:MARKOV_RATINGS]
    order = np.argsort(u, kind="stable")
    u, i = u[order], i[order]
    same = u[1:] == u[:-1]
    rows, cols = i[:-1][same], i[1:][same]
    transitions = list(zip(rows.tolist(), cols.tolist(), [1.0] * len(rows)))
    host_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = e2.MarkovChain.train(n_items, transitions, top_n=MARKOV_TOP)
    train_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del transitions
    args = [torch.from_numpy(a).to(DEVICE) for a in (rows, cols, np.ones(len(rows), np.float32))]
    build = lambda: e2.markov_top_transitions(n_items, *args, MARKOV_TOP)  # noqa: E731
    build()
    ms, _ = _events_ms(build)
    device_ms, launches = _profile(build, top="markov")
    nbytes = len(rows) * 12 + n_items * MARKOV_TOP * 12
    t0 = time.perf_counter()
    ids, probs = _markov_reference(rows, cols, n_items, MARKOV_TOP)
    ref_s = time.perf_counter() - t0
    ties = int(((probs[:, 1:] == probs[:, :-1]) & (probs[:, 1:] > 0)).sum())
    err = float(np.abs(model.transition_prob - probs).max())
    log(f"[markov] {len(rows)} transitions over {n_items} states (host list {host_s:.1f}s); "
        f"MarkovChain.train {train_s:.3f}s, peak_mem_gb={peak_gb:.3f}; the build "
        f"{_fmt(ms)} ms by CUDA events, {_fmt(device_ms)} ms device in {launches} launches, "
        f"bound {_bound_ms(nbytes)} ms; float64 reference {ref_s:.1f}s; max |p - p64| "
        f"{err:.3e} (tol {MARKOV_PROB_TOL}); {ties} tied neighbour slots in the top "
        f"{MARKOV_TOP}")
    if not np.array_equal(model.transition_index, ids) or err > MARKOV_PROB_TOL:
        bad = int((model.transition_index != ids).sum())
        fail(f"[markov] {bad} ids differ from the float64 reference, or max error {err}")


#: the Covertype-shape rows the categorical naive Bayes counts: the first
#: quarter of phase 21's (cut from all 581,012 to make room for phase 28:
#: the host's strings and training took ~22 s); the 54 features stay
NB_ROWS = COVTYPE[0] // 4


def phase_categorical_nb() -> None:
    """Phase 25d: CategoricalNaiveBayes.train on phase 21's Covertype-shape
    rows as categorical strings on the card; the counts exactly against
    NumPy bincount."""
    _, n_feat, n_cls = COVTYPE
    X, y = covtype_data(COVTYPE[0], SEED + 21)
    X, y = X[:NB_ROWS], y[:NB_ROWS]
    rows = NB_ROWS
    t0 = time.perf_counter()
    values = X.astype(np.int32).astype(str).tolist()
    points = [e2.LabeledPoint(f"c{c}", tuple(r)) for c, r in zip(y.tolist(), values)]
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = e2.CategoricalNaiveBayes.train(points)
    train_s = time.perf_counter() - t0
    del points, values
    # the model's encoding of every row, and the counts it stands for
    label_ix = np.asarray([model.labels[f"c{c}"] for c in range(n_cls)])[y]
    codes = [np.asarray([-1 if (ix := m.get(str(v))) is None else ix
                         for v in range(int(X[:, f].max()) + 1)])
             for f, m in enumerate(model.value_maps)]
    feat_ix = np.stack([codes[f][X[:, f].astype(np.int64)] for f in range(n_feat)], axis=1)
    vocab = model.log_likelihoods.shape[2]
    want_labels = np.bincount(label_ix, minlength=n_cls)
    want_values = np.stack([np.stack([np.bincount(feat_ix[label_ix == lab, f], minlength=vocab)
                                      for f in range(n_feat)]) for lab in range(n_cls)])
    dev_l, dev_f = torch.from_numpy(label_ix).to(DEVICE), torch.from_numpy(feat_ix).to(DEVICE)
    count = lambda: e2._nb_count(dev_l, dev_f, n_cls, n_feat, vocab, device=DEVICE)  # noqa: E731
    got_labels, got_values = count()
    ms, _ = _events_ms(count)
    device_ms, launches = _profile(count, top="nb-count")
    nbytes = label_ix.size * 8 + feat_ix.size * 8 + (n_cls + n_cls * n_feat * vocab) * 4
    exact = (np.array_equal(got_labels.cpu().numpy(), want_labels)
             and np.array_equal(got_values.cpu().numpy(), want_values))
    with np.errstate(divide="ignore"):
        want_ll = (np.log(want_values.astype(np.float32))
                   - np.log(want_labels.astype(np.float32))[:, None, None])
    for f, m in enumerate(model.value_maps):
        want_ll[:, f, len(m):] = -np.inf
    log(f"[nb] {rows} x {n_feat} categorical rows, {n_cls} labels, vocab {vocab} (strings "
        f"built in {host_s:.1f}s); CategoricalNaiveBayes.train {train_s:.3f}s; _nb_count "
        f"{_fmt(ms)} ms by CUDA events, {_fmt(device_ms)} ms device in {launches} launches, "
        f"bound {_bound_ms(nbytes)} ms; counts equal to NumPy bincount: {exact}")
    if not exact or not np.array_equal(model.log_likelihoods, want_ll):
        fail("[nb] the card's counts or log tables differ from NumPy bincount's")


def phase_e2() -> None:
    """Phase 25."""
    t0 = time.perf_counter()
    before = flash_ops.LAUNCHES
    phase_quality()
    torch.cuda.empty_cache()
    phase_markov()
    torch.cuda.empty_cache()
    phase_categorical_nb()
    if flash_ops.LAUNCHES != before:
        fail("the e2 phase launched the flash kernel")
    log(f"[e2] phase 25 took {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# Phase 26: the observability layers
# ---------------------------------------------------------------------------

#: phase 26: 64 distinct queries of 16a's stored users over 8 closed-loop
#: clients; three paired rounds traced / untraced (order alternated); one
#: batch of 50 events through the event server
OBS_QUERIES, OBS_CLIENTS, OBS_ROUNDS, OBS_EVENTS = 64, 8, 3, 50
#: FLOPs counted by the profiler against seqrec_train_flops
OBS_FLOPS_RTOL = 0.10
#: queries of the in-process launch check (CUDA events around each launch)
OBS_LAUNCH_QUERIES = 16
#: the JAX package's span order of a batched /queries.json
OBS_ENGINE_SPANS = ["parse", "bind", "codec_key", "batcher.queue_wait",
                    "batcher.device_dispatch", "encode"]
OBS_EVENT_SPANS = ["parse", "validate", "insert_batch"]
_PROM_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*\})?'
    r' (\S+)$')


def _request(port: int, method: str, path: str, body=None) -> tuple[int, bytes, dict]:
    """One request on a fresh connection: (status, raw body, headers)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, data, {"Content-Type": "application/json"} if data else {})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def parse_prometheus(text: str) -> dict[str, tuple[str, list[tuple[str, float]]]]:
    """``{family: (type, [(sample name + labels, value)])}`` of a text
    exposition; fails on a line that is not a comment or a sample, or a
    sample of a family with no ``# TYPE``."""
    families: dict[str, tuple[str, list]] = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            families[name] = (kind, [])
            continue
        if not line or line.startswith("# HELP "):
            continue
        m = _PROM_SAMPLE.match(line)
        if m is None:
            fail(f"[obs-metrics] not a Prometheus sample line: {line!r}")
        name = m.group(1)
        family = next((f for f in (name, re.sub(r"_(bucket|sum|count)$", "", name))
                       if f in families), None)
        if family is None:
            fail(f"[obs-metrics] sample {name} of a family with no # TYPE")
        families[family][1].append((name + (m.group(2) or ""), float(m.group(3))))
    return families


def _obs_traces(port: int, trace_ids: set[str], path: str = "/traces.json") -> list[dict]:
    """The traces of ``trace_ids`` from the server's ring (a handler
    records its trace after writing the response, so this polls)."""
    deadline = time.monotonic() + 10
    while True:
        status, raw, _ = _request(port, "GET", path)
        if status != 200:
            fail(f"[obs] GET {path} answered {status}: {raw[:300]}")
        traces = [t for t in json.loads(raw)["traces"] if t["traceId"] in trace_ids]
        if len(traces) == len(trace_ids) or time.monotonic() > deadline:
            return traces
        time.sleep(0.02)


def _check_spans(tag: str, traces: list[dict], want: list[str]) -> None:
    """Every trace's spans in the JAX package's order, each inside its root."""
    for t in traces:
        names = [s["name"] for s in t["spans"]]
        outside = [s["name"] for s in t["spans"]
                   if s["startMs"] < 0 or s["startMs"] + s["durationMs"] > t["durationMs"] + 2e-3]
        if names != want or outside:
            fail(f"[{tag}] trace {t['traceId']}: spans {names} (want {want}); outside the "
                 f"root: {outside}")


def _dispatch_batches(traces: list[dict]) -> int:
    """Distinct batches behind the traces' batcher.device_dispatch spans:
    one batch's entries share the span's duration and (to within the
    clocks' sub-ms skew) its start."""
    batches: list[tuple[float, float]] = []
    for t in traces:
        for s in t["spans"]:
            if s["name"] == "batcher.device_dispatch":
                start = t["startTime"] * 1e3 + s["startMs"]
                if not any(d == s["durationMs"] and abs(b - start) < 1.0 for b, d in batches):
                    batches.append((start, s["durationMs"]))
    return len(batches)


def _obs_train(pio: _Pio, engine_json: str) -> tuple[str, dict]:
    """26a: `pio train --profile` on 16a's store; (instance id, report)."""
    prof_dir = os.path.join(pio.base, "obs-profile")
    report_path = os.path.join(pio.base, "obs-train-report.json")
    out, seconds = pio.run("obs-train", "train", "--engine-json", engine_json, "--device",
                           DEVICE, "--profile", "--profile-dir", prof_dir,
                           "--profile-out", report_path)
    found = re.search(r"Training finished: engine instance (\w+) \(COMPLETED\)", out)
    profile = re.search(r"\[INFO\] Train profile: (.*)", out)
    if found is None or profile is None or "[INFO] Stage times: " not in out:
        fail(f"[obs-train] pio train --profile printed no profile: {out[-2000:]}")
    with open(report_path) as f:
        report = json.load(f)
    log(f"[obs-train] pio train --profile: {seconds:.3f}s; {profile.group(1)}")
    log(f"[obs-train] {re.search(r'Stage times: .*', out).group(0)}")
    trace_file = os.path.join(prof_dir, TrainProfiler.TRACE_FILE)
    trace_mb = os.path.getsize(trace_file) / 2**20 if os.path.exists(trace_file) else 0.0
    storage = Storage({"PIO_FS_BASEDIR": pio.env["PIO_FS_BASEDIR"]})
    deployed = load_deployed_engine(storage, ServerConfig(engine_instance_id=found.group(1),
                                                          device=DEVICE))
    cfg = deployed.models[0].cfg
    del deployed
    want = seqrec_train_flops(cfg, PIO_SESSION[0], PIO_SESSION_TRAIN["batch_size"],
                              PIO_SESSION_TRAIN["epochs"])
    flops, mfu = report["flops"]["executed"], report["mfu"]
    total = torch.cuda.get_device_properties(0).total_memory
    peak = (report["hbm"] or {}).get("peakBytes")
    train = report["stages"].get("train", {})
    train_mfu = (flops / train["wallSeconds"] / PEAK_FLOPS[torch.bfloat16]
                 if flops and train else None)
    log(f"[obs-train] report {report['schema']}: device {report['deviceKind']!r}, stages "
        f"{ {k: v['wallSeconds'] for k, v in report['stages'].items()} }; FLOPs counted "
        f"{flops:.6g} against the analytic {want:.6g} (vocab {cfg.vocab}, "
        f"{PIO_SESSION[0]} sequences of {cfg.max_len}, batch "
        f"{PIO_SESSION_TRAIN['batch_size']}): ratio {(flops or 0) / want:.6f}; MFU {mfu} "
        f"({report['mfuReason']}) against {report['flops']['peakPerChip']} "
        f"({report['flops']['peakSource']}) over the run's {report['wallSeconds']}s; over the "
        f"train stage's {train.get('wallSeconds')}s alone {train_mfu}; peak device bytes "
        f"{peak} of {total}; compiles {report['compile']['totalCompiles']}; Chrome trace "
        f"{trace_mb:.1f} MiB")
    if (report["schema"] != "pio.train_report.v1"
            or not {"read", "prepare", "train", "persist"} <= set(report["stages"])
            or not flops or abs(flops / want - 1) > OBS_FLOPS_RTOL
            or not isinstance(mfu, float) or not 0 < mfu <= 1
            or report["flops"]["peakSource"] != "table"
            or report["flops"]["peakPerChip"] != PEAK_FLOPS[torch.bfloat16]
            or peak is None or not 0 < peak < total or trace_mb <= 0):
        fail(f"[obs-train] the train report fails its checks: {json.dumps(report)[:3000]}")
    return found.group(1), report


def _obs_launches_in_dispatch(pio: _Pio, instance_id: str, bodies: list[dict]) -> int:
    """26b': the instance behind an in-process traced, batched server:
    each flash launch's host time falls inside a batcher.device_dispatch
    span, and the CUDA event recorded after it has completed when
    query_batch returns (before the span ends). Returns the launches."""
    storage = Storage({"PIO_FS_BASEDIR": pio.env["PIO_FS_BASEDIR"]})
    srv = create_engine_server(storage, ServerConfig(
        ip="127.0.0.1", port=0, engine_instance_id=instance_id, device=DEVICE,
        batching=True, batch_max=LOAD_BATCH_MAX, tracing=True)).start()
    launches: list[tuple[float, torch.cuda.Event]] = []
    windows: list[tuple[int, int, bool]] = []
    traces = []
    real_flash, real_batch = seqrec.flash_attention, srv.service.deployed.query_batch
    real_record = srv.service.trace_log.record

    def flash(q, k, v, **kw):
        t = time.perf_counter()
        out = real_flash(q, k, v, **kw)
        ev = torch.cuda.Event()
        ev.record()
        launches.append((t, ev))
        return out

    def query_batch(queries):
        n0 = len(launches)
        out = real_batch(queries)
        windows.append((n0, len(launches), all(ev.query() for _, ev in launches[n0:])))
        return out

    def record(trace):
        traces.append(trace)
        real_record(trace)

    seqrec.flash_attention = flash
    srv.service.deployed.query_batch = query_batch
    srv.service.trace_log.record = record
    try:
        _closed_loop(srv.port, bodies, OBS_CLIENTS)          # warm
        for kept in (traces, launches, windows):
            kept.clear()
        flash_ops.LAUNCHES = 0
        results, _ = _closed_loop(srv.port, bodies, OBS_CLIENTS)
        counted = flash_ops.LAUNCHES
    finally:
        seqrec.flash_attention = real_flash
        srv.stop()
    deadline = time.monotonic() + 10
    while len(traces) < len(bodies) and time.monotonic() < deadline:
        time.sleep(0.02)
    dispatch = [(tr.start_perf + off, tr.start_perf + off + dur)
                for tr in traces for name, _, _, off, dur in tr.spans()
                if name == "batcher.device_dispatch"]
    inside = sum(any(a <= t <= b for a, b in dispatch) for t, _ in launches)
    done = all(ok for _, _, ok in windows)
    log(f"[obs-launch] in-process traced batched server, {len(bodies)} queries at "
        f"C={OBS_CLIENTS}: {len(launches)} flash launches in {len(windows)} dispatches "
        f"(LAUNCHES counted {counted}); {inside} of {len(launches)} launched inside a "
        f"batcher.device_dispatch span; every launch's CUDA event complete when query_batch "
        f"returned (inside the span): {done}")
    if (any(r[0] != 200 for r in results) or not launches or inside != len(launches)
            or not done or counted != len(launches)):
        fail("[obs-launch] a flash launch fell outside batcher.device_dispatch, or ran past it")
    return counted


def _obs_overhead(ports: dict[str, int], bodies: list[dict]) -> dict:
    """26d: the same deploy traced and untraced at C = OBS_CLIENTS:
    OBS_ROUNDS paired rounds, the order alternated."""
    rows: dict[str, list] = {"tracing": [], "no-tracing": []}
    for mode in rows:                                        # warm both
        _closed_loop(ports[mode], bodies[:OBS_CLIENTS], OBS_CLIENTS)
    for r in range(OBS_ROUNDS):
        order = ("tracing", "no-tracing") if r % 2 == 0 else ("no-tracing", "tracing")
        for mode in order:
            before = _get(ports[mode], "/stats.json")[1]
            results, wall = _closed_loop(ports[mode], bodies, OBS_CLIENTS)
            after = _get(ports[mode], "/stats.json")[1]
            if any(x[0] != 200 for x in results):
                fail(f"[obs-overhead] {mode}: a query failed")
            ms = [x[2] for x in results]
            rows[mode].append((_quantile(ms, 0.5), _quantile(ms, 0.99), len(bodies) / wall))
            # a batch of n runs popcount(n) forwards: the batch sizes the
            # adaptive policy formed move queries/s as much as any span
            hist = _hist_delta(after, before)
            (n0, d0), (n1, d1) = (_sum_ms(before, "deviceDispatch"),
                                  _sum_ms(after, "deviceDispatch"))
            log(f"[obs-overhead] round {r} {mode}: p50_ms={rows[mode][-1][0]:.3f} "
                f"p99_ms={rows[mode][-1][1]:.3f} qps={rows[mode][-1][2]:.2f} batch_hist={hist} "
                f"forwards={sum(c * bin(n).count('1') for n, c in hist.items())} "
                f"dispatch_ms_per_batch={(d1 - d0) / max(1, n1 - n0):.3f}")
    med = {mode: [statistics.median(x[i] for x in v) for i in range(3)]
           for mode, v in rows.items()}
    (tp50, tp99, tqps), (up50, up99, uqps) = med["tracing"], med["no-tracing"]
    out = dict(p50_pct=(tp50 / up50 - 1) * 100, p99_pct=(tp99 / up99 - 1) * 100,
               qps_pct=(1 - tqps / uqps) * 100)
    log(f"[obs-overhead] tracing overhead at C={OBS_CLIENTS}, medians of {OBS_ROUNDS} paired "
        f"rounds: p50 {up50:.3f} -> {tp50:.3f} ms ({out['p50_pct']:+.2f}%), p99 {up99:.3f} -> "
        f"{tp99:.3f} ms ({out['p99_pct']:+.2f}%), qps {uqps:.2f} -> {tqps:.2f} "
        f"({out['qps_pct']:+.2f}% fewer)")
    return out


def _obs_metrics(port: int, before: dict) -> int:
    """26c: /metrics of the traced deploy; /stats.json's compile block.
    Returns the kernel launches since ``before`` (its GET /)."""
    status, raw, headers = _request(port, "GET", "/metrics")
    if status != 200 or not headers.get("Content-Type", "").startswith("text/plain"):
        fail(f"[obs-metrics] GET /metrics answered {status} {headers}")
    families = parse_prometheus(raw.decode())

    def value(name: str) -> float:
        samples = families.get(name, ("", []))[1]
        if len(samples) != 1:
            fail(f"[obs-metrics] {name}: expected one sample, got {samples}")
        return samples[0][1]

    in_use, peak = value("pio_device_bytes_in_use"), value("pio_device_peak_bytes_in_use")
    limit, recompiles = value("pio_device_bytes_limit"), value("pio_serving_recompile_total")
    total = torch.cuda.get_device_properties(0).total_memory
    stats = _get(port, "/stats.json")[1]
    after = _status(port)
    log(f"[obs-metrics] GET /metrics: {len(families)} families, "
        f"{sum(len(v[1]) for v in families.values())} samples, parsed as Prometheus text; "
        f"pio_device_bytes_in_use={in_use:.0f} pio_device_peak_bytes_in_use={peak:.0f} "
        f"pio_device_bytes_limit={limit:.0f} (total_memory {total}); "
        f"pio_serving_recompile_total={recompiles:.0f}; /stats.json compile {stats['compile']}")
    if (not 0 < in_use <= peak or limit != total or recompiles != 0
            or stats["compile"]["servingRecompiles"] != 0
            or not stats["compile"]["warmupComplete"]):
        fail("[obs-metrics] device gauges, the recompile counter or the compile block wrong")
    return (after["kernelLaunches"]["flash_attention"]
            - before["kernelLaunches"]["flash_attention"])


def _obs_eventserver(pio: _Pio) -> None:
    """26e: `pio eventserver --tracing`, one batch of OBS_EVENTS events:
    its trace behind the key, the ingest families on /metrics."""
    out, _ = pio.run("obs-events", "app", "new", "obs")
    key = re.search(r"Access Key: (\S+)", out).group(1)
    proc, port, start_s = pio.eventserver("obs-events", "--tracing")
    try:
        docs = [doc for doc, _ in zip(_session_docs(range(PIO_SESSION[0])), range(OBS_EVENTS))]
        status, raw, headers = _request(port, "POST", f"/batch/events.json?accessKey={key}",
                                        docs)
        statuses = {r["status"] for r in json.loads(raw)} if status == 200 else set()
        trace_id = headers.get("X-PIO-Trace-Id")
        if statuses != {201} or not trace_id:
            fail(f"[obs-events] the batch answered {status} {raw[:300]} {headers}")
        if _request(port, "GET", "/traces.json")[0] != 401:
            fail("[obs-events] /traces.json answered without the access key")
        traces = _obs_traces(port, {trace_id}, f"/traces.json?accessKey={key}")
        _check_spans("obs-events", traces, OBS_EVENT_SPANS)
        families = parse_prometheus(_request(port, "GET", "/metrics")[1].decode())
    finally:
        _stop(proc)
    ingest = {k: v for k, v in families.items() if k.startswith("pio_ingest_")}
    events = ingest.get("pio_ingest_events_total", ("", [("", 0.0)]))[1][0][1]
    log(f"[obs-events] pio eventserver --tracing: listening after {start_s:.3f}s; "
        f"{OBS_EVENTS} events in one batch, trace spans "
        f"{[s['name'] for s in traces[0]['spans']]}; ingest families "
        f"{sorted((k, v[0]) for k, v in ingest.items())}; pio_ingest_events_total={events:.0f}")
    for name in ("pio_ingest_batches_total", "pio_ingest_events_total",
                 "pio_ingest_batch_size", "pio_ingest_insert_seconds"):
        if name not in ingest:
            fail(f"[obs-events] /metrics lacks {name}")
    if events < OBS_EVENTS:
        fail(f"[obs-events] pio_ingest_events_total {events} < {OBS_EVENTS}")


def phase_obs(pio: _Pio, engine_json: str) -> int:
    """Phase 26 over 16a's store (SessApp imported); returns the flash
    launches of its deploy processes and of its in-process server."""
    t0 = time.perf_counter()
    log_card()
    instance_id, _ = _obs_train(pio, engine_json)
    bodies = [{"user": f"u{u}", "num": 10 + u % 3} for u in range(OBS_QUERIES)]
    procs, ports = {}, {}
    try:
        started = {mode: pio.start_deploy(f"obs-{mode}", engine_json, "--engine-instance-id",
                                          instance_id, f"--{mode}", "--batching",
                                          "--batch-max", str(LOAD_BATCH_MAX))
                   for mode in ("tracing", "no-tracing")}
        for mode, (proc, out_path, t_start) in started.items():
            procs[mode], ports[mode], _ = pio.wait_listening(f"obs-{mode}", proc, out_path,
                                                             t_start)
        port = ports["tracing"]
        before = _status(port)
        results, wall = _closed_loop(port, bodies, OBS_CLIENTS)
        ids = {r[4] for r in results}
        if any(r[0] != 200 for r in results) or None in ids or len(ids) != len(bodies):
            fail(f"[obs-serve] expected {len(bodies)} answers, each with its own "
                 f"X-PIO-Trace-Id: {[r[:2] for r in results if r[0] != 200][:3]}")
        traces = _obs_traces(port, ids)
        if len(traces) != len(bodies):
            fail(f"[obs-serve] /traces.json holds {len(traces)} of the {len(bodies)} traces")
        _check_spans("obs-serve", traces, OBS_ENGINE_SPANS)
        # the deploy answered these queries and no others
        hist = _hist(_get(port, "/stats.json")[1])
        layers = PIO_SESSION_TRAIN["n_layers"]
        launches = _obs_metrics(port, before)
        batches = _dispatch_batches(traces)
        log(f"[obs-serve] pio deploy --tracing --batching: {len(bodies)} queries at "
            f"C={OBS_CLIENTS} in {wall:.3f}s, every answer with X-PIO-Trace-Id; spans "
            f"{OBS_ENGINE_SPANS} in every trace, each inside its root; batch histogram "
            f"{hist} ({sum(hist.values())} dispatches, {batches} distinct "
            f"batcher.device_dispatch spans); flash launches {launches} (4 x popcount: "
            f"{_launches_for(hist, layers)})")
        if launches != _launches_for(hist, layers) or batches != sum(hist.values()):
            fail("[obs-serve] the deploy's launches or dispatch spans do not match its batches")
        _obs_overhead(ports, bodies)
    finally:
        for proc in procs.values():
            _stop(proc)
    launches += _obs_launches_in_dispatch(pio, instance_id, bodies[:OBS_LAUNCH_QUERIES])
    torch.cuda.empty_cache()
    _obs_eventserver(pio)
    log(f"[obs] phase 26 took {time.perf_counter() - t0:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# Phase 27: the prefork serving pool (`pio deploy --workers N`)
# ---------------------------------------------------------------------------

#: the pool sizes held against N = 1; 4 only where the host allows 4
#: CPU stripes (serving/placement.py carves one per worker)
POOL_SIZES = (2, 4)
#: phase 17's C=64 level: 256 distinct queries, closed loop
POOL_CLIENTS, POOL_QUERIES = 64, 256
#: warm-up queries a pool takes before its level (every worker then has
#: answered at 64 connections), kept out of the level
POOL_WARM = 64
#: the flags every sessionrec deploy of phase 27 takes, at each N
POOL_FLAGS = ("--batching", "--batch-max", str(LOAD_BATCH_MAX), "--cache", "--shm-cache",
              "--tracing", "--supervise", "--server-key", SERVER_KEY)
#: sync intervals (0.5 s each) an admin change may take to reach every worker
POOL_SYNC_WAIT_S = 10.0
#: seconds a SIGKILLed sibling may take to be respawned and answer
POOL_RESPAWN_WAIT_S = 90.0
#: users of the online pool check (none folded by phase 23)
POOL_ONLINE_USERS = tuple(f"u{u}" for u in range(40, 48))


def _spool_workers(tmp: str) -> dict[str, dict]:
    """The live workers of the pools whose TMPDIR is ``tmp``: id -> spool
    entry ({"worker", "pid", "port"}: the worker's loopback peer port)."""
    out = {}
    for d in os.listdir(tmp):
        if not d.startswith("pio-deploy-workers-"):
            continue
        for name in os.listdir(os.path.join(tmp, d)):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(tmp, d, name)) as f:
                    doc = json.load(f)
                os.kill(doc["pid"], 0)
            except (OSError, ValueError, KeyError):
                continue                   # torn, or a dead worker's entry
            out[doc["worker"]] = doc
    return out


class _PoolDeploy:
    """A `pio deploy` process over its own TMPDIR, so that the pool's
    spool directory (and so each worker's loopback peer port) is found."""

    def __init__(self, pio: _Pio, tag: str, engine_json: str, n: int, *flags: str):
        self.tag, self.n = tag, n
        self.tmp = tempfile.mkdtemp(prefix=f"{tag}-", dir=pio.base)
        self.proc, self.out_path, self.t0 = pio.start_deploy(
            tag, engine_json, "--workers", str(n), *flags, env={**pio.env, "TMPDIR": self.tmp})
        self.port = None
        self.listening_s = None

    def wait(self) -> "_PoolDeploy":
        """Until the deploy process listens and all n workers are in the
        spool: the pool's seconds to listening."""
        deadline = time.monotonic() + PIO_STEP_TIMEOUT
        while True:
            with open(self.out_path) as f:
                text = f.read()
            found = re.search(r"listening on 127\.0\.0\.1:(\d+)", text)
            if found and len(self.workers()) >= self.n:
                break
            if self.proc.poll() is not None or time.monotonic() > deadline:
                self.proc.kill()
                fail(f"[{self.tag}] the pool did not come up:\n{text[-3000:]}")
            time.sleep(0.02)
        self.port = int(found.group(1))
        self.listening_s = time.perf_counter() - self.t0
        log(f"[{self.tag}] pio deploy --workers {self.n}: {self.n} worker(s) listening on "
            f":{self.port} after {self.listening_s:.3f}s")
        return self

    def workers(self) -> dict[str, dict]:
        """Live workers: id -> spool entry ({"worker", "pid", "port"});
        outside a pool the deploy process itself, on the public port."""
        if self.n == 1:
            return {"single": {"worker": "single", "pid": self.proc.pid, "port": self.port}}
        return _spool_workers(self.tmp)

    def each(self, path: str) -> dict[str, dict]:
        """Every worker's own ``path`` (its status "/" or local
        "/stats.json"), read over its loopback peer endpoint: no
        connection lottery."""
        return {w: _get(e["port"], path)[1] for w, e in self.workers().items()}

    def stop(self) -> None:
        _stop(self.proc)


def _server_counts(port: int) -> dict:
    """One engine server's own counts over its own port: flash launches,
    device, batch histogram, cache hits and misses, builds, batch
    retries, queries."""
    status, stats = _get(port, "/")[1], _get(port, "/stats.json")[1]
    return dict(launches=status["kernelLaunches"]["flash_attention"],
                device=status["device"], hist=_hist(stats),
                hits=stats["serving"]["cacheHits"], misses=stats["serving"]["cacheMisses"],
                compiles=stats["compile"]["compiles"], retries=_retries(stats),
                requests=status["requestCount"])


def _pool_counts(pool: _PoolDeploy) -> dict:
    """Per worker, over its loopback peer endpoint: `_server_counts`."""
    return {w: _server_counts(e["port"]) for w, e in pool.workers().items()}


def _pool_launch_identity(tag: str, pool: _PoolDeploy, layers: int) -> int:
    """Each worker's launches = n_layers x Σ popcount of its dispatched
    batch sizes, no worker built a kernel or retried a batch; returns
    the pool's launches."""
    counts = _pool_counts(pool)
    for w, c in counts.items():
        want = _launches_for(c["hist"], layers)
        if c["launches"] != want or c["compiles"] or c["retries"] or \
                not c["device"].startswith("cuda"):
            fail(f"[{tag}] worker {w}: launches {c['launches']} (expected {want}), builds "
                 f"{c['compiles']}, batch retries {c['retries']}, device {c['device']}")
    total = sum(c["launches"] for c in counts.values())
    log(f"[{tag}] per-worker flash launches "
        f"{ {w: c['launches'] for w, c in counts.items()} } = {layers} x popcount of each "
        f"worker's batches; sum {total}; no build and no batch retry in any worker")
    return total


def _pool_level(tag: str, pool: _PoolDeploy, bodies: list[dict], want: list) -> dict:
    """Phase 17's C=64 level against a pool: no query may hit a cache,
    every answer equals the in-process one within BATCH_SCORE_TOL, every
    worker launches; (p50, p99, queries/s, the merged histogram)."""
    before = _pool_counts(pool)
    results, wall = _closed_loop(pool.port, bodies, POOL_CLIENTS)
    after = _pool_counts(pool)
    bad = [(b, r[:2]) for b, r in zip(bodies, results) if r[0] != 200]
    if bad:
        fail(f"[{tag}] {len(bad)} queries failed, first {bad[0]}")
    hits = sum(after[w]["hits"] - before[w]["hits"] for w in after)
    if hits:
        fail(f"[{tag}] {hits} of the level's distinct queries hit a cache")
    for body, r, w in zip(bodies, results, want):
        if len(r[1]["itemScores"]) != body["num"] or not _same_answer(
                _as_result(r[1]), w, BATCH_SCORE_TOL):
            fail(f"[{tag}] an answer differs from the in-process one: {json.dumps(body)[:200]}")
    quiet = [w for w in after if after[w]["launches"] == before[w]["launches"]]
    if quiet:
        fail(f"[{tag}] workers {quiet} launched no flash kernel in the level")
    hist: dict[int, int] = {}
    for w in after:
        for n, c in after[w]["hist"].items():
            d = c - before[w]["hist"].get(n, 0)
            if d:
                hist[n] = hist.get(n, 0) + d
    ms = [r[2] for r in results]
    row = dict(workers=pool.n, clients=POOL_CLIENTS, n=len(bodies), p50_ms=_quantile(ms, 0.5),
               p99_ms=_quantile(ms, 0.99), qps=len(bodies) / wall,
               listening_s=pool.listening_s, hist=dict(sorted(hist.items())),
               per_worker_queries={w: after[w]["requests"] - before[w]["requests"]
                                   for w in after})
    log(f"[{tag}] N={pool.n} C={POOL_CLIENTS}: n={len(bodies)} p50_ms={row['p50_ms']:.3f} "
        f"p99_ms={row['p99_ms']:.3f} qps={row['qps']:.2f} batch_hist={row['hist']} "
        f"per_worker_queries={row['per_worker_queries']}; every answer equals the "
        f"in-process one (tol {BATCH_SCORE_TOL:g})")
    return row


def _pool_device_bytes(tag: str, pool: _PoolDeploy) -> dict[str, float]:
    """The folded /metrics: pio_serving_workers = N, and the device
    gauges once per worker (labelled, never summed)."""
    status, raw, _ = _request(pool.port, "GET", "/metrics")
    if status != 200:
        fail(f"[{tag}] /metrics answered {status}")
    fams = parse_prometheus(raw.decode())
    workers = [v for _, v in fams.get("pio_serving_workers", ("", []))[1]]
    in_use = {(m.group(1) if (m := re.search(r'worker="([^"]+)"', name)) else "single"): v
              for name, v in fams.get("pio_device_bytes_in_use", ("", []))[1]}
    if workers != [float(pool.n)] or len(in_use) != pool.n or min(in_use.values()) <= 0:
        fail(f"[{tag}] folded /metrics: pio_serving_workers {workers}, device bytes in use "
             f"{in_use}")
    return in_use


def _pool_coherence(pool: _PoolDeploy) -> None:
    """/reload and /drain landing on one worker reach every worker (the
    /stats.json per-worker admin section); /metrics counters equal the
    sum of the workers' own; /traces.json holds more than one worker's
    spans."""
    tag = "pool-coherence"
    # the folded counters against each worker's own exposition
    status, raw, _ = _request(pool.port, "GET", "/metrics")
    folded = parse_prometheus(raw.decode())
    own = [parse_prometheus(_request(e["port"], "GET", "/metrics")[1].decode())
           for e in pool.workers().values()]
    checked = []
    for name in ("pio_serving_dispatches_total", "pio_serving_batched_queries_total",
                 "pio_serving_cache_misses_total"):
        total = sum(v for fams in own for _, v in fams.get(name, ("", []))[1])
        got = sum(v for _, v in folded.get(name, ("", []))[1])
        if got != total or got <= 0:
            fail(f"[{tag}] folded {name} {got} != the workers' sum {total}")
        checked.append(f"{name}={got:g}")
    log(f"[{tag}] /metrics is the folded view: {', '.join(checked)}, each the sum of "
        f"{len(own)} workers' own expositions")
    status, doc = _get(pool.port, "/traces.json")
    sources = {t.get("source", "answering worker") for t in doc["traces"]}
    if status != 200 or len(sources) < 2:
        fail(f"[{tag}] /traces.json holds spans of {sources} only")
    log(f"[{tag}] /traces.json: {len(doc['traces'])} traces from {len(sources)} workers")

    def settle(what: str, done) -> float:
        t0 = time.perf_counter()
        while True:
            section = _get(pool.port, "/stats.json")[1]["workers"]
            if len(section["admin"]) == pool.n and all(done(a) for a in section["admin"].values()):
                return time.perf_counter() - t0
            if time.perf_counter() - t0 > POOL_SYNC_WAIT_S:
                fail(f"[{tag}] {what} did not reach every worker: {section['admin']}")
            time.sleep(0.05)

    gen = max(a["modelGeneration"] for a in _get(pool.port, "/stats.json")[1]["workers"]
              ["admin"].values())
    status, doc = _get(pool.port, f"/reload?accessKey={SERVER_KEY}")
    if status != 200:
        fail(f"[{tag}] /reload answered {status}: {doc}")
    reload_s = settle("/reload", lambda a: a["modelGeneration"] == gen + 1)
    status, doc, _ = _http(pool.port, "POST", f"/drain?accessKey={SERVER_KEY}", {})
    drain_s = settle("/drain", lambda a: a["draining"])
    ready = {_get(pool.port, "/readyz")[0] for _ in range(8)}
    _http(pool.port, "POST", f"/drain?accessKey={SERVER_KEY}", {"action": "undrain"})
    undrain_s = settle("the undrain", lambda a: not a["draining"])
    if ready != {503}:
        fail(f"[{tag}] a drained pool's /readyz answered {ready}")
    log(f"[{tag}] POST /reload on one worker: every worker at model generation {gen + 1} "
        f"within {reload_s:.3f}s; POST /drain: every worker draining within {drain_s:.3f}s "
        f"(/readyz {sorted(ready)} over 8 fresh connections), undrained within "
        f"{undrain_s:.3f}s (sync interval 0.5 s)")


def _pool_shm(pool: _PoolDeploy, body: dict, layers: int) -> None:
    """One worker answers a query; its siblings hit it in the shared
    segment, and a hit launches nothing."""
    tag = "pool-shm"
    before = _pool_counts(pool)
    if _post(pool.port, body)[0] != 200:
        fail(f"[{tag}] the first query failed")
    first = _pool_counts(pool)
    origin = [w for w in first if first[w]["misses"] > before[w]["misses"]]
    for _ in range(8 * pool.n):
        status, doc, _ = _post(pool.port, body)      # a fresh connection each
        if status != 200:
            fail(f"[{tag}] a repeat answered {status}: {doc}")
    after = _pool_counts(pool)
    hits = {w: after[w]["hits"] - first[w]["hits"] for w in after}
    launched = {w: after[w]["launches"] - first[w]["launches"] for w in after}
    sibling_hits = sum(h for w, h in hits.items() if w not in origin)
    log(f"[{tag}] one query answered by worker {origin}, then {8 * pool.n} repeats: hits per "
        f"worker {hits}, launches per worker {launched}")
    if len(origin) != 1 or sum(hits.values()) != 8 * pool.n or sibling_hits == 0 \
            or any(launched.values()):
        fail(f"[{tag}] the shared segment did not serve the siblings, or a hit launched")


def _kill_and_respawn(pool: _PoolDeploy, seed: int) -> int:
    """SIGKILL one sibling while the pool serves: the supervisor respawns
    it (spawn context), the new worker answers on the card with launches
    of its own, no query gets a 5xx, the shared segment survives.
    Returns the killed worker's launches, read just before the kill."""
    import http.client
    import signal
    import threading

    tag = "pool-supervise"
    segment = f"/dev/shm/pio-shm-{pool.proc.pid}"
    workers = pool.workers()
    victim = next(e for e in workers.values() if e["pid"] != pool.proc.pid)
    codes: list[int] = []
    resets = [0]
    stop = threading.Event()

    def client(k: int) -> None:
        # distinct session queries, each retried on a fresh connection
        # after a reset (a query is an idempotent read)
        gen = np.random.default_rng(seed + k)
        while not stop.is_set():
            body = {"items": [f"i{i}" for i in gen.integers(1, N_ITEMS + 1, 64)], "num": 10}
            for _ in range(3):
                try:
                    codes.append(_http(pool.port, "POST", "/queries.json", body)[0])
                    break
                except (OSError, http.client.HTTPException):
                    resets[0] += 1

    threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    try:
        time.sleep(1.0)
        victim_launches = _get(victim["port"], "/")[1]["kernelLaunches"]["flash_attention"]
        t_kill = time.perf_counter()
        os.kill(victim["pid"], signal.SIGKILL)
        old = {e["pid"] for e in workers.values()}
        while True:
            fresh = [e for e in pool.workers().values() if e["pid"] not in old]
            if fresh:
                new = fresh[0]
                status = _get(new["port"], "/")[1]
                if status["kernelLaunches"]["flash_attention"] > 0:
                    break
            if time.perf_counter() - t_kill > POOL_RESPAWN_WAIT_S:
                fail(f"[{tag}] no respawned worker answered within {POOL_RESPAWN_WAIT_S}s")
            time.sleep(0.1)
        respawn_s = time.perf_counter() - t_kill
    finally:
        stop.set()
        for t in threads:
            t.join()
    with open(f"/proc/{new['pid']}/cmdline") as f:
        cmdline = f.read().replace("\0", " ")
    if "spawn_main" not in cmdline:
        fail(f"[{tag}] the respawned worker was not started from the spawn context: {cmdline}")
    if not status["device"].startswith("cuda") or any(c >= 500 for c in codes) \
            or set(codes) - {200} or not os.path.exists(segment):
        fail(f"[{tag}] device {status['device']}; statuses {sorted(set(codes))}; segment "
             f"{segment} exists: {os.path.exists(segment)}")
    log(f"[{tag}] SIGKILL of worker pid {victim['pid']} under load at C=8: respawned as pid "
        f"{new['pid']} (spawn context) answering on {status['device']} with "
        f"{status['kernelLaunches']['flash_attention']} launches of its own "
        f"{respawn_s:.3f}s after the kill; {len(codes)} queries, statuses "
        f"{sorted(set(codes))}, {resets[0]} connection resets retried; {segment} survived")
    return victim_launches


#: a closed loop of distinct session queries at C clients for a number of
#: seconds, run as its own process so that its threads do not compete
#: with this process's launch loop for the GIL
_POOL_LOAD = r"""
import http.client, json, random, sys, threading, time
port, seconds, clients, n_items = int(sys.argv[1]), float(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
end = time.monotonic() + seconds
def client(seed):
    rng = random.Random(seed)
    while time.monotonic() < end:
        body = {"items": ["i%d" % rng.randint(1, n_items) for _ in range(2048)], "num": 10}
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("POST", "/queries.json", json.dumps(body).encode())
            conn.getresponse().read()
            conn.close()
        except Exception:
            pass
threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
[t.start() for t in threads]
[t.join() for t in threads]
"""


def _pool_kernel_under_load(pool: _PoolDeploy, deployed, body: dict) -> dict:
    """The flash kernel on the q/k/v of a served query (as phase 16a
    times it), timed in this process while the pool's workers serve
    full-length session queries at C=64 from their own CUDA contexts:
    the card time-slices between contexts, so this is the kernel as
    launched beside a busy pool."""
    load = subprocess.Popen([sys.executable, "-c", _POOL_LOAD, str(pool.port), "4",
                             str(POOL_CLIENTS), str(N_ITEMS)])
    try:
        time.sleep(1.5)
        row = _kernel_at_deploy(deployed, body)
    finally:
        load.wait(timeout=60)
    log(f"[pool-kernel] flash kernel at {row['shape']} {row['dtype']} (real keys "
        f"{row['real_keys']}) beside the {pool.n}-worker pool under load: ms={row['ms']:.4f} "
        f"device_ms={_fmt(row['device_ms'], 4)} plain_ms={row['plain_ms']:.4f} "
        f"library_ms={row['library_ms']:.4f} library_causal_ms={row['library_causal_ms']:.4f} "
        f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']})")
    return row


def _mapped_payloads(pid: int) -> set[str]:
    """The npz checkpoint payloads process ``pid`` maps."""
    with open(f"/proc/{pid}/maps") as f:
        return {line.split()[-1] for line in f if line.rstrip().endswith(".npz")}


def _sha256(paths: list[str]) -> str:
    import hashlib

    digest = hashlib.sha256()
    for path in paths:
        with open(path, "rb") as f:
            digest.update(f.read())
    return digest.hexdigest()


def _pool_online_start(pio: _Pio, rec_instance: tuple[str, str]) -> dict:
    """Start the processes of the online pool check (`_pool_online`): a
    key, `pio eventserver`, the 2-worker pool and the one-process deploy
    (which then come up while the sessionrec pools are checked)."""
    tag = "pool-online"
    engine_json, instance_id = rec_instance
    out, _ = pio.run(tag, "accesskey", "new", "ML100k")
    es_proc, es_port, _ = pio.eventserver(tag)
    return dict(
        key=re.search(r"Created new access key: (\S+)", out).group(1), es_proc=es_proc,
        es_port=es_port, instance_id=instance_id,
        pool=_PoolDeploy(pio, tag, engine_json, 2, "--engine-instance-id", instance_id,
                         "--model-mmap", "--online", "--online-interval-s",
                         str(ONLINE_INTERVAL_S), "--cache", "--cache-ttl-s", "600"),
        single=pio.start_deploy(f"{tag}-single", engine_json, "--engine-instance-id",
                                instance_id))


def _pool_online(pio: _Pio, started: dict) -> None:
    """16b's ML-100k instance behind `--workers 2 --model-mmap --online`
    and `pio eventserver` on one sqlite store, beside a one-process
    deploy of the same instance: equal answers; one tail lease; both
    workers map the checkpoint payloads and leave their bytes unchanged;
    after 8 users' new ratings are folded, answers on fresh connections
    (so both workers are reached) carry the changed answers, equal to the
    same fold in this process."""
    from predictionio_tpu_torch.online.follower import TailCursor
    from predictionio_tpu_torch.online.service import OnlineFoldIn

    tag = "pool-online"
    key, es_proc, es_port = started["key"], started["es_proc"], started["es_port"]
    pool, instance_id = started["pool"], started["instance_id"]
    storage = Storage({"PIO_FS_BASEDIR": pio.env["PIO_FS_BASEDIR"]})
    twin = None
    try:
        _, single_port, _ = pio.wait_listening(f"{tag}-single", *started["single"])
        pool.wait()
        deployed = load_deployed_engine(storage, ServerConfig(engine_instance_id=instance_id,
                                                              device=DEVICE))
        model = deployed.models[0]
        twin = OnlineFoldIn(storage=storage, deployed_fn=lambda: deployed,
                            generation_fn=lambda: 0, interval_s=3600,
                            initial_cursor=TailCursor(int(time.time() * 1_000_000), ""))
        twin.start()
        maps = {w: _mapped_payloads(e["pid"]) for w, e in pool.workers().items()}
        mapped = sorted(set.union(*maps.values()))
        if len(maps) != 2 or not mapped or any(m != set(mapped) for m in maps.values()):
            with open(pool.out_path) as f:
                fail(f"[{tag}] the workers do not map the same checkpoint payloads: {maps}\n"
                     f"{f.read()[-3000:]}")
        digest = _sha256(mapped)
        users = list(POOL_ONLINE_USERS)
        before = {}
        for u in users:
            want = [s["item"] for s in _post(single_port, {"user": u, "num": 10})[1]["itemScores"]]
            for _ in range(4):
                if _query_items(pool.port, u) != want:
                    fail(f"[{tag}] {u}: the pool's answer differs from the one-process deploy's")
            before[u] = want
        served = {w: d["requestCount"] for w, d in pool.each("/stats.json").items()}
        leaders = {w: d["online"]["leader"] for w, d in pool.each("/stats.json").items()}
        (spool,) = [d for d in os.listdir(pool.tmp) if d.startswith("pio-deploy-workers-")]
        with open(os.path.join(pool.tmp, spool, "online.lease")) as f:
            lease = json.load(f)
        if sum(leaders.values()) != 1 or not leaders.get(lease["worker"]) \
                or min(served.values()) == 0:
            fail(f"[{tag}] leaders {leaders}, lease {lease}, queries per worker {served}")
        log(f"[{tag}] pio deploy --workers 2 --model-mmap --online: {pool.listening_s:.3f}s to "
            f"listening; both workers map {[os.path.basename(p) for p in mapped]}; "
            f"{4 * len(users)} "
            f"answers over fresh connections (per worker {served}) equal the one-process "
            f"deploy's; the tail lease is held by {lease['worker']} alone")
        for u in users:
            status, doc, _ = _http(es_port, "POST", f"/events.json?accessKey={key}", {
                "event": "rate", "entityType": "user", "entityId": u,
                "targetEntityType": "item", "targetEntityId": before[u][0],
                "properties": {"rating": 5.0}})
            if status != 201:
                fail(f"[{tag}] POST /events.json answered {status}: {doc}")
        posted = time.perf_counter()
        twin.tick()
        changed = {}
        for u in users:
            mine = [i for i, _ in model.recommend(u, 10)]
            while True:
                got = [_query_items(pool.port, u) for _ in range(6)]
                if all(g == mine for g in got):
                    break
                if time.perf_counter() - posted > ONLINE_WAIT_S:
                    fail(f"[{tag}] {u}: fresh connections answer {got}, the fold in this "
                         f"process {mine}")
                time.sleep(0.05)
            if mine == before[u] or before[u][0] in mine:
                fail(f"[{tag}] {u}'s answer did not change with the rating")
            changed[u] = mine
        lag = time.perf_counter() - posted
        stats = pool.each("/stats.json")
        applied = {w: (d["online"]["overlayUsers"], d["online"]["appliedSeq"])
                   for w, d in stats.items()}
        served = {w: d["requestCount"] for w, d in stats.items()}
        if any(n < len(users) for n, _ in applied.values()):
            fail(f"[{tag}] a worker's overlay lacks the folded users: {applied}")
        if _sha256(mapped) != digest:
            fail(f"[{tag}] the mapped checkpoint's bytes changed")
        in_use = _pool_device_bytes(tag, pool)
        log(f"[{tag}] {len(users)} users rated their first answer: within {lag:.3f}s every "
            f"answer on 6 fresh connections a user equals the same fold in this process "
            f"(overlay users, applied snapshot seq per worker {applied}; queries per worker "
            f"{served}); the mapped payload's sha256 unchanged; device bytes in use per "
            f"worker {in_use} (each its own copy on the card)")
    finally:
        if twin is not None:
            twin.close()
        storage.close()
        _stop_online(started)


def _stop_online(started: dict) -> None:
    _stop_all([started["pool"].proc, started["single"][0], started["es_proc"]])


def phase_pool(pio: _Pio, instance_id: str, engine_json: str,
               rec_instance: tuple[str, str]) -> int:
    """Phase 27: 16a's instance behind `pio deploy --workers N` for N in
    {1, 2, 4} with POOL_FLAGS, phase 17's C=64 level on each (the same
    256 distinct queries); coherence on N=2; the shared cache, the
    kernel beside a busy pool and a SIGKILLed sibling's respawn on the
    largest N; then the ML-100k pool with --model-mmap --online.
    Returns the flash launches of the sessionrec pools."""
    t0 = time.perf_counter()
    cpus = len(os.sched_getaffinity(0))
    sizes = tuple(n for n in POOL_SIZES if n <= cpus)
    if sizes != POOL_SIZES:
        log(f"[pool] this host allows {cpus} CPU(s): no affinity stripe for N in "
            f"{sorted(set(POOL_SIZES) - set(sizes))}, so those pools are not run")
    storage = Storage({"PIO_FS_BASEDIR": pio.env["PIO_FS_BASEDIR"]})
    deployed = load_deployed_engine(storage, ServerConfig(engine_instance_id=instance_id,
                                                          device=DEVICE))
    pools: dict[int, _PoolDeploy] = {}
    online: list[dict] = []     # the online check's processes, once started
    try:
        try:
            launches = _pool_sessionrec(pio, instance_id, engine_json, rec_instance, sizes,
                                        deployed, pools, online)
        finally:
            _stop_all([pool.proc for pool in pools.values()])
            del deployed
            storage.close()
            torch.cuda.empty_cache()
        pids = {pool.proc.pid for pool in pools.values()}
        leaks = [p for p in os.listdir("/dev/shm")
                 if p.startswith("pio-shm-") and int(p.rsplit("-", 1)[1]) in pids]
        if leaks:
            fail(f"[pool] the deploy processes left shared-memory segments behind: {leaks}")
    except BaseException:
        if online:
            _stop_online(online[0])
        raise
    _pool_online(pio, online[0])
    log(f"[pool] phase 27 took {time.perf_counter() - t0:.1f}s")
    return launches


def _level_bodies() -> tuple[list[dict], list[dict], list]:
    """Phase 27's and 28's C=64 level: (its 256 distinct queries, the
    warm-up's 64, the (user, num) pairs left over)."""
    rng = np.random.default_rng(SEED + 27)
    combos = [(u, num) for u in range(PIO_SESSION[0]) for num in (5, 10, 20)]
    rng.shuffle(combos)
    bodies = _sess_mix(rng, POOL_QUERIES, combos)
    return bodies, _sess_mix(rng, POOL_WARM, combos), combos


def _pool_sessionrec(pio: _Pio, instance_id: str, engine_json: str,
                     rec_instance: tuple[str, str], sizes: tuple, deployed,
                     pools: dict, online: list) -> int:
    """Phase 27's sessionrec pools: the level at each N, coherence, the
    shared cache, the kernel beside a busy pool and the respawn. Each
    pool goes into ``pools``, and the online check's processes (started
    during the respawn) into ``online``, for the caller to stop. Returns
    the pools' flash launches."""
    layers = PIO_SESSION_TRAIN["n_layers"]
    bodies, warm, combos = _level_bodies()
    shm_body = {"user": "u%d" % combos[-1][0], "num": 7}
    want = []
    for lo in range(0, len(bodies), LOAD_BATCH_MAX):
        want += deployed.query_batch([from_wire(sessionrec.Query, b)
                                      for b in bodies[lo:lo + LOAD_BATCH_MAX]])
    rows, launches = [], 0
    for n in (1,) + sizes:
        pool = _PoolDeploy(pio, f"pool-{n}", engine_json, n, "--engine-instance-id",
                           instance_id, *POOL_FLAGS).wait()
        pools[n] = pool
        _closed_loop(pool.port, warm, POOL_CLIENTS)
        row = _pool_level(f"pool-{n}", pool, bodies, want)
        row["device_bytes_in_use"] = _pool_device_bytes(f"pool-{n}", pool)
        rows.append(row)
        if n == 1:
            launches += _pool_launch_identity("pool-1", pool, layers)
            pool.stop()
    PHASE27_ROWS[:] = rows
    _load_table("pool", rows + [r for r in PHASE17_ROWS if r["clients"] == POOL_CLIENTS
                                and r["batching"]])
    _pool_coherence(pools[sizes[0]])
    big = pools[sizes[-1]]
    _pool_shm(big, shm_body, layers)
    _pool_kernel_under_load(big, deployed, bodies[0])
    # the online pool's processes come up while a sibling respawns (the
    # respawn's seconds are taken beside their start)
    online.append(_pool_online_start(pio, rec_instance))
    launches += _kill_and_respawn(big, SEED + 28)
    for n in sizes:
        launches += _pool_launch_identity(f"pool-{n}", pools[n], layers)
    return launches


# ---------------------------------------------------------------------------
# Phase 28: the router tier in front of `pio deploy` replicas
# ---------------------------------------------------------------------------

#: the router's admin key (canary and experiment mutations, /stop)
ROUTER_KEY = "chip-smoke-router"
#: the closed-loop clients of the level (phase 27's 256 queries) and of
#: the canary's share
ROUTER_CLIENTS = 64
#: the canary's weight (percent) and the queries its share is read over
ROUTER_CANARY_WEIGHT, ROUTER_CANARY_QUERIES = 10.0, 1_000
#: the share's bound: 5 standard deviations of a binomial share
ROUTER_CANARY_SIGMAS = 5.0
#: clients of the failover's load; seconds a SIGKILLed replica may take
#: to be respawned, marked up and routed to again
ROUTER_FAILOVER_CLIENTS, ROUTER_RESPAWN_WAIT_S = 8, 120.0
#: seconds the replicas, the canary and the ALS deploy may take to be up
ROUTER_UP_WAIT_S = 180.0
#: the experiment's name and the queries it is driven with
ROUTER_EXPERIMENT, ROUTER_EXPERIMENT_QUERIES = "ab", 64
#: the ML-100k engine's name behind the router
ROUTER_ALS_ENGINE = "ml100k"
#: the supervisor's failed /healthz probes (0.5 s apart) before it
#: recycles a live replica as wedged: JAX's default, 10, is 5 s, less than
#: a `pio deploy` replica takes to import torch and listen on the card
#: (~8-11 s), so every replica would be killed while it boots
ROUTER_UNHEALTHY_AFTER = 60
#: the replicas' serving flags (phase 17's batched deploy, traced)
ROUTER_REPLICA_FLAGS = ("--batching", "--batch-max", str(LOAD_BATCH_MAX), "--tracing")
#: the evaluation instance phase 24's forked grid recorded (its two
#: scored points become the experiment's variants)
GRID_INSTANCE: list[str] = []
#: phase 27's C=64 rows, set beside the router's
PHASE27_ROWS: list[dict] = []


def _free_ports(n: int) -> int:
    """The first of ``n`` consecutive free loopback ports (the router's
    --replica-port-base allocates upward from it)."""
    import socket

    for _ in range(200):
        held: list = []
        try:
            probe = socket.socket()
            held.append(probe)
            probe.bind(("127.0.0.1", 0))
            base = probe.getsockname()[1]
            for port in range(base + 1, base + n):
                s = socket.socket()
                held.append(s)
                s.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for s in held:
                s.close()
    fail("no run of free ports for the router's replicas")


class _Router:
    """`pio router --supervise` as a process: its port, its /fleet doc,
    the replicas' addresses and pids from the supervisor's document."""

    def __init__(self, pio: _Pio, *flags: str):
        self.log_path = os.path.join(pio.base, "router.log")
        self.t0 = time.perf_counter()
        env = dict(pio.env, PIO_FLEET_UNHEALTHY_AFTER=str(ROUTER_UNHEALTHY_AFTER))
        with open(self.log_path, "w") as out:
            self.proc = subprocess.Popen(
                pio.cmd + ["router", "--ip", "127.0.0.1", "--port", "0",
                           "--router-key", ROUTER_KEY, *flags],
                cwd=pio.base, env=env, stdout=out, stderr=subprocess.STDOUT)
        deadline = time.monotonic() + 60
        while True:
            with open(self.log_path) as f:
                found = re.search(r"Fleet Router listening on 127\.0\.0\.1:(\d+)", f.read())
            if found:
                break
            if self.proc.poll() is not None or time.monotonic() > deadline:
                self.proc.kill()
                fail(f"[router] pio router did not come up:\n{self.text()[-3000:]}")
            time.sleep(0.02)
        self.port = int(found.group(1))
        self.listening_s = time.perf_counter() - self.t0

    def text(self) -> str:
        """The router's log and its replicas' output, without the scale
        sweep's scrape warnings (a replica that is not up yet)."""
        with open(self.log_path) as f:
            return "".join(line for line in f if "fleet scrape of" not in line)

    def fleet(self) -> dict:
        return _get(self.port, "/fleet")[1]

    def states(self) -> dict[str, str]:
        return {b["id"]: b["state"] for b in self.fleet()["backends"]}

    def children(self) -> dict[str, dict]:
        """Supervised replicas by address: {"pid", "state", "respawns"}."""
        return {c["address"]: c for c in self.fleet()["supervisor"]["children"]}

    def wait_up(self, addresses: list[str], tag: str) -> float:
        t0 = time.perf_counter()
        while True:
            if self.proc.poll() is not None:
                fail(f"[{tag}] pio router exited {self.proc.returncode}:\n"
                     f"{self.text()[-6000:]}")
            states = self.states()
            if all(states.get(a) == "up" for a in addresses):
                return time.perf_counter() - t0
            if time.perf_counter() - t0 > ROUTER_UP_WAIT_S:
                fail(f"[{tag}] backends not up within {ROUTER_UP_WAIT_S}s: {states}; "
                     f"supervisor {self.fleet().get('supervisor')}\n{self.text()[-6000:]}")
            time.sleep(0.1)


def _replica_counts(address: str) -> dict:
    """A replica's `_server_counts`, by its host:port."""
    return _server_counts(int(address.rsplit(":", 1)[1]))


def _replica_identity(tag: str, address: str, layers: int) -> int:
    """A replica's launches = n_layers x the popcounts of its batches, no
    build and no batch retry, on the card; returns its launches."""
    c = _replica_counts(address)
    want = _launches_for(c["hist"], layers)
    if c["launches"] != want or c["compiles"] or c["retries"] or \
            not c["device"].startswith("cuda"):
        fail(f"[{tag}] replica {address}: launches {c['launches']} (expected {want}), builds "
             f"{c['compiles']}, batch retries {c['retries']}, device {c['device']}")
    return c["launches"]


def _router_hops(port: int, trace_ids: set[str]) -> list[float]:
    """The router's own ms of each traced query in its ring: the root
    span's duration less its one attempt's (the forward to a replica)."""
    hops = []
    for doc in _get(port, "/traces.json")[1]["traces"]:
        attempts = [s for s in doc["spans"] if s["name"].startswith("attempt[")]
        if doc["traceId"] in trace_ids and len(attempts) == 1:
            hops.append(doc["durationMs"] - attempts[0]["durationMs"])
    return hops


def _router_level(tag: str, router: _Router, bodies: list[dict], want: list) -> dict:
    """Phase 17's C=64 level through the router: every answer 200 and
    equal to the in-process one within BATCH_SCORE_TOL; p50, p99,
    queries/s, and the router's own hop from its spans."""
    results, wall = _closed_loop(router.port, bodies, ROUTER_CLIENTS)
    bad = [(b, r[:2]) for b, r in zip(bodies, results) if r[0] != 200]
    if bad:
        fail(f"[{tag}] {len(bad)} routed queries failed, first {bad[0]}")
    for body, r, w in zip(bodies, results, want):
        if len(r[1]["itemScores"]) != body["num"] or not _same_answer(
                _as_result(r[1]), w, BATCH_SCORE_TOL):
            fail(f"[{tag}] a routed answer differs from the in-process one: "
                 f"{json.dumps(body)[:200]}")
    hops = _router_hops(router.port, {r[4] for r in results if r[4]})
    if not hops:
        fail(f"[{tag}] no traced query of the level in the router's ring")
    ms = [r[2] for r in results]
    row = dict(route="router", replicas=2, clients=ROUTER_CLIENTS, n=len(bodies),
               p50_ms=_quantile(ms, 0.5), p99_ms=_quantile(ms, 0.99), qps=len(bodies) / wall,
               hop_p50_ms=_quantile(hops, 0.5), hop_p99_ms=_quantile(hops, 0.99),
               hop_n=len(hops))
    log(f"[{tag}] 2 replicas behind the router, C={ROUTER_CLIENTS}: n={len(bodies)} "
        f"p50_ms={row['p50_ms']:.3f} p99_ms={row['p99_ms']:.3f} qps={row['qps']:.2f}; the "
        f"router's own hop over the last {len(hops)} traced queries: p50_ms="
        f"{row['hop_p50_ms']:.3f} p99_ms={row['hop_p99_ms']:.3f}; every answer equals the "
        f"in-process one (tol {BATCH_SCORE_TOL:g})")
    return row


def _router_als(router: _Router, als_port: int, rng) -> None:
    """The ML-100k engine behind the router answers as the deploy does
    when queried directly."""
    tag = "router-als"
    for body in _ml100k_queries(rng):
        got = _http(router.port, "POST", f"/engines/{ROUTER_ALS_ENGINE}/queries.json", body)
        direct = _http(als_port, "POST", "/queries.json", body)
        if got[0] != 200 or got[:2] != direct[:2]:
            fail(f"[{tag}] {body}: routed {got[:2]} against direct {direct[:2]}")
    log(f"[{tag}] 16 ML-100k queries at /engines/{ROUTER_ALS_ENGINE}/queries.json equal the "
        "direct deploy's answers")


def _router_status(pio: _Pio, router: _Router) -> None:
    """`pio status --router` (no storage, no torch) lists the default
    engine with its two replicas and the canary up, and the ML-100k
    engine with its one."""
    out, seconds = pio.run("router-status", "status", "--router", f"127.0.0.1:{router.port}")
    engines = dict(re.findall(r"\[INFO\]  [* ] (\S+): (.*)", out))
    log(f"[router-status] pio status --router ({seconds:.3f}s): {engines}")
    if "stable 2/2 up" not in engines.get("default", "") \
            or "canary 1/1 up" not in engines.get("default", "") \
            or "stable 1/1 up" not in engines.get(ROUTER_ALS_ENGINE, ""):
        fail(f"[router-status] the engine table: {out}")


def _router_canary(router: _Router, canary: str, rng) -> None:
    """Weight 10 over 1,000 queries, the observed share within its
    binomial bound; then promotion (weight 100): every query to the
    canary; then weight 0 again."""
    tag = "router-canary"

    def admin(doc: dict) -> dict:
        status, body, _ = _http(router.port, "POST", f"/fleet/canary?accessKey={ROUTER_KEY}",
                                doc)
        if status != 200:
            fail(f"[{tag}] POST /fleet/canary {doc}: {status} {body}")
        return body

    def share(n: int) -> float:
        bodies = [{"items": [f"i{i}" for i in rng.integers(1, N_ITEMS + 1, 64)], "num": 10}
                  for _ in range(n)]
        before = _replica_counts(canary)["requests"]
        results, _ = _closed_loop(router.port, bodies, ROUTER_CLIENTS)
        if any(r[0] != 200 for r in results):
            fail(f"[{tag}] statuses {sorted({r[0] for r in results})}")
        return (_replica_counts(canary)["requests"] - before) / n

    if _http(router.port, "POST", "/fleet/canary", {"weight": 10})[0] != 401:
        fail(f"[{tag}] the canary admin took a request without the router key")
    admin({"weight": ROUTER_CANARY_WEIGHT})
    p = ROUTER_CANARY_WEIGHT / 100
    bound = ROUTER_CANARY_SIGMAS * math.sqrt(p * (1 - p) / ROUTER_CANARY_QUERIES)
    got = share(ROUTER_CANARY_QUERIES)
    if abs(got - p) > bound:
        fail(f"[{tag}] canary share {got:.4f} outside {p} ± {bound:.4f}")
    snap = admin({"weight": 100})
    promoted = share(ROUTER_EXPERIMENT_QUERIES)
    if promoted != 1.0 or snap["weightPct"] != 100.0:
        fail(f"[{tag}] after promotion {promoted:.4f} of the queries reached the canary")
    admin({"weight": 0})
    log(f"[{tag}] weight {ROUTER_CANARY_WEIGHT:g}%: {got:.4f} of {ROUTER_CANARY_QUERIES} "
        f"queries reached the canary (bound {p} ± {bound:.4f}, {ROUTER_CANARY_SIGMAS:g} "
        f"binomial sigmas); promoted (weight 100): {promoted:.4f} of "
        f"{ROUTER_EXPERIMENT_QUERIES}; a request without the key refused (401)")


def _router_failover(router: _Router, victim: str, seed: int, layers: int) -> tuple[int, dict]:
    """SIGKILL one sessionrec replica while C=8 clients query through the
    router: no 5xx, retries counted, the supervisor respawns it and
    membership marks it up; the seconds from the kill to its first routed
    200. Returns the victim's launches (its launch identity held before
    the load, its count read just before the kill) and
    the numbers."""
    import http.client
    import signal
    import threading

    tag = "router-failover"
    codes: list[int] = []
    stop = threading.Event()

    def client(k: int) -> None:
        gen = np.random.default_rng(seed + k)
        conn = http.client.HTTPConnection("127.0.0.1", router.port, timeout=120)
        while not stop.is_set():
            body = {"items": [f"i{i}" for i in gen.integers(1, N_ITEMS + 1, 64)], "num": 10}
            try:
                conn.request("POST", "/queries.json", json.dumps(body).encode(),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                resp.read()
                codes.append(resp.status)
            except (OSError, http.client.HTTPException):
                codes.append(0)
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", router.port, timeout=120)
        conn.close()

    retries0 = router.fleet()["router"]["retries"]
    old = router.children()[victim]
    # the victim's batches so far, held while it is quiet: under load a
    # read of its launches and one of its batches can straddle a dispatch
    _replica_identity(tag, victim, layers)
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(ROUTER_FAILOVER_CLIENTS)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.5)
        victim_launches = _replica_counts(victim)["launches"]
        t_kill = time.perf_counter()
        os.kill(old["pid"], signal.SIGKILL)
        respawned = marked_up = None
        while True:
            child = router.children()[victim]
            if respawned is None and child.get("pid") not in (None, old["pid"]) \
                    and child["state"] == "running":
                respawned = time.perf_counter() - t_kill
            if respawned is not None and marked_up is None \
                    and router.states().get(victim) == "up":
                marked_up = time.perf_counter() - t_kill
            if marked_up is not None:
                try:
                    if _replica_counts(victim)["requests"] > 0:
                        first_200 = time.perf_counter() - t_kill
                        break
                except OSError:
                    pass
            if time.perf_counter() - t_kill > ROUTER_RESPAWN_WAIT_S:
                fail(f"[{tag}] the killed replica was not routed to again within "
                     f"{ROUTER_RESPAWN_WAIT_S}s: {router.children()[victim]}, "
                     f"{router.states()}")
            time.sleep(0.05)
        time.sleep(0.5)
    finally:
        stop.set()
        for t in threads:
            t.join()
    child = router.children()[victim]
    retries = router.fleet()["router"]["retries"] - retries0
    if set(codes) != {200} or retries < 1 or child["respawns"] < 1:
        fail(f"[{tag}] statuses {sorted(set(codes))} (a 0 is a client-side reset), retries "
             f"{retries}, respawns {child['respawns']}")
    row = dict(queries=len(codes), retries=retries, respawned_s=respawned,
               marked_up_s=marked_up, first_routed_200_s=first_200)
    log(f"[{tag}] SIGKILL of replica {victim} (pid {old['pid']}) under load at "
        f"C={ROUTER_FAILOVER_CLIENTS}: {len(codes)} queries, all 200, {retries} retries "
        f"on the other replica; respawned as pid {child['pid']} after {respawned:.3f}s, marked "
        f"up after {marked_up:.3f}s, first routed 200 {first_200:.3f}s after the kill")
    return victim_launches, row


def _router_experiment(pio: _Pio, router: _Router, replicas: list[str],
                       instance_id: str) -> None:
    """`pio experiment start` over an evaluation instance's two scored
    points, both variants on replicas of 16a's instance; stamped answers;
    attributed events into `pio eventserver` counted as conversions;
    `pio experiment conversions`, then `status`."""
    tag = "router-experiment"
    name = ROUTER_EXPERIMENT
    common = ["--router", f"127.0.0.1:{router.port}", "--router-key", ROUTER_KEY]
    out, _ = pio.run(tag, "experiment", "start", name, "--instance", instance_id,
                     "--top-k", "2", "--backends", replicas[0], "--backends", replicas[1],
                     "--ramp-s", "0", "--measure-s", "600", "--min-requests", "20", *common)
    if f"experiment {name} defined" not in out:
        fail(f"[{tag}] pio experiment start: {out[-2000:]}")
    rng = np.random.default_rng(SEED + 281)
    bodies = [{"items": [f"i{i}" for i in rng.integers(1, N_ITEMS + 1, 64)], "num": 5}
              for _ in range(ROUTER_EXPERIMENT_QUERIES)]
    results, _ = _closed_loop(router.port, bodies, ROUTER_FAILOVER_CLIENTS)
    stamps = [(r[1].get("experimentId"), r[1].get("variantId")) for r in results]
    variants = sorted({v for _, v in stamps})
    if any(r[0] != 200 for r in results) or {e for e, _ in stamps} != {name} \
            or len(variants) != 2:
        fail(f"[{tag}] statuses {sorted({r[0] for r in results})}, stamps {set(stamps)}")
    # attributed conversions: one buy per answer of the first variant,
    # one per second answer of the other
    app_out, _ = pio.run(tag, "app", "new", "ConvApp")
    app_id = int(re.search(r"ID: (\d+)", app_out).group(1))
    key = re.search(r"Access Key: (\S+)", app_out).group(1)
    es_proc, es_port, _ = pio.eventserver(tag, "--stats")
    try:
        sent: dict[str, int] = {}
        docs = []
        for j, (experiment, variant) in enumerate(stamps):
            if variant == variants[1] and j % 2:
                continue
            sent[variant] = sent.get(variant, 0) + 1
            docs.append({"event": "buy", "entityType": "user", "entityId": f"c{j}",
                         "targetEntityType": "item", "targetEntityId": f"i{j + 1}",
                         "properties": {"experimentId": experiment, "variantId": variant}})
        for lo in range(0, len(docs), 50):       # the server's batch cap
            status, body, _ = _http(es_port, "POST", f"/batch/events.json?accessKey={key}",
                                    docs[lo:lo + 50])
            if status != 200 or any(r["status"] != 201 for r in body):
                fail(f"[{tag}] the attributed events: {status} {str(body)[:300]}")
        families = parse_prometheus(_request(es_port, "GET", "/metrics")[1].decode())
        ingested = {re.search(r'variant="([^"]+)"', labels).group(1): value for labels, value
                    in families["pio_experiment_conversions_ingested_total"][1]}
        if ingested != {v: float(n) for v, n in sent.items()}:
            fail(f"[{tag}] conversions ingested {ingested}, sent {sent}")
    finally:
        _stop(es_proc)
    conv_out, _ = pio.run(tag, "experiment", "conversions", name, "--appid", str(app_id),
                          *common)
    status_out, _ = pio.run(tag, "experiment", "status", *common)
    snap = _get(router.port, "/fleet/experiments")[1]["experiment"]
    got = {v["name"]: v["conversions"] for v in snap["variants"]}
    if got != sent or f"folded {sum(sent.values())} conversion(s)" not in conv_out \
            or any(f"{n} conv" not in status_out for n in sent.values()):
        fail(f"[{tag}] router conversions {got}, sent {sent}:\n{conv_out}\n{status_out}")
    log(f"[{tag}] pio experiment start over evaluation instance {instance_id}: variants "
        f"{variants}; {len(results)} bare queries all stamped with experimentId/variantId "
        f"(per variant {({v: [s for _, s in stamps].count(v) for v in variants})}); "
        f"attributed buys {sent} counted by pio_experiment_conversions_ingested_total and "
        f"folded by pio experiment conversions; status:")
    for line in status_out.strip().splitlines():
        log(f"[{tag}]   {line}")


def _router_trace(pio: _Pio, router: _Router) -> None:
    """`pio trace <id>` of one routed query: a stitched tree from the
    router's root span down to a replica's batcher.device_dispatch."""
    tag = "router-trace"
    status, _, headers = _request(router.port, "POST", "/queries.json",
                                  {"user": "u3", "num": 10})
    trace_id = headers.get("X-PIO-Trace-Id")
    if status != 200 or not trace_id:
        fail(f"[{tag}] the routed query: {status}, trace id {trace_id}")
    deadline = time.monotonic() + 10
    while True:
        p = subprocess.run(pio.cmd + ["trace", trace_id, "--router",
                                      f"127.0.0.1:{router.port}"],
                           cwd=pio.base, env=pio.env, capture_output=True, text=True,
                           timeout=60)
        if p.returncode == 0 and "batcher.device_dispatch" in p.stdout:
            break
        if time.monotonic() > deadline:
            fail(f"[{tag}] pio trace {trace_id}: exit {p.returncode}\n{p.stdout[-3000:]}\n"
                 f"{p.stderr[-2000:]}")
        time.sleep(0.2)
    lines = p.stdout.rstrip().splitlines()
    root, dispatch = lines[1], next(line for line in lines if "batcher.device_dispatch" in line)
    if "[router]" not in root or "attempt[" not in p.stdout:
        fail(f"[{tag}] the tree does not start at the router's root span:\n{p.stdout}")
    log(f"[{tag}] pio trace {trace_id}: {len(lines)} lines from the router's root "
        f"({root.strip()[:120]}) to the replica's ({dispatch.strip()[:120]})")
    for line in lines:
        log(f"[{tag}]   {line}")


def _router_scrapes(router: _Router, replicas: list[str]) -> None:
    """/fleet/metrics folds both replicas' families, labelled per
    replica; the dry-run controller exports pio_fleet_desired_replicas."""
    tag = "router-scrapes"
    fleet = parse_prometheus(_request(router.port, "GET", "/fleet/metrics")[1].decode())
    own = parse_prometheus(_request(router.port, "GET", "/metrics")[1].decode())
    for address in replicas:
        label = f'replica="{address}"'
        if not any(label in labels
                   for labels, _ in fleet["pio_serving_device_dispatch_seconds"][1]):
            fail(f"[{tag}] /fleet/metrics has no pio_serving_device_dispatch_seconds of "
                 f"{address}")
        if not any(label in labels and value == 1.0
                   for labels, value in fleet["pio_fleet_scrape_ok"][1]):
            fail(f"[{tag}] /fleet/metrics: scrape of {address} not ok")
    if "pio_fleet_desired_replicas" not in own or "pio_fleet_pressure" not in fleet:
        fail(f"[{tag}] /metrics lacks pio_fleet_desired_replicas or /fleet/metrics "
             "pio_fleet_pressure")
    serving = sorted(n for n in fleet if n.startswith("pio_serving_"))
    log(f"[{tag}] /fleet/metrics folds {len(fleet)} families ({len(serving)} pio_serving_*) "
        f"of both replicas, labelled replica=; pio_fleet_pressure "
        f"{fleet['pio_fleet_pressure'][1]}; /metrics pio_fleet_desired_replicas "
        f"{own['pio_fleet_desired_replicas'][1]} (dry run)")


def _router_kernel_under_load(router: _Router, deployed, body: dict) -> dict:
    """The flash kernel on a served query's q/k/v, timed in this process
    while the router's replicas serve full-length sessions at C=64."""
    load = subprocess.Popen([sys.executable, "-c", _POOL_LOAD, str(router.port), "3",
                             str(ROUTER_CLIENTS), str(N_ITEMS)])
    try:
        time.sleep(1.5)
        row = _kernel_at_deploy(deployed, body)
    finally:
        load.wait(timeout=60)
    log(f"[router-kernel] flash kernel at {row['shape']} {row['dtype']} (real keys "
        f"{row['real_keys']}) beside 2 replicas behind the router under load: "
        f"ms={row['ms']:.4f} device_ms={_fmt(row['device_ms'], 4)} "
        f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
        f"library_causal_ms={row['library_causal_ms']:.4f} bound_ms={row['bound_ms']:.5f} "
        f"({row['bound_by']})")
    return row


def phase_router(pio: _Pio, instance_id: str, engine_json: str,
                 rec_instance: tuple[str, str], eval_instance: str) -> int:
    """Phase 28: `pio router --supervise --tracing` over two `pio deploy`
    replicas of 16a's instance (the --replica-cmd template, batched and
    traced), a third one as the canary, and 16b's ML-100k instance as a
    second engine. Returns the replicas' flash launches."""
    t0 = time.perf_counter()
    tag = "router"
    layers = PIO_SESSION_TRAIN["n_layers"]
    rec_json, rec_id = rec_instance
    storage = Storage({"PIO_FS_BASEDIR": pio.env["PIO_FS_BASEDIR"]})
    deployed = load_deployed_engine(storage, ServerConfig(engine_instance_id=instance_id,
                                                          device=DEVICE))
    bodies, warm, _ = _level_bodies()
    want = []
    for lo in range(0, len(bodies), LOAD_BATCH_MAX):
        want += deployed.query_batch([from_wire(sessionrec.Query, b)
                                      for b in bodies[lo:lo + LOAD_BATCH_MAX]])
    procs = []
    router = None
    try:
        # the canary, the ML-100k deploy and the router's replicas start
        # together, on ports chosen here
        base = _free_ports(4)
        replicas = [f"127.0.0.1:{base}", f"127.0.0.1:{base + 1}"]
        canary, als_port = f"127.0.0.1:{base + 2}", base + 3
        started = [pio.start_deploy(f"{tag}-canary", engine_json, "--engine-instance-id",
                                    instance_id, "--port", str(base + 2),
                                    *ROUTER_REPLICA_FLAGS),
                   pio.start_deploy(f"{tag}-als", rec_json, "--engine-instance-id", rec_id,
                                    "--port", str(als_port))]
        procs += [proc for proc, _, _ in started]
        replica_cmd = shlex.join(pio.cmd + [
            "deploy", "--engine-json", engine_json, "--engine-instance-id", instance_id,
            "--ip", "127.0.0.1", "--port", "{port}", "--device", DEVICE,
            *ROUTER_REPLICA_FLAGS])
        router = _Router(pio, "--supervise", "--tracing", "--replica-cmd", replica_cmd,
                         "--replicas", "2", "--replica-port-base", str(base),
                         "--canary-backend", canary,
                         "--engine", f"name={ROUTER_ALS_ENGINE},backend=127.0.0.1:{als_port}")
        for name, (proc, out_path, t_start) in zip(("canary", "als"), started):
            pio.wait_listening(f"{tag}-{name}", proc, out_path, t_start)
        up_s = router.wait_up(replicas + [canary, f"127.0.0.1:{als_port}"], tag)
        text = router.text()
        if "DRY-RUN" not in text or "supervised" not in text:
            fail(f"[{tag}] the router's banner: {text[-2000:]}")
        log(f"[{tag}] pio router --supervise: listening after {router.listening_s:.3f}s; both "
            f"--replica-cmd replicas, the canary and the ML-100k deploy marked up "
            f"{up_s:.3f}s after the deploys listened")
        _closed_loop(router.port, warm, ROUTER_CLIENTS)
        row = _router_level(tag, router, bodies, want)
        pool2 = [r for r in PHASE27_ROWS if r["workers"] == 2]
        _load_table(tag, [row] + pool2)
        if pool2:
            log(f"[{tag}] queries/s of 2 routed replicas against phase 27's 2-worker pool: "
                f"{row['qps'] / pool2[0]['qps']:.3f}x")
        _router_kernel_under_load(router, deployed, bodies[0])
        _router_als(router, als_port, np.random.default_rng(SEED + 282))
        _router_status(pio, router)
        _router_canary(router, canary, np.random.default_rng(SEED + 283))
        victim_launches, failover = _router_failover(router, replicas[0], SEED + 284, layers)
        _router_trace(pio, router)
        _router_experiment(pio, router, replicas, eval_instance)
        _router_scrapes(router, replicas)
        probes: dict[str, tuple] = {}
        for b in router.fleet()["backends"]:     # the default engine's groups first
            probes.setdefault(b["id"], (b["transitions"], b["probeStarved"]))
        launches = victim_launches + sum(_replica_identity(tag, a, layers)
                                         for a in replicas + [canary])
        log(f"[{tag}] probes: (state transitions, starved probe timeouts) per backend "
            f"{probes}; flash launches of the sessionrec replicas (the killed one read before "
            f"the kill) {launches}, each = {layers} x popcount of its batches, no build")
        pids = [c["pid"] for c in router.children().values()]
    finally:
        # the router drains and stops its replicas; the rest stop beside it
        _stop_all(([router.proc] if router is not None else []) + procs)
        del deployed
        storage.close()
        torch.cuda.empty_cache()
    alive = [p for p in pids if os.path.exists(f"/proc/{p}")]
    if router.proc.returncode != 0 or alive:
        fail(f"[{tag}] pio router exited {router.proc.returncode}; replicas left alive "
             f"{alive}")
    log(f"[{tag}] SIGTERM of pio router stopped it (exit 0) and its supervised replicas "
        f"{pids}; failover {json.dumps(failover)}")
    log(f"[{tag}] phase 28 took {time.perf_counter() - t0:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# phase 29: remote storage and the admin tools
# ---------------------------------------------------------------------------

#: phase 29's users of 16a's walk, cut from 128: every event crosses the
#: PostgreSQL wire twice (the import, the cleaning's rewrite) to an
#: emulator in this process (2.6 k events/s on the card's host); the
#: widths and the engine stay (two Adam steps at batch 8)
STORAGE_USERS = 12
#: the nums of the level's (user, num) queries: 12 users x 6 nums give
#: the 68 distinct pairs the warm-up and the C=8 level draw
STORAGE_NUMS = (5, 10, 15, 20, 25, 30)
#: exact copies of random view events; (items, $set events an item)
STORAGE_DUPLICATES = 1_000
STORAGE_SET_RUNS = (50, 8)
STORAGE_FAULT_RATE = 0.2
STORAGE_SEED = SEED + 29
#: phase 17's C=8 level: 128 distinct queries
STORAGE_CLIENTS = 8
STORAGE_QUERIES = LOAD_CLIENTS[STORAGE_CLIENTS]
PG_PASSWORD = "chip-smoke-pg"
S3_BUCKET, S3_BASE_PATH = "pio-models", "models"
S3_KEYS = ("AKIDCHIPSMOKE", "chip-smoke-secret")
#: the users of `--storage-only`'s own `pio eval` (phase 24's grid points)
STORAGE_EVAL_USERS = 16
#: the items 16a's walk gives the phase's users
STORAGE_ITEMS = PIO_SESSION[2] * (STORAGE_USERS - 1) + PIO_SESSION[1]

#: the `pio run` main of phase 29's cleaning, written beside the store
STORAGE_CLEAN_MAIN = '''\
"""pio run storage_clean APP_ID: the self-cleaning data source over the
configured event store (duplicates removed, $set runs compressed), then
each user's events read back; prints one JSON line."""
import json
import sys
import time


def main(app_id, n_users):
    from predictionio_tpu_torch.data.self_cleaning import EventWindow, SelfCleaningDataSource
    from predictionio_tpu_torch.storage.base import EventFilter
    from predictionio_tpu_torch.storage.registry import Storage

    class Cleaner(SelfCleaningDataSource):
        event_window = EventWindow(remove_duplicates=True, compress_properties=True)

    app_id = int(app_id)
    storage = Storage.default()
    t0 = time.perf_counter()
    kept = Cleaner().clean_persisted_events(storage, app_id)
    seconds = time.perf_counter() - t0
    events = storage.get_events()
    users = [f"u{u}" for u in range(int(n_users))]
    by_user = sum(len(list(events.find(app_id, None, EventFilter(
        entity_type="user", entity_id=u)))) for u in users)
    injector = storage.client_for_source("CHAOS").injector
    print(json.dumps({"kept": kept, "seconds": seconds, "by_user": by_user,
                      "calls": injector.calls,
                      "faults": injector.faults_injected, "torch": "torch" in sys.modules}),
          flush=True)
    return 0
'''


class _BlobSeqRec(sessionrec.SeqRecAlgorithm):
    """The template's algorithm, persisting the trained model itself into
    the MODELDATA repository (its tensors as host arrays, put back on the
    deploy's device at load) instead of a local checkpoint behind a
    manifest: phase 29's S3 blob carries the weights trained on the card."""

    def make_persistent_model(self, ctx, model):
        return dataclasses.replace(model, module=None, train_run=None)


def storage_engine_factory():
    """Phase 29's engine: the sessionrec template with ``_BlobSeqRec``."""
    engine = sessionrec.engine_factory()
    engine.algorithm_class_map = {"seqrec": _BlobSeqRec}
    return engine


def storage_engine_json(pio: _Pio) -> str:
    """Phase 29's engine.json: 16a's (SessApp, PIO_SESSION_TRAIN) through
    ``storage_engine_factory``; its path."""
    engine_json = os.path.join(pio.base, "storage-engine.json")
    with open(engine_json, "w") as f:
        json.dump({"id": "sessionrec-s3", "engineFactory": "chip_smoke.storage_engine_factory",
                   "datasource": {"params": {"app_name": "SessApp"}},
                   "algorithms": [{"name": "seqrec", "params": PIO_SESSION_TRAIN}]}, f)
    return engine_json


class _FakeS3Handler(BaseHTTPRequestHandler):
    """Path-style objects in memory. A request without an
    ``AWS4-HMAC-SHA256`` Authorization header is refused (403), and a
    PUT whose body does not hash to its ``x-amz-content-sha256`` (400)."""

    objects: dict = None       # path -> bytes, set per server by _fake_s3
    requests: list = None      # (method, path) of every request, likewise

    def log_message(self, *args) -> None:
        pass

    def _reply(self, code: int, body: bytes = b"", length: int | None = None) -> None:
        self.send_response(code)
        self.send_header("Content-Length", str(len(body) if length is None else length))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _signed(self) -> bool:
        self.requests.append((self.command, self.path))
        if self.headers.get("Authorization", "").startswith("AWS4-HMAC-SHA256 Credential="):
            return True
        self._reply(403)
        return False

    def do_PUT(self) -> None:
        if self._signed():
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            if hashlib.sha256(body).hexdigest() != self.headers.get("x-amz-content-sha256"):
                return self._reply(400)
            self.objects[self.path] = body
            self._reply(200)

    def do_GET(self) -> None:
        if self._signed():
            blob = self.objects.get(self.path)
            self._reply(404) if blob is None else self._reply(200, blob)

    def do_HEAD(self) -> None:
        if self._signed():
            blob = self.objects.get(self.path)
            self._reply(404) if blob is None else self._reply(200, length=len(blob))

    def do_DELETE(self) -> None:
        if self._signed():
            self._reply(204 if self.objects.pop(self.path, None) is not None else 404)


def _fake_s3() -> ThreadingHTTPServer:
    server = ThreadingHTTPServer(("127.0.0.1", 0), type(
        "S3Handler", (_FakeS3Handler,), {"objects": {}, "requests": []}))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _pg_emulator(password: str):
    """tests/pg_emulator.PGEmulator (stdlib only), loaded by its path and
    started; md5 authentication."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "pg_emulator.py")
    spec = importlib.util.spec_from_file_location("pg_emulator", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.PGEmulator(password=password, auth="md5").start()


def _storage_env(pg_port: int, s3_port: int) -> dict:
    """METADATA in PostgreSQL, EVENTDATA through the fault injector over
    the same database, MODELDATA in S3."""
    pg = {"HOST": "127.0.0.1", "PORT": str(pg_port), "USERNAME": "pio",
          "PASSWORD": PG_PASSWORD, "DATABASE": "pio"}
    return {"PIO_STORAGE_SOURCES_PG_TYPE": "postgres",
            **{f"PIO_STORAGE_SOURCES_PG_{k}": v for k, v in pg.items()},
            "PIO_STORAGE_SOURCES_CHAOS_TYPE": "chaos",
            "PIO_STORAGE_SOURCES_CHAOS_TARGET": "postgres",
            **{f"PIO_STORAGE_SOURCES_CHAOS_TARGET_{k}": v for k, v in pg.items()},
            "PIO_STORAGE_SOURCES_CHAOS_FAULT_RATE": str(STORAGE_FAULT_RATE),
            "PIO_STORAGE_SOURCES_CHAOS_SEED": str(STORAGE_SEED),
            "PIO_STORAGE_SOURCES_S3_TYPE": "s3",
            "PIO_STORAGE_SOURCES_S3_BUCKET_NAME": S3_BUCKET,
            "PIO_STORAGE_SOURCES_S3_BASE_PATH": S3_BASE_PATH,
            "PIO_STORAGE_SOURCES_S3_ENDPOINT": f"http://127.0.0.1:{s3_port}",
            "PIO_STORAGE_SOURCES_S3_ACCESS_KEY_ID": S3_KEYS[0],
            "PIO_STORAGE_SOURCES_S3_SECRET_ACCESS_KEY": S3_KEYS[1],
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "PG",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "CHAOS",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "S3"}


def _storage_docs(rng) -> tuple[list[dict], list[dict], list[dict]]:
    """Phase 29's events: (16a's views of STORAGE_USERS users, exact
    copies of STORAGE_DUPLICATES of them, runs of $set on items)."""
    views = list(_session_docs(range(STORAGE_USERS)))
    dups = [views[int(i)] for i in rng.integers(0, len(views), STORAGE_DUPLICATES)]
    items, run = STORAGE_SET_RUNS
    t0 = datetime(2026, 2, 1, tzinfo=timezone.utc)
    sets = [{"event": "$set", "entityType": "item", "entityId": f"i{i + 1}",
             "properties": {"price": float(k * 10 + i), "category": f"c{(i + k) % 5}"},
             "eventTime": (t0 + timedelta(minutes=k, seconds=i)).strftime(
                 "%Y-%m-%dT%H:%M:%S.000Z")}
            for k in range(run) for i in range(items)]
    return views, dups, sets


def _storage_import(tag: str, pio: _Pio, docs: list[dict]) -> tuple[int, float]:
    """`pio app new` + `pio import` over the remote stores: (app id,
    import seconds)."""
    app_id = pio.new_app(tag, "SessApp")
    path = os.path.join(pio.base, "storage-events.jsonl")
    n = _write_json_lines(path, docs)
    out, seconds = pio.run(tag, "import", "--appid", str(app_id), "--input", path)
    if f"Imported {n} events" not in out:
        fail(f"[{tag}] import: {out}")
    return app_id, seconds


def _storage_clean(tag: str, pio: _Pio, app_id: int, views: list, sets: list) -> dict:
    """`pio run` of the cleaning main, then the events read back through
    the fault injector: the exact count, every view once, one folded
    $set an item."""
    with open(os.path.join(pio.base, "storage_clean.py"), "w") as f:
        f.write(STORAGE_CLEAN_MAIN)
    out, seconds = pio.run(tag, "run", "storage_clean", str(app_id), str(STORAGE_USERS))
    report = json.loads(out.strip().splitlines()[-1])
    items, run = STORAGE_SET_RUNS
    expected = len(views) + items
    storage = Storage(pio.env)
    try:
        events = list(storage.get_events().find(app_id))
        injector = storage.client_for_source("CHAOS").injector
        reader = (injector.calls, injector.faults_injected)
    finally:
        storage.close()
    got_views = sorted(repr(_event_fields(e)) for e in events if e.event == "view")
    want_views = sorted(repr(_doc_fields(d)) for d in views)
    folded = {e.entity_id: dict(e.properties.fields) for e in events if e.event == "$set"}
    want_folded = {d["entityId"]: d["properties"] for d in sets[-items:]}
    log(f"[{tag}] pio run storage_clean: {seconds:.3f}s ({report['seconds']:.3f}s cleaning); "
        f"kept {report['kept']} of {STORAGE_DUPLICATES + len(views) + items * run} imported; "
        f"read back {report['by_user']} user by user in that process, {len(events)} whole "
        f"in this one (expected {expected}, {len(views)} views); faults injected "
        f"{report['faults']} of "
        f"{report['calls']} calls in the cleaning process, {reader[1]} of {reader[0]} in "
        f"this reader; torch loaded: {report['torch']}")
    if {report["kept"], len(events)} != {expected} or report["by_user"] != len(views) \
            or got_views != want_views or folded != want_folded or report["faults"] == 0 \
            or report["torch"]:
        fail(f"[{tag}] cleaning: kept {report['kept']}, read {len(events)} (expected "
             f"{expected}), by user {report['by_user']}, views equal "
             f"{got_views == want_views}, $set folded {folded == want_folded}, faults "
             f"{report['faults']}, torch {report['torch']}")
    return dict(report, seconds=seconds, read_back=len(events))


def _storage_blob(tag: str, s3: ThreadingHTTPServer, env: dict, instance_id: str) -> bytes:
    """The instance's model blob: in the fake S3 under the instance id
    the COMPLETED row in PostgreSQL names, its envelope's SHA-256 right,
    and the S3 client's GET equal to the bytes the PUT delivered."""
    storage = Storage(env)
    try:
        row = storage.get_meta_data_engine_instances().get(instance_id)
        fetched = storage.get_model_data_models().get(instance_id).models
    finally:
        storage.close()
    key = f"/{S3_BUCKET}/{S3_BASE_PATH}/{instance_id}"
    stored = s3.RequestHandlerClass.objects.get(key)
    header = len(b"PIOM\x01") + 32
    digest_ok = stored is not None and hashlib.sha256(stored[header:]).digest() == \
        stored[len(b"PIOM\x01"):header]
    log(f"[{tag}] model blob {key}: {len(stored or b'')} bytes, row {row and row.status}, "
        f"envelope SHA-256 {'right' if digest_ok else 'WRONG'}, sha256 "
        f"{hashlib.sha256(stored or b'').hexdigest()[:16]}, fetched back equal "
        f"{fetched == stored}")
    if row is None or row.status != "COMPLETED" or not digest_ok or fetched != stored:
        fail(f"[{tag}] the blob of {instance_id} is not in S3 as the row records it")
    return fetched


def _storage_serve(tag: str, pio: _Pio, s3: ThreadingHTTPServer, engine_json: str,
                   instance_id: str, while_booting) -> tuple[int, float]:
    """`pio deploy --batching` from the S3 blob (``while_booting()`` runs
    while it starts), phase 17's C=8 level of queries over the phase's
    users and items, each answer against an in-process deploy of the blob
    fetched back from S3; the server's launches = 4 x the popcounts of
    its batches, no build. Returns (launches, seconds to listening)."""
    layers = PIO_SESSION_TRAIN["n_layers"]
    gets = len([r for r in s3.RequestHandlerClass.requests if r[0] == "GET"])
    started = pio.start_deploy(tag, engine_json, "--engine-instance-id", instance_id,
                               "--batching", "--batch-max", str(LOAD_BATCH_MAX))
    try:
        while_booting()
    except BaseException:
        _stop(started[0])
        raise
    proc, port, deploy_s = pio.wait_listening(tag, *started)
    try:
        fetched = len([r for r in s3.RequestHandlerClass.requests if r[0] == "GET"]) - gets
        storage = Storage(pio.env)
        deployed = load_deployed_engine(storage, ServerConfig(engine_instance_id=instance_id,
                                                              device=DEVICE))
        rng = np.random.default_rng(STORAGE_SEED + 1)
        combos = [(u, num) for u in range(STORAGE_USERS) for num in STORAGE_NUMS]
        rng.shuffle(combos)
        warm = _sess_mix(rng, 8, combos, STORAGE_ITEMS)
        bodies = _sess_mix(rng, STORAGE_QUERIES, combos, STORAGE_ITEMS)
        want = []
        for lo in range(0, len(bodies), LOAD_BATCH_MAX):
            want += deployed.query_batch([from_wire(sessionrec.Query, b)
                                          for b in bodies[lo:lo + LOAD_BATCH_MAX]])
        _closed_loop(port, warm, 1)
        row = _drive_level(tag, port, bodies, STORAGE_CLIENTS, True)
        for body, doc, w in zip(bodies, row["answers"], want):
            if len(doc["itemScores"]) != body["num"] or not _same_answer(
                    _as_result(doc), w, BATCH_SCORE_TOL):
                fail(f"[{tag}] an answer differs from the blob deployed in this process: "
                     f"{json.dumps(body)[:200]}")
        c = _server_counts(port)
        expected = _launches_for(c["hist"], layers)
        log(f"[{tag}] every answer within {BATCH_SCORE_TOL:g} of the blob fetched back from "
            f"S3 and deployed here; the deploy's S3 GETs {fetched}; kernelLaunches."
            f"flash_attention={c['launches']} (expected {expected} = {layers} x popcount of "
            f"batches {c['hist']}); builds {c['compiles']}; batch retries {c['retries']}")
        if c["launches"] != expected or c["compiles"] or c["retries"] or fetched < 1 \
                or not c["device"].startswith("cuda"):
            fail(f"[{tag}] launches {c['launches']} != {expected}, builds {c['compiles']}, "
                 f"retries {c['retries']}, S3 GETs {fetched}, device {c['device']}")
        at = _kernel_at_deploy(deployed, next(b for b in bodies if "user" in b))
        log(f"[{tag}] flash_attention as launched behind the S3-loaded deploy {at['shape']} "
            f"{at['dtype']} causal, {at['real_keys']} real keys, {LAUNCHES_TIMED} launches: "
            f"kernel_ms={at['ms']:.4f} kernel_device_ms={_fmt(at['device_ms'], 4)} "
            f"plain_ms={at['plain_ms']:.4f} library_ms={at['library_ms']:.4f} "
            f"library_causal_ms={at['library_causal_ms']:.4f} "
            f"bound_ms={at['bound_ms']:.5f} ({at['bound_by']})")
        model = deployed.models[0]
        body = bodies[0]
        agreement = _check_against_plain(
            model, _sess_tail(model, body),
            [model.item_index[i] for i in body.get("blackList", [])],
            [(model.item_index[s["item"]], s["score"]) for s in row["answers"][0]["itemScores"]],
            min(10, body["num"]), f"{tag} {json.dumps(body)[:40]}")
        log(f"[{tag}] the first served answer against the plain attention: {agreement}")
        storage.close()
        del deployed, model
    finally:
        _stop(proc)
    torch.cuda.empty_cache()
    return c["launches"], deploy_s


def _storage_admin(tag: str, pio: _Pio) -> None:
    """`pio adminserver` over the PostgreSQL metadata: alive, an app made
    and listed (and by `pio app list`), its data and then itself deleted."""
    proc, port, listen_s = pio.server(tag, "adminserver")
    try:
        name = "StorageAdmin"
        call = lambda method, path, body=None: _http(port, method, path, body)[:2]  # noqa: E731
        checks = [("GET /", call("GET", "/")),
                  ("POST /cmd/app", call("POST", "/cmd/app", {"name": name}))]
        listed = call("GET", "/cmd/app")
        out, _ = pio.run(tag, "app", "list")
        checks += [("GET /cmd/app", listed),
                   ("DELETE data", call("DELETE", f"/cmd/app/{name}/data")),
                   ("DELETE app", call("DELETE", f"/cmd/app/{name}"))]
        after = call("GET", "/cmd/app")
    finally:
        _stop(proc)
    names = [a["name"] for a in listed[1]["apps"]]
    log(f"[{tag}] pio adminserver: listening after {listen_s:.3f}s; "
        + "; ".join(f"{what} {status}" for what, (status, _) in checks)
        + f"; apps listed {names}, then {[a['name'] for a in after[1]['apps']]}; "
        f"pio app list names it: {name in out}")
    if [s for _, (s, _) in checks] != [200, 201, 200, 200, 200] \
            or checks[0][1][1] != {"status": "alive"} or name not in names \
            or name not in out or name in [a["name"] for a in after[1]["apps"]]:
        fail(f"[{tag}] the admin server's checks: {checks}, {after}, app list {out}")


def _storage_dashboard(tag: str, pio: _Pio, instance_id: str) -> None:
    """`pio dashboard` over ``pio``'s store: the index lists the
    evaluation instance, its evaluator_results.json equals the stored
    row's, and /metrics answers."""
    storage = Storage({"PIO_FS_BASEDIR": pio.env["PIO_FS_BASEDIR"]})
    row = storage.get_meta_data_evaluation_instances().get(instance_id)
    storage.close()
    proc, port, listen_s = pio.server(tag, "dashboard")
    try:
        index = _request(port, "GET", "/")
        results = _request(port, "GET",
                           f"/engine_instances/{instance_id}/evaluator_results.json")
        metrics = _request(port, "GET", "/metrics")
        preflight = _request(port, "OPTIONS", "/")
    finally:
        _stop(proc)
    same = results[0] == 200 and json.loads(results[1]) == json.loads(
        row.evaluator_results_json)
    log(f"[{tag}] pio dashboard: listening after {listen_s:.3f}s; GET / {index[0]} lists "
        f"{instance_id}: {instance_id in index[1].decode()}; evaluator_results.json "
        f"{results[0]}, equal to the row's: {same}; /metrics {metrics[0]} "
        f"({len(metrics[1])} bytes); OPTIONS / {preflight[0]} "
        f"Access-Control-Max-Age {preflight[2].get('Access-Control-Max-Age')}")
    if index[0] != 200 or instance_id not in index[1].decode() or not same \
            or metrics[0] != 200 or b"pio_server_info" not in metrics[1] \
            or preflight[0] != 200:
        fail(f"[{tag}] the dashboard's checks failed")


def _retired_commands(tag: str, pio: _Pio) -> None:
    """`pio upgrade` and `pio template` exit 1 with JAX's messages."""
    upgrade, _ = pio.run(tag, "upgrade", expect=1)
    template, _ = pio.run(tag, "template", "list", expect=1)
    log(f"[{tag}] pio upgrade: exit 1, {upgrade.strip()!r}; pio template list: exit 1, "
        f"{template.strip().splitlines()[0]!r}")
    if upgrade.strip() != "[ERROR] Upgrade is no longer supported" or \
            not template.startswith("[ERROR] template commands are no longer supported."):
        fail(f"[{tag}] the retired commands' messages: {upgrade!r} {template!r}")


def phase_storage(pio_main: _Pio, base: str, eval_instance: str,
                  sqlite_import: tuple[int, float] | None) -> int:
    """Phase 29: 16a's sessions in PostgreSQL (over the wire, under 20 %
    seeded faults) with duplicates and $set runs, cleaned by a `pio run`
    main, trained on the card, the blob in S3, served through the flash
    kernel; the admin server over the same metadata, the dashboard over
    ``pio_main``'s store and ``eval_instance``, the retired commands.
    Returns the deploy's flash launches."""
    t0 = time.perf_counter()
    tag = "storage"
    emulator, s3 = _pg_emulator(PG_PASSWORD), _fake_s3()
    try:
        urllib.request.urlopen(f"http://127.0.0.1:{s3.server_address[1]}/{S3_BUCKET}/x",
                               timeout=10)
        fail(f"[{tag}] the fake S3 answered an unsigned GET")
    except urllib.error.HTTPError as e:
        if e.code != 403:
            fail(f"[{tag}] the fake S3 answered an unsigned GET with {e.code}")
    pio = _Pio(os.path.join(base, "storage"))
    os.makedirs(pio.base, exist_ok=True)
    pio.env.update(_storage_env(emulator.port, s3.server_address[1]))
    try:
        views, dups, sets = _storage_docs(np.random.default_rng(STORAGE_SEED))
        docs = views + dups + sets
        # `pio build` reads no storage: it runs beside the import
        engine_json = storage_engine_json(pio)
        build = subprocess.Popen(pio.cmd + ["build", "--engine-json", engine_json],
                                 cwd=pio.base, env=pio.env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
        app_id, import_s = _storage_import(tag, pio, docs)
        built = build.communicate(timeout=PIO_STEP_TIMEOUT)[0]
        log(f"[{tag}] pio build (beside the import): exit {build.returncode}, "
            f"{built.strip().splitlines()[-1] if built.strip() else ''}")
        if build.returncode != 0 or "[INFO] Build successful" not in built:
            fail(f"[{tag}] pio build: {built[-3000:]}")
        versus = ("" if sqlite_import is None else
                  f"; phase 16a's sqlite import {sqlite_import[0] / sqlite_import[1]:.1f} "
                  f"events/s")
        log(f"[{tag}] pio import of {len(docs)} events ({len(views)} views of "
            f"{STORAGE_USERS} users, {len(dups)} exact copies, {len(sets)} $set) into "
            f"PostgreSQL through the fault injector: {import_s:.3f}s = "
            f"{len(docs) / import_s:.1f} events/s{versus}")
        clean = _storage_clean(tag, pio, app_id, views, sets)
        out, train_s = pio.run(tag, "train", "--engine-json", engine_json, "--device", DEVICE)
        found = re.search(r"Training finished: engine instance (\w+) \(COMPLETED\)", out)
        stages = re.search(r"Stage times: read ([\d.]+)s.*", out)
        if found is None or stages is None:
            fail(f"[{tag}] pio train did not complete: {out[-2000:]}")
        instance_id, read_s = found.group(1), float(stages.group(1))
        log(f"[{tag}] pio train on the card from PostgreSQL through the fault injector: "
            f"instance {instance_id} in {train_s:.3f}s; {stages.group(0)}")
        _storage_blob(tag, s3, pio.env, instance_id)
        # the admin tools and the retired commands run while the deploy boots
        launches, deploy_s = _storage_serve(
            tag, pio, s3, engine_json, instance_id,
            lambda: (_storage_admin(tag, pio), _storage_dashboard(tag, pio_main, eval_instance),
                     _retired_commands(tag, pio)))
        methods = [m for m, _ in s3.RequestHandlerClass.requests]
        log(f"[{tag}] summary: import {len(docs) / import_s:.1f} events/s; cleaning "
            f"{clean['seconds']:.3f}s; pio train {train_s:.3f}s (read {read_s:.2f}s under "
            f"{STORAGE_FAULT_RATE:g} faults); deploy to listening {deploy_s:.3f}s; S3 "
            f"requests { {m: methods.count(m) for m in sorted(set(methods))} }")
    finally:
        s3.shutdown()
        emulator.stop()
    log(f"[{tag}] phase 29 took {time.perf_counter() - t0:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# phase 30: `pio lint` of the port's tree, in the shadow of phases 1-2
# ---------------------------------------------------------------------------

#: a `pio lint` process that reports its exit code, the top-level
#: packages of torch, JAX or the JAX package it loaded, and its seconds
LINT_CHILD = """
import json, sys, time
t0 = time.perf_counter()
from predictionio_tpu_torch.cli.pio import main
rc = main(sys.argv[1:])
mods = sorted({n.split(".")[0] for n in sys.modules} & {"torch", "jax", "predictionio_tpu"})
print(json.dumps({"rc": rc, "modules": mods, "seconds": time.perf_counter() - t0}))
"""

#: the findings tests/test_torch_analysis_rules.py pins on
#: host_sync_bad.py and on its torch twin: (line, col, words of the message)
LINT_PINNED = {
    "analysis_fixtures": [
        (11, 11, ".item() on the serving path"),
        (12, 17, "float(jnp.max(scores)) converts"),
        (13, 18, "np.asarray(jnp.sort(scores)) converts"),
        (14, 4, ".block_until_ready() on the serving path"),
        (15, 10, "jax.device_get() on the serving path"),
    ],
    "analysis_fixtures_torch": [
        (11, 11, ".item() on the serving path"),
        (12, 17, "float(torch.max(scores)) converts"),
        (13, 18, "np.asarray(torch.sort(scores).values) converts"),
        (14, 4, "torch.cuda.synchronize() on the serving path"),
        (15, 10, "float(torch.sum(scores[:10])) converts"),
    ],
}
LINT_TIMEOUT = 300


def start_lint() -> dict:
    """Phase 30's child processes, started and left running: the lint of
    the port's tree, and of copies of the two pinned fixtures."""
    repo = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="pio-lint-")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    runs = {"tree": ["lint", "--format", "json", "--no-cache"]}
    for fixtures in LINT_PINNED:
        os.makedirs(os.path.join(work, fixtures))
        copy = shutil.copy(os.path.join(repo, "tests", fixtures, "host_sync_bad.py"),
                           os.path.join(work, fixtures))
        runs[fixtures] = ["lint", copy, "--rule", "host-sync-in-hot-path",
                          "--format", "json", "--no-cache"]
    procs = {name: subprocess.Popen([sys.executable, "-c", LINT_CHILD, *argv], cwd=work,
                                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for name, argv in runs.items()}
    return {"work": work, "procs": procs, "t0": time.perf_counter()}


def join_lint(started: dict) -> None:
    """Waits for phase 30's processes and checks what they printed."""
    t_wait = time.perf_counter()
    out = {}
    try:
        for name, proc in started["procs"].items():
            try:
                stdout, stderr = proc.communicate(timeout=LINT_TIMEOUT)
            except subprocess.TimeoutExpired:
                fail(f"[lint] `pio lint` ({name}) ran past {LINT_TIMEOUT}s")
            *report, last = stdout.strip().splitlines() or [""]
            try:
                tail = json.loads(last)
                doc = json.loads("\n".join(report))
            except ValueError:
                fail(f"[lint] `pio lint` ({name}) exited {proc.returncode}:\n"
                     f"{stdout[-3000:]}\n{stderr[-3000:]}")
            out[name] = (tail, doc, stderr)
    finally:
        for proc in started["procs"].values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(started["work"], ignore_errors=True)
    waited = time.perf_counter() - t_wait

    tail, doc, stderr = out["tree"]
    stats = doc["stats"]
    log(f"[lint] pio lint of predictionio_tpu_torch/: exit {tail['rc']}, "
        f"{len(doc['findings'])} findings, {stats['files']} files; stats seconds: "
        f"parse_s={stats['parse_s']} module_rules_s={stats['module_rules_s']} "
        f"project_rules_s={stats['project_rules_s']} total_s={stats['total_s']}; "
        f"process {tail['seconds']:.3f}s after its imports began; "
        f"torch/JAX loaded: {tail['modules'] or 'none'}")
    if tail["rc"] != 0 or doc["findings"]:
        fail(f"[lint] the port's tree does not lint clean:\n"
             + "\n".join(json.dumps(f) for f in doc["findings"][:40]) + stderr[-2000:])
    if set(stats["project_rules"]) != {"shared-state-race", "lock-order",
                                       "jit-recompile-risk"}:
        fail(f"[lint] the project passes did not all run: {stats['project_rules']}")
    if len(stats["module_rules"]) != 6 or stats["files"] <= 100:
        fail(f"[lint] a partial run: {stats['module_rules']}, {stats['files']} files")
    for name, pinned in LINT_PINNED.items():
        tail, doc, stderr = out[name]
        got = [(f["line"], f["col"], f["rule"], f["message"]) for f in doc["findings"]]
        ok = (tail["rc"] == 1 and len(got) == len(pinned)
              and all((line, col) == (g[0], g[1]) and g[2] == "host-sync-in-hot-path"
                      and words in g[3] for (line, col, words), g in zip(pinned, got)))
        if not ok:
            fail(f"[lint] {name}/host_sync_bad.py: exit {tail['rc']}, findings {got}")
        if tail["modules"]:
            fail(f"[lint] `pio lint` ({name}) loaded {tail['modules']}")
        log(f"[lint] {name}/host_sync_bad.py: the {len(got)} pinned findings, exit 1, "
            f"{tail['seconds']:.3f}s")
    if out["tree"][0]["modules"]:
        fail(f"[lint] the `pio lint` process loaded {out['tree'][0]['modules']}")
    log(f"[phases] phase 30 took {time.perf_counter() - started['t0']:.1f}s, "
        f"beside phases 1-2 (waited {waited:.1f}s at the join)")


# ---------------------------------------------------------------------------
# Phase 31: the example engines of examples_torch/
# ---------------------------------------------------------------------------

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples_torch")
#: card against CPU: an ALS engine's scores from one trained model (f32
#: products in another summation order); the Markov chain's and
#: hello-similarity's f32 scores and the host float64 ridge, each engine
#: trained on its own device from the same events
EXAMPLE_SERVE_TOL, EXAMPLE_F32_TOL, EXAMPLE_RIDGE_TOL = 1e-5, 1e-6, 1e-12
#: similarproduct-multi-events-multi-algos' blend: its z-scores divide
#: the two algorithms' f32 score differences by each list's spread
EXAMPLE_BLEND_TOL = 1e-4
#: each engine's queries answered this many times for its predict p50
EXAMPLE_REPEATS = 5
#: the example whose README phase 31 runs through `pio` processes
EXAMPLE_README = "recommendation-custom-serving"


@contextlib.contextmanager
def _example_module(name: str):
    """``examples_torch/<name>/engine.py`` as the module ``engine`` (the
    name its engine.json and its pickled models record) for the
    block's duration."""
    path = os.path.join(EXAMPLES_DIR, name)
    sys.path.insert(0, path)
    sys.modules.pop("engine", None)
    try:
        import engine
        yield engine
    finally:
        sys.path.remove(path)
        sys.modules.pop("engine", None)


def _seed_script_events(name: str) -> list:
    """The events of the example's own seed_events.py."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "seed_" + name.replace("-", "_"), os.path.join(EXAMPLES_DIR, name, "seed_events.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.events()


def _category_events() -> list:
    """recommendation-filter-by-category has no seed script: its JAX
    test's store (items in "even"/"odd", i0 and i1 in both; every user
    rates the items of its own parity)."""
    out = [Event(event="$set", entity_type="item", entity_id=f"i{i}",
                 properties=DataMap({"categories": ["even", "odd"] if i < 2 else
                                     ["even" if i % 2 == 0 else "odd"]}))
           for i in range(12)]
    out += [Event(event="rate", entity_type="user", entity_id=f"u{u}",
                  target_entity_type="item", target_entity_id=f"i{i}",
                  properties=DataMap({"rating": 5.0}))
            for u in range(16) for i in range(12) if i % 2 == u % 2]
    return out


def _page_events() -> list:
    """markov-nextpage has no seed script: its JAX test's view streams
    (p1 -> p2 three times, p1 -> p3 once)."""
    t0 = datetime(2024, 5, 1, tzinfo=timezone.utc)
    streams = {"u0": ["p1", "p2", "p1", "p3"], "u1": ["p1", "p2", "p4"],
               "u2": ["p2", "p4", "p1", "p2"]}
    return [Event(event="view", entity_type="user", entity_id=u, target_entity_type="page",
                  target_entity_id=page, properties=DataMap({}),
                  event_time=t0 + timedelta(minutes=k))
            for u, pages in streams.items() for k, page in enumerate(pages)]


def _point_events() -> list:
    """local-regression has no seed script: its JAX test's 40 points on
    the plane y = 2*x0 - 3*x1 + 5."""
    rng = np.random.default_rng(11)
    out = []
    for k in range(40):
        x0, x1 = float(rng.uniform(-5, 5)), float(rng.uniform(-5, 5))
        out.append(Event(event="$set", entity_type="point", entity_id=f"pt{k}",
                         properties=DataMap({"x0": x0, "x1": x1, "y": 2 * x0 - 3 * x1 + 5})))
    return out


def _example_store(app_name: str, events: list):
    storage = memory_storage()
    app_id = storage.get_meta_data_apps().insert(App(0, app_name))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch(events, app_id)
    return storage


def _insert_both(pair: dict, app_name: str, event: Event) -> None:
    """One more event, under one id, into every store of the pair."""
    for storage in {id(pair[side]["storage"]): pair[side]["storage"]
                    for side in _EXAMPLE_SIDES if side in pair}.values():
        storage.get_events().insert(event, storage.get_meta_data_apps().get_by_name(app_name).id)


def _ranked(result) -> list[tuple[str, float]] | None:
    """A ranked answer's (id, score) pairs; None for a scalar answer."""
    for field, key, score in (("item_scores", "item", "score"), ("pages", "page", "prob"),
                              ("neighbors", "entity", "score")):
        if hasattr(result, field):
            return [(getattr(s, key), getattr(s, score)) for s in getattr(result, field)]
    return None


def _hold_example(tag: str, body: dict, got, want, tol: float, tie_tol: float) -> float:
    """The card's answer against the CPU's: as many entries; the scores
    position by position within ``tol`` (relative above 1); each id the
    CPU's at that position, or, within a near-tie (CPU scores closer than
    ``tie_tol``), one the CPU ranks within the tie or one past its cut
    whose score ties the CPU's last. Forest and ridge answers compare
    whole. Returns the largest score error."""
    g, w = _ranked(got), _ranked(want)
    if g is None:
        if hasattr(want, "label"):
            if (got.label, got.scores) != (want.label, want.scores):
                fail(f"[{tag}] {json.dumps(body)}: {got} on the card, {want} on the CPU")
            return 0.0
        err = abs(got.prediction - want.prediction)
        if err > tol:
            fail(f"[{tag}] {json.dumps(body)}: {got.prediction} vs {want.prediction}")
        return err
    if len(g) != len(w):
        fail(f"[{tag}] {json.dumps(body)}: {len(g)} entries on the card, {len(w)} on the CPU: "
             f"{g} vs {w}")
    err = 0.0
    cpu_score = dict(w)
    for j, ((gi, gs), (wi, ws)) in enumerate(zip(g, w)):
        err = max(err, abs(gs - ws) / max(1.0, abs(ws)))
        if gi == wi:
            continue
        tied = (gi in cpu_score and abs(cpu_score[gi] - ws) <= tie_tol * max(1.0, abs(ws))) \
            or (gi not in cpu_score and abs(gs - w[-1][1]) <= tie_tol * max(1.0, abs(ws)))
        if not tied:
            fail(f"[{tag}] {json.dumps(body)}: {gi} at {j} on the card, {wi} on the CPU: "
                 f"{g} vs {w}")
    if err > tol:
        fail(f"[{tag}] {json.dumps(body)}: score error {err:.3e} > {tol:g}: {g} vs {w}")
    return err


def _train_example(tag: str, name: str, variant: dict, storage, device: str) -> tuple:
    """run_train on ``device``, then the instance loaded as a deploy loads
    it (load_models, prepare_deploy): (deployed engine, train seconds)."""
    t0 = time.perf_counter()
    outcome = run_train(variant=variant, ctx=EngineContext(storage=storage, device=device))
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if outcome.status != "COMPLETED":
        fail(f"[{tag}] run_train on {device}: {outcome.status}")
    deployed = load_deployed_engine(storage, ServerConfig(engine_instance_id=outcome.instance_id,
                                                          device=device))
    if deployed.device.type != device:
        fail(f"[{tag}] the instance deployed on {deployed.device}, not {device}")
    return deployed, seconds


def _answer(deployed, bodies: list[dict]) -> list:
    qc = deployed.query_class
    return [deployed.query(from_wire(qc, body)) for body in bodies]


def _answer_both(tag: str, pair: dict, bodies: list[dict], tol: float, tie_tol: float) -> list:
    """Each body answered by the pair's three deploys. The card's instance
    served on the card and on the CPU must agree within ``tol`` (near-ties
    within ``tie_tol``); an engine whose training the data determine (no
    ALS) must also agree with the one trained on the CPU, within the same
    tolerances. An ALS engine trained on the CPU is not held to the card's
    one: on the examples' small two-cluster data, a 1e-6 change of the
    initial item table moves the trained scores past 1e-3 on one device
    alone (tests/test_torch_custom_serving_example.py,
    ``test_shipped_training_is_not_determined_to_1e_3``); both must show
    the example's pinned behaviours, and their distance is logged. Returns the card's and the CPU-trained engine's answers, for
    those checks."""
    card = _answer(pair["card"]["deployed"], bodies)
    same = _answer(pair["same"]["deployed"], bodies)
    cpu = _answer(pair["cpu"]["deployed"], bodies)
    worst = max(_hold_example(tag, b, g, w, tol, tie_tol)
                for b, g, w in zip(bodies, card, same))
    if not pair["als"]:
        worst = max([worst] + [_hold_example(tag, b, g, w, tol, tie_tol)
                               for b, g, w in zip(bodies, card, cpu)])
    else:
        for g, w in zip(card, cpu):
            g, w = _ranked(g), _ranked(w)
            pair["drift"] = max([pair.get("drift", 0.0)] + [
                abs(gs - ws) / max(1.0, abs(ws)) for (_, gs), (_, ws) in zip(g, w)])
            pair["drift_order"] = pair.get("drift_order", 0) + (
                [i for i, _ in g] != [i for i, _ in w])
    pair["worst"] = max(pair.get("worst", 0.0), worst)
    pair["held"] = pair.get("held", 0) + len(bodies)
    return [card, cpu]


#: the deploys of one example in phase 31: "card", the engine trained
#: and served on the card (timed, and checked for its pinned
#: behaviours); "same", the card's trained instance deployed on the CPU;
#: "cpu", the engine trained and served on the CPU from the same events
#: (checked for the same behaviours)
_EXAMPLE_SIDES = ("card", "same", "cpu")


def _example_pair(tag: str, name: str, events: list, variant: dict | None = None) -> dict:
    """The example trained from ``events`` on the card and on the CPU,
    each over a memory store of its own (the same events, numbered
    alike), and the card's instance deployed on the CPU too: the
    _EXAMPLE_SIDES."""
    if variant is None:
        with open(os.path.join(EXAMPLES_DIR, name, "engine.json")) as f:
            variant = json.load(f)
    events = [e if e.event_id else dataclasses.replace(e, event_id=f"e{k:06d}")
              for k, e in enumerate(events)]
    app_name = variant["datasource"]["params"]["app_name"]
    pair = {"app": app_name}
    for side, device in (("card", DEVICE), ("cpu", "cpu")):
        storage = _example_store(app_name, events)
        deployed, seconds = _train_example(tag, name, variant, storage, device)
        pair[side] = {"storage": storage, "deployed": deployed, "train_s": seconds}
    card = pair["card"]
    pair["same"] = {"storage": card["storage"], "deployed": load_deployed_engine(
        card["storage"], ServerConfig(engine_instance_id=card["deployed"].instance_id,
                                      device="cpu"))}
    pair["als"] = any(isinstance(getattr(m, "als", m), ALSModel)
                      for m in card["deployed"].models)
    return pair


def _example_times(tag: str, pair: dict, bodies: list[dict]) -> dict:
    """The card deploy's numbers over ``bodies``: predict p50 (ms, host
    clock, EXAMPLE_REPEATS rounds), ms a query between CUDA events,
    device ms and launches a query (torch.profiler, one round)."""
    deployed = pair["card"]["deployed"]
    qc = deployed.query_class
    bound = [from_wire(qc, body) for body in bodies]
    wall = []
    for _ in range(EXAMPLE_REPEATS):
        for q in bound:
            t0 = time.perf_counter()
            deployed.query(q)
            wall.append((time.perf_counter() - t0) * 1e3)
    events_ms, _ = _events_ms(lambda: [deployed.query(q) for q in bound])
    device_ms, launches = _profile(lambda: [deployed.query(q) for q in bound])
    n = len(bound)
    out = dict(train_s=pair["card"]["train_s"],
               cpu_train_s=pair["cpu"]["train_s"],
               queries=n, p50_ms=statistics.median(wall), events_ms_per_query=events_ms / n,
               device_ms_per_query=None if device_ms is None else device_ms / n,
               launches_per_query=launches / n, held=pair.get("held", 0),
               max_err=pair.get("worst", 0.0), als_drift=pair.get("drift"),
               als_drift_order=pair.get("drift_order"))
    log(f"[{tag}] train_s={out['train_s']:.3f} (cpu {out['cpu_train_s']:.3f}) "
        f"p50_ms={out['p50_ms']:.3f} events_ms_per_query={out['events_ms_per_query']:.4f} "
        f"device_ms_per_query={_fmt(out['device_ms_per_query'], 4)} "
        f"launches_per_query={out['launches_per_query']:.1f}; {out['held']} answers held "
        f"against the CPU's, max score err {out['max_err']:.3e}"
        + ("" if out["als_drift"] is None else
           f"; trained on the CPU, the ALS answers {out['als_drift']:.3e} away (ids or order "
           f"differ in {out['als_drift_order']})"))
    return out


def _items(result) -> list[str]:
    return [i for i, _ in _ranked(result)]


def _example_custom_serving(tag: str, work: str) -> tuple:
    name = "recommendation-custom-serving"
    disabled = os.path.join(work, "disabled.txt")
    with open(os.path.join(EXAMPLES_DIR, name, "engine.json")) as f:
        variant = json.load(f)
    variant["serving"]["params"]["filepath"] = disabled
    pair = _example_pair(tag, name, _seed_script_events(name), variant)
    bodies = [{"user": "u1", "num": 4}, {"user": "u0", "num": 5}, {"user": "u7", "num": 8}]
    card, _ = _answer_both(tag, pair, bodies, EXAMPLE_SERVE_TOL, EXAMPLE_SERVE_TOL)
    target = _items(card[1])[0]
    with open(disabled, "w") as f:                  # live: no retrain, no redeploy
        f.write(f"{target}\n")
    for answers in _answer_both(tag, pair, bodies, EXAMPLE_SERVE_TOL, EXAMPLE_SERVE_TOL):
        if any(target in _items(r) for r in answers) or not all(_items(r) for r in answers):
            fail(f"[{tag}] disabled {target} is still served: {[_items(r) for r in answers]}")
    os.remove(disabled)
    log(f"[{tag}] {target} (u0's first) disabled live: absent from every answer")
    return pair, bodies


def _example_custom_preparator(tag: str, work: str) -> tuple:
    name = "recommendation-custom-preparator"
    no_train = os.path.join(work, "no_train_items.txt")
    with open(no_train, "w") as f:
        f.write("i3\n")
    with open(os.path.join(EXAMPLES_DIR, name, "engine.json")) as f:
        variant = json.load(f)
    variant["preparator"]["params"]["filepath"] = no_train
    pair = _example_pair(tag, name, _seed_script_events(name), variant)
    bodies = [{"user": "u1", "num": 4}] + [{"user": u, "num": 8} for u in ("u0", "u2", "u5")]
    for side, answers in zip(("card", "cpu"), _answer_both(tag, pair, bodies,
                                                           EXAMPLE_SERVE_TOL, EXAMPLE_SERVE_TOL)):
        if "i3" in pair[side]["deployed"].models[0].item_ids or any(
                "i3" in _items(r) for r in answers):
            fail(f"[{tag}] the excluded i3 was trained or served ({side})")
    log(f"[{tag}] i3 excluded from training: no factors, never served")
    return pair, bodies


def _example_filter_by_category(tag: str, work: str) -> tuple:
    name = "recommendation-filter-by-category"
    pair = _example_pair(tag, name, _category_events())
    model = pair["card"]["deployed"].models[0]
    if model.als.item_factors.device.type != DEVICE:
        fail(f"[{tag}] the pickled model's factors came back on {model.als.device}")
    bodies = [{"user": "u1", "num": 4, "categories": ["action"]}, {"user": "u0", "num": 6},
              {"user": "u0", "num": 6, "categories": ["odd"]},
              {"user": "u3", "num": 6, "categories": ["even"]},
              {"user": "u0", "num": 6, "categories": ["nope"]}]
    cats = model.categories
    for answers in _answer_both(tag, pair, bodies, EXAMPLE_SERVE_TOL, EXAMPLE_SERVE_TOL):
        for body, result in zip(bodies, answers):
            wanted = set(body.get("categories") or ())
            if "categories" in body and not all(wanted & set(cats.get(i, ()))
                                                for i in _items(result)):
                fail(f"[{tag}] {json.dumps(body)} answered outside its categories: "
                     f"{_items(result)}")
        if not _items(answers[2]) or _items(answers[0]) or _items(answers[4]):
            fail(f"[{tag}] category answers {[_items(r) for r in answers]}")
    log(f"[{tag}] the pickled model loaded on the card; only the queries' categories served")
    return pair, bodies


def _example_similar(name: str, bodies: list[dict]):
    """An example whose answers must be non-empty and never hold a query's
    own items (or users)."""
    def run(tag: str, work: str) -> tuple:
        pair = _example_pair(tag, name, _seed_script_events(name))
        for answers in _answer_both(tag, pair, bodies, EXAMPLE_SERVE_TOL, EXAMPLE_SERVE_TOL):
            for body, result in zip(bodies, answers):
                asked = set(body.get("items", body.get("users", ())))
                if not _items(result) or asked & set(_items(result)):
                    fail(f"[{tag}] {json.dumps(body)}: {_items(result)}")
                for s in result.item_scores:
                    if hasattr(s, "imdb_url") and (s.title, s.imdb_url) != (
                            f"title for {s.item}", f"http://imdb.com/{s.item}"):
                        fail(f"[{tag}] {s} is not enriched with its properties")
        return pair, bodies
    return run


def _example_filterbyyear(tag: str, work: str) -> tuple:
    name = "similarproduct-filterbyyear"
    pair = _example_pair(tag, name, _seed_script_events(name))
    bodies = [{"items": ["i1"], "num": 4, "recommendFromYear": 1997},
              {"items": ["i2"], "num": 5}, {"items": ["i2"], "num": 5, "recommendFromYear": 2001}]
    for answers in _answer_both(tag, pair, bodies, EXAMPLE_SERVE_TOL, EXAMPLE_SERVE_TOL):
        for body, result in zip(bodies, answers):
            floor = body.get("recommendFromYear", 1)
            if not result.item_scores or any(s.year <= floor or s.year != 1990 + int(s.item[1:])
                                             for s in result.item_scores):
                fail(f"[{tag}] {json.dumps(body)}: {result.item_scores}")
    log(f"[{tag}] only years after recommendFromYear served, each with its year")
    return pair, bodies


def _example_multi(tag: str, work: str) -> tuple:
    name = "similarproduct-multi-events-multi-algos"
    pair = _example_pair(tag, name, _seed_script_events(name))
    bodies = [{"items": ["i1"], "num": 4}, {"items": ["i2"], "num": 6}]
    for side, answers in zip(("card", "cpu"), _answer_both(tag, pair, bodies,
                                                           EXAMPLE_BLEND_TOL, EXAMPLE_BLEND_TOL)):
        deployed = pair[side]["deployed"]
        if len(deployed.models) != 2 or not all(_items(r) for r in answers):
            fail(f"[{tag}] {len(deployed.models)} models, answers "
                 f"{[_items(r) for r in answers]} ({side})")
        q = from_wire(deployed.query_class, bodies[1])
        view_only = _items(deployed.algorithms[0].predict(deployed.models[0], q))
        blend = _items(answers[1])
        if "i0" in view_only and "i0" in blend and blend.index("i0") <= view_only.index("i0"):
            fail(f"[{tag}] the dislikes did not demote i0 ({side}): views {view_only}, "
                 f"blend {blend}")
        log(f"[{tag}] {side}: two models; the blend {blend} against the views' {view_only}")
    return pair, bodies


def _example_rate_event(tag: str, work: str) -> tuple:
    name = "ecommerce-train-with-rate-event"
    pair = _example_pair(tag, name, _seed_script_events(name))
    _insert_both(pair, pair["app"], Event(
        event="rate", entity_type="user", entity_id="ghost", target_entity_type="item",
        target_entity_id="i2", properties=DataMap({"rating": 5.0}), event_id="ghost-1"))
    bodies = [{"user": "u1", "num": 4}, {"user": "u2", "num": 4}, {"user": "ghost", "num": 4}]
    for answers in _answer_both(tag, pair, bodies, EXAMPLE_SERVE_TOL, EXAMPLE_SERVE_TOL):
        if not all(_items(r) for r in answers):
            fail(f"[{tag}] {[_items(r) for r in answers]}")
    log(f"[{tag}] the newcomer answered from the live store through the fallback")
    return pair, bodies


def _example_weighted(tag: str, work: str) -> tuple:
    """Each engine's own third item for u1 weighted 5.0 live in its own
    store must rise to first."""
    name = "ecommerce-weighted-items"
    pair = _example_pair(tag, name, _seed_script_events(name))
    bodies = [{"user": "u1", "num": 4}, {"user": "u1", "num": 6}]
    targets = {}
    for side, answers in zip(("card", "cpu"), _answer_both(tag, pair, bodies,
                                                           EXAMPLE_SERVE_TOL, EXAMPLE_SERVE_TOL)):
        targets[side] = _items(answers[1])[2]
        storage = pair[side]["storage"]
        storage.get_events().insert(Event(
            event="$set", entity_type="constraint", entity_id="weightedItems",
            event_id="w-live", event_time=datetime.now(timezone.utc) + timedelta(minutes=1),
            properties=DataMap({"weights": [{"items": [targets[side]], "weight": 5.0}]})),
            storage.get_meta_data_apps().get_by_name(pair["app"]).id)
    for side, answers in zip(("card", "cpu"), _answer_both(tag, pair, bodies,
                                                           EXAMPLE_SERVE_TOL, EXAMPLE_SERVE_TOL)):
        if _items(answers[1])[0] != targets[side]:
            fail(f"[{tag}] weight 5.0 on {targets[side]} did not lift it ({side}): "
                 f"{_items(answers[1])}")
    factors = pair["card"]["deployed"].algorithms[0]._weighted_model(
        pair["card"]["deployed"].models[0]).als.item_factors
    if factors.device.type != DEVICE:
        fail(f"[{tag}] the weighted factors are on {factors.device}")
    log(f"[{tag}] the third item weighted 5.0 live rose to first: {targets}")
    return pair, bodies


def _example_forest(tag: str, work: str) -> tuple:
    name = "classification-custom-attributes"
    pair = _example_pair(tag, name, _seed_script_events(name))
    bodies = [{"gender": "Female", "age": 22, "education": "College"},
              {"gender": "Female", "age": 25, "education": "College"},
              {"gender": "Male", "age": 55, "education": "No School"}]
    card, _ = _answer_both(tag, pair, bodies, 0.0, 0.0)
    labels = [r.label for r in card]
    if labels != ["premium", "premium", "basic"]:
        fail(f"[{tag}] labels {labels}")
    tables = pair["card"]["deployed"].models[0].tables
    if {t.device.type for t in tables} != {DEVICE}:
        fail(f"[{tag}] the node tables are not on the card")
    log(f"[{tag}] labels {labels}; the vote walk over node tables on the card")
    return pair, bodies


def _example_markov(tag: str, work: str) -> tuple:
    pair = _example_pair(tag, "markov-nextpage", _page_events())
    bodies = [{"page": "p1", "num": 3}, {"page": "p2", "num": 3}, {"page": "nope", "num": 3}]
    card, _ = _answer_both(tag, pair, bodies, EXAMPLE_F32_TOL, 0.0)
    probs = dict(_ranked(card[0]))
    if set(probs) != {"p2", "p3"} or abs(probs["p2"] - 0.75) > EXAMPLE_F32_TOL:
        fail(f"[{tag}] from p1: {probs}")
    return pair, bodies


def _example_ridge(tag: str, work: str) -> tuple:
    pair = _example_pair(tag, "local-regression", _point_events())
    bodies = [{"features": [2.0, 3.0]}, {"features": [-1.5, 4.0]}]
    card, _ = _answer_both(tag, pair, bodies, EXAMPLE_RIDGE_TOL, 0.0)
    if abs(card[0].prediction - (2 * 2.0 - 3 * 3.0 + 5)) > 1e-3:   # λ 0.001 shrinks it
        fail(f"[{tag}] the plane's prediction at (2, 3): {card[0].prediction}")
    return pair, bodies


def _example_hello(tag: str, work: str) -> tuple:
    name = "hello-similarity"
    pair = _example_pair(tag, name, _seed_script_events(name))
    if pair["card"]["deployed"].models[0].vectors.device.type != DEVICE:
        fail(f"[{tag}] the vectors did not come back on the card")
    bodies = [{"entity": "doc1", "num": 2}, {"entity": "doc3", "num": 3},
              {"entity": "doc4", "num": 5}]
    card, _ = _answer_both(tag, pair, bodies, EXAMPLE_F32_TOL, 0.0)
    if _items(card[0]) != ["doc4", "doc2"]:
        fail(f"[{tag}] doc1's neighbours {_items(card[0])}")
    return pair, bodies


#: phase 31's engines, in ROADMAP order: (directory, the function that
#: trains it on both devices, answers and checks it)
EXAMPLES = [
    ("recommendation-custom-serving", _example_custom_serving),
    ("recommendation-custom-preparator", _example_custom_preparator),
    ("recommendation-filter-by-category", _example_filter_by_category),
    ("similarproduct-no-set-user", _example_similar(
        "similarproduct-no-set-user", [{"items": ["i1"], "num": 4}, {"items": ["i2"], "num": 4}])),
    ("similarproduct-recommended-user", _example_similar(
        "similarproduct-recommended-user",
        [{"users": ["u1"], "num": 4}, {"users": ["u2", "u4"], "num": 4},
         {"users": ["u2"], "num": 4, "whiteList": ["u6", "u8", "u3"]}])),
    ("similarproduct-add-and-return-item-properties", _example_similar(
        "similarproduct-add-and-return-item-properties",
        [{"items": ["i1"], "num": 4}, {"items": ["i2"], "num": 4}])),
    ("similarproduct-filterbyyear", _example_filterbyyear),
    ("similarproduct-add-rateevent", _example_similar(
        "similarproduct-add-rateevent", [{"items": ["i1"], "num": 4}, {"items": ["i2"], "num": 4}])),
    ("similarproduct-multi-events-multi-algos", _example_multi),
    ("ecommerce-train-with-rate-event", _example_rate_event),
    ("ecommerce-weighted-items", _example_weighted),
    ("classification-custom-attributes", _example_forest),
    ("markov-nextpage", _example_markov),
    ("local-regression", _example_ridge),
    ("hello-similarity", _example_hello),
]


def _readme_chain(work: str, out: dict) -> None:
    """recommendation-custom-serving's README as `pio` processes on the
    card from a copy of its directory: app new, seed_events.py, build,
    train, deploy, queries over HTTP, a live edit of disabled.txt and
    the changed answer with no redeploy."""
    tag = "examples-readme"
    copy = os.path.join(work, EXAMPLE_README)
    shutil.copytree(os.path.join(EXAMPLES_DIR, EXAMPLE_README), copy,
                    ignore=shutil.ignore_patterns("__pycache__", "disabled.txt"))
    pio = _Pio(copy)
    t0 = time.perf_counter()
    pio.new_app(tag, "CustomServingApp")
    seeded = subprocess.run([sys.executable, "seed_events.py"], cwd=copy, env=pio.env,
                            capture_output=True, text=True, timeout=PIO_STEP_TIMEOUT)
    if seeded.returncode != 0 or "seeded" not in seeded.stdout:
        raise RuntimeError(f"seed_events.py exited {seeded.returncode}: "
                           f"{seeded.stdout[-2000:]}{seeded.stderr[-2000:]}")
    log(f"[{tag}] {seeded.stdout.strip()}")
    built, _ = pio.run(tag, "build")
    if "Build successful" not in built:
        raise RuntimeError(f"pio build: {built[-2000:]}")
    instance_id = pio.train(tag, "engine.json")
    proc, port, listen_s = pio.deploy(tag, "engine.json")
    try:
        status = _status(port)
        if status.get("engineInstanceId") != instance_id or \
                not str(status.get("device", "")).startswith(DEVICE):
            raise RuntimeError(f"GET / of the deploy: {status}")
        body = {"user": "u1", "num": 4}
        code, first, _ = _post(port, body)
        items = [s["item"] for s in first.get("itemScores", [])]
        if code != 200 or len(items) != 4:
            raise RuntimeError(f"{json.dumps(body)} answered {code} {first}")
        with open(os.path.join(copy, "disabled.txt"), "w") as f:
            f.write(f"{items[0]}\n")
        code, after, _ = _post(port, body)
        again = [s["item"] for s in after.get("itemScores", [])]
        if code != 200 or again != items[1:]:
            raise RuntimeError(f"after disabling {items[0]}: {again}, expected {items[1:]}")
        launches = _status(port).get("kernelLaunches", {})
        if any(launches.values()):
            raise RuntimeError(f"the deploy launched the flash kernel {launches} times")
        log(f"[{tag}] GET / device {status['device']}, instance {instance_id}; {items} → "
            f"{items[0]} written to disabled.txt → {again}, no redeploy")
    finally:
        _stop(proc)
    out["seconds"] = time.perf_counter() - t0
    out["listen_s"] = listen_s


def phase_examples() -> dict:
    """Phase 31: the 15 engines of examples_torch/ trained (run_train) and
    served (load_models, prepare_deploy) on the card in this process,
    each held against the same engine trained and answered on the CPU
    from the same events, with its pinned behaviours; meanwhile, in a
    thread, recommendation-custom-serving's README through `pio`
    processes on the card."""
    t0 = time.perf_counter()
    before = flash_ops.LAUNCHES
    work = tempfile.mkdtemp(prefix="pio-examples-")
    chain: dict = {}

    def run_chain():
        try:
            _readme_chain(work, chain)
        except (Exception, SystemExit) as exc:   # fail() exits: reported at the join
            chain["error"] = exc

    thread = threading.Thread(target=run_chain, name="examples-readme", daemon=True)
    thread.start()
    rows = {}
    try:
        for name, run in EXAMPLES:
            tag = f"examples/{name}"
            with _example_module(name):
                pair, bodies = run(tag, work)
                rows[name] = _example_times(tag, pair, bodies)
            torch.cuda.empty_cache()
        thread.join(timeout=PIO_STEP_TIMEOUT * 2)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if thread.is_alive() or "error" in chain or "seconds" not in chain:
        fail(f"[examples-readme] the README through `pio` processes: "
             f"{chain.get('error', 'did not finish')}")
    if flash_ops.LAUNCHES != before:
        fail(f"the example engines launched the flash kernel {flash_ops.LAUNCHES - before} times")
    log(f"[examples] {len(rows)} engines trained and served on the card, each held against "
        f"its CPU run; the README's `pio` chain {chain['seconds']:.1f}s (deploy listening "
        f"after {chain['listen_s']:.1f}s), beside them")
    log("[examples] " + json.dumps({"engines": rows}))
    log(f"[examples] phase 31 took {time.perf_counter() - t0:.1f}s")
    return rows


# ---------------------------------------------------------------------------
# phase 32: the chunked and bucketed ALS layouts at the ML-20M shape
# ---------------------------------------------------------------------------

#: the JAX package's layout defaults (ops/als.py:1321-1343): chunks of
#: 512 then 128 ratings, buckets from 8 ratings growing by 2; the row cap
#: of phase 32's capped layout (the heaviest user rates 27,906 items, the
#: heaviest item is rated 69,408 times)
LAYOUT_CHUNKS = (512, 128)
LAYOUT_MIN_BUCKET, LAYOUT_GROWTH, LAYOUT_ROW_CAP = 8, 2, 4096


def _layout_iterations(by_user, by_item, item0: torch.Tensor, iters: int):
    """``iters`` bf16 iterations through ``als.solve_half`` from ``item0``,
    users first: als_train's loop over layouts packed (and staged) once."""
    item = item0
    for _ in range(iters):
        user = als.solve_half(item, by_user, ALS_RANK, ALS_LAM, matmul_dtype="bfloat16",
                              cg_matvec_dtype="auto")
        item = als.solve_half(user, by_item, ALS_RANK, ALS_LAM, matmul_dtype="bfloat16",
                              cg_matvec_dtype="auto")
    return user, item


def _packed(tag: str, counter: str, pack, coo: als.RatingsCOO) -> tuple[tuple, float]:
    """Both orientations of ``coo`` through ``pack``, whose native packer
    must serve both (``als.<counter>`` moves by 2); (layouts, seconds)."""
    before = getattr(als, counter)
    t0 = time.perf_counter()
    out = pack(coo), pack(coo.transpose())
    seconds = time.perf_counter() - t0
    if getattr(als, counter) != before + 2:
        fail(f"[{tag}] the native packer served {getattr(als, counter) - before} of 2 layouts")
    return out, seconds


def _layout_shape(layout) -> str:
    """Slabs, slab steps at rank ALS_RANK and padded entries of a host layout."""
    parts = [s.cols.shape for s in (layout.slabs if isinstance(layout, als.ChunkedRatings)
                                    else layout.buckets)]
    steps = sum(als._slab_shape(n, L, ALS_RANK, 1, als._MAX_SLAB_ELEMS)[0] for n, L in parts)
    padded = sum(n * L for n, L in parts)
    if isinstance(layout, als.ChunkedRatings):
        return (f"{' + '.join(f'{n} x {L}' for n, L in parts)} chunks, {steps} slab steps, "
                f"{padded} padded entries")
    return (f"{len(parts)} buckets, {steps} slabs, longest pad {max(L for _, L in parts)}, "
            f"{padded} padded entries")


def _same_slabs(got, want) -> bool:
    return len(got) == len(want) and all(
        np.array_equal(getattr(g, f), getattr(w, f)) and getattr(g, f).dtype == getattr(w, f).dtype
        for g, w in zip(got, want) for f in ("row_ids", "cols", "vals", "deg"))


def _same_capped(got, want, counts: np.ndarray, cap: int) -> bool:
    """Capped buckets: the same rows and degrees; a row of at most ``cap``
    ratings equal, a capped row the same values (the two paths may keep
    other columns at tied values, tests/test_als.py:467-494)."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if not (np.array_equal(g.row_ids, w.row_ids) and np.array_equal(g.deg, w.deg)):
            return False
        cut = counts[g.row_ids] > cap
        if not (np.array_equal(g.cols[~cut], w.cols[~cut]) and
                np.array_equal(g.vals[~cut], w.vals[~cut]) and
                np.array_equal(np.sort(g.vals[cut], axis=1), np.sort(w.vals[cut], axis=1))):
            return False
    return True


def layouts_native_vs_numpy(tag: str, coo: als.RatingsCOO) -> None:
    """Both orientations of the COO's first LADDER_CHECK_RATINGS ratings
    through the native packers and the NumPy paths: chunked and bucketed
    equal array for array, capped as :func:`_same_capped` says."""
    n = min(LADDER_CHECK_RATINGS, coo.nnz)
    sub = als.RatingsCOO(coo.rows[:n], coo.cols[:n], coo.vals[:n], coo.num_rows, coo.num_cols)
    seconds: dict[str, list[float]] = {}
    for side, c in (("user", sub), ("item", sub.transpose())):
        counts = np.bincount(c.rows, minlength=c.num_rows)
        for name, pack, same in (
                ("chunked", lambda c, nat: als.chunk_rows(c, LAYOUT_CHUNKS, nat).slabs,
                 _same_slabs),
                ("bucketed", lambda c, nat: als.bucket_rows(
                    c, LAYOUT_MIN_BUCKET, LAYOUT_GROWTH, use_native=nat).buckets, _same_slabs),
                (f"capped at {LAYOUT_ROW_CAP}", lambda c, nat: als.bucket_rows(
                    c, LAYOUT_MIN_BUCKET, LAYOUT_GROWTH, LAYOUT_ROW_CAP, nat).buckets,
                 lambda g, w: _same_capped(g, w, counts, LAYOUT_ROW_CAP))):
            t0 = time.perf_counter()
            got = pack(c, True)
            t1 = time.perf_counter()
            want = pack(c, False)
            t2 = time.perf_counter()
            if not same(got, want):
                fail(f"[{tag}] the native {name} {side} layout differs from the NumPy path's")
            acc = seconds.setdefault(name, [0.0, 0.0])
            acc[0] += t1 - t0
            acc[1] += t2 - t1
    log(f"[{tag}] of the first {n} ratings, both orientations, native against NumPy: "
        + "; ".join(f"{name} {a:.3f}s / {b:.3f}s ({b / a:.1f}x)" for name, (a, b) in
                    seconds.items()) + " — equal (capped rows: the same values)")


def _time_route(tag: str, layouts, item0: torch.Tensor, coo: als.RatingsCOO,
                executed: float, stage=None) -> dict:
    """A bf16 route: ``layouts`` (by user, by item) staged by ``stage``
    (None: streamed from the host), one warm-up iteration, then
    ALS_TIMED_ITERS iterations between CUDA events; ms an iteration, RMSE
    and the peak device memory above what was allocated before staging.
    The staged layouts are returned for the profile and the f32 check."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    by = layouts if stage is None else tuple(stage(x) for x in layouts)
    _layout_iterations(*by, item0, 1)
    ms, (user, item) = _events_ms(lambda: _layout_iterations(*by, item0, ALS_TIMED_ITERS))
    peak = torch.cuda.max_memory_allocated() - base
    per_iter = ms / ALS_TIMED_ITERS
    err = als.rmse(als.ALSFactors(user, item), coo)
    log(f"[{tag}] bf16, {ALS_TIMED_ITERS} iterations: ms_per_iteration={per_iter:.3f} "
        f"ratings_per_s={coo.nnz / (per_iter / 1e3):.0f} "
        f"executed_tflops={executed / (per_iter / 1e3) / 1e12:.4f} rmse={err:.5f} "
        f"peak_mem_gb={peak / 1e9:.3f} (above the phase's allocations)")
    return {"ms": per_iter, "rmse": err, "peak": peak, "item": item, "layouts": by}


def _profile_route(tag: str, route: dict, item0: torch.Tensor) -> None:
    """Device ms and launches of one iteration of a timed route, by
    torch.profiler, and the busy share against its unprofiled ms."""
    dev_ms, launches = _profile(lambda: _layout_iterations(*route["layouts"], item0, 1),
                                top=tag)
    route.update(device_ms=dev_ms, launches=launches)
    log(f"[{tag}] one profiled iteration: launches={launches} device_ms={_fmt(dev_ms)} "
        f"device_busy_share={_fmt(dev_ms and dev_ms / route['ms'], 4)}")


def _f32_half_step(tag: str, V: torch.Tensor, layout, rated, rows: np.ndarray,
                   fused: torch.Tensor | None = None) -> torch.Tensor:
    """The f32 user half-step over ``layout`` (build and CG matvec in f32)
    against float64 Cholesky on ``rows``, and, given one, against the
    fused layout's f32 half-step (relative Frobenius error)."""
    ms, X = _events_ms(lambda: als.solve_half(V, layout, ALS_RANK, ALS_LAM,
                                              matmul_dtype="float32",
                                              cg_matvec_dtype="float32"))
    errs = _f64_half_step_err(V, X, rated, rows, ALS_LAM)
    msg = (f"[{tag}] f32 user half-step in {ms:.3f} ms; vs float64 Cholesky on {len(rows)} "
           f"rows: max_rel_err={errs.max():.3e} median={np.median(errs):.3e} "
           f"(tol {CG_F32_RTOL:g})")
    if fused is not None:
        off = (torch.linalg.vector_norm(X - fused) / torch.linalg.vector_norm(fused)).item()
        msg += f"; vs the fused f32 half-step: rel_err={off:.3e} (tol {CG_F32_RTOL:g})"
        if not off <= CG_F32_RTOL:
            fail(f"[{tag}] the f32 half-step is {off:.3e} from the fused layout's")
    log(msg)
    if not errs.max() <= CG_F32_RTOL:
        fail(f"[{tag}] the f32 half-step disagrees with float64")
    return X


def phase_als_layouts(fused9: dict | None) -> None:
    """Phase 32: the chunked and bucketed layouts on phase 9's ML-20M-shape
    COO at rank ALS_RANK, λ ALS_LAM: native packing of both sides
    (checked against the NumPy paths on a prefix); the bf16 route of the
    bucketed layout streamed from the host, the fused ladder (the
    reference), the bucketed layout resident and the chunked layout,
    all timed before any is profiled; each one's f32 half-step against
    float64 and the fused f32 half-step (the capped layout against
    float64 on its own columns); the streamed peak below the resident
    one; then ``als_train``'s "auto" route with the row cap and
    streaming, one iteration. Phase 9's fused numbers, ``fused9``, are
    logged beside them where that phase ran."""
    tag = "layouts"
    t_phase = time.perf_counter()
    flash_before = flash_ops.LAUNCHES
    n_users, n_items, nnz = ML20M
    coo = als.RatingsCOO(*make_ratings(n_users, n_items, nnz, SEED), n_users, n_items)
    chunks, t_chunks = _packed(tag, "NATIVE_CHUNKS",
                               lambda c: als.chunk_rows(c, LAYOUT_CHUNKS), coo)
    buckets, t_buckets = _packed(tag, "NATIVE_BUCKETS", lambda c: als.bucket_rows(
        c, LAYOUT_MIN_BUCKET, LAYOUT_GROWTH), coo)
    capped, t_capped = _packed(tag, "NATIVE_BUCKETS", lambda c: als.bucket_rows(
        c, LAYOUT_MIN_BUCKET, LAYOUT_GROWTH, LAYOUT_ROW_CAP), coo)
    for side, i in (("user", 0), ("item", 1)):
        log(f"[{tag}] {side} side: chunked {_layout_shape(chunks[i])}; bucketed "
            f"{_layout_shape(buckets[i])}; capped at {LAYOUT_ROW_CAP}: "
            f"{_layout_shape(capped[i])}, {sum(int(b.deg.sum()) for b in capped[i].buckets)} "
            f"ratings kept of {nnz}")
    log(f"[{tag}] native packing of both sides of {nnz} ratings: chunk_rows {t_chunks:.3f}s, "
        f"bucket_rows {t_buckets:.3f}s, capped {t_capped:.3f}s")
    layouts_native_vs_numpy(tag, coo)

    t_packed = time.perf_counter()

    # every route timed before the first profiler session, which leaves
    # host cost on the launches after it (the fused route is timed again
    # after the profiles to show it)
    item0 = als.init_item_factors(n_items, ALS_RANK, SEED).to(DEVICE)
    ladder = als.ladder_rows(coo), als.ladder_rows(coo.transpose())
    flops = {name: sum(als.half_step_flops(x, ALS_RANK)["executed_flops"] for x in side)
             for name, side in (("fused", ladder), ("bucketed", buckets), ("chunked", chunks))}
    h2d = sum(b.row_ids.size * 8 + np.prod(als._slab_shape(len(b.row_ids), b.pad_len, ALS_RANK,
                                                           1, als._MAX_SLAB_ELEMS)) * 4
              * (2 * b.pad_len + 1) for side in buckets for b in side.buckets)
    log(f"[{tag}/streamed] host to device per iteration: {h2d / 1e9:.3f} GB of padded slabs")
    stage_b = lambda b: als.stage_buckets(b, ALS_RANK, device=DEVICE)  # noqa: E731
    routes = {"streamed": _time_route(f"{tag}/streamed", buckets, item0, coo,
                                      flops["bucketed"])}
    routes["fused"] = _time_route(f"{tag}/fused", ladder, item0, coo, flops["fused"], stage_b)
    routes["resident"] = _time_route(f"{tag}/resident", buckets, item0, coo,
                                     flops["bucketed"], stage_b)
    routes["chunked"] = _time_route(f"{tag}/chunked", chunks, item0, coo, flops["chunked"],
                                    lambda c: als.stage_chunks(c, ALS_RANK, device=DEVICE))
    del ladder
    t_timed = time.perf_counter()
    for name, route in routes.items():
        _profile_route(f"{tag}/{name}", route, item0)
    ms, _ = _events_ms(lambda: _layout_iterations(*routes["fused"]["layouts"], item0,
                                                  ALS_TIMED_ITERS))
    log(f"[{tag}/fused] timed again after the profiler sessions: ms_per_iteration="
        f"{ms / ALS_TIMED_ITERS:.3f} (before them {routes['fused']['ms']:.3f})")
    t_profiled = time.perf_counter()

    # f32 user half-steps from the fused route's items, against float64
    # and, uncapped, against the fused layout's
    rated, active = _row_locator(buckets[0])
    rows = np.random.default_rng(SEED + 32).choice(active, CG_CHECK_ROWS[0], replace=False)
    V = routes["fused"]["item"]
    X_fused = _f32_half_step(f"{tag}/fused", V, routes["fused"]["layouts"][0], rated, rows)
    for name in ("streamed", "resident", "chunked"):
        _f32_half_step(f"{tag}/{name}", V, routes[name]["layouts"][0], rated, rows, X_fused)
    for route in routes.values():
        del route["layouts"]
    # the capped layout on the sampled rows and on every row it cut
    cut = np.concatenate([b.row_ids[b.deg > LAYOUT_ROW_CAP] for b in buckets[0].buckets])
    _f32_half_step(f"{tag}/capped", V, stage_b(capped[0]), _row_locator(capped[0])[0],
                   np.union1d(rows, cut))
    log(f"[{tag}/capped] {len(cut)} users cut to {LAYOUT_ROW_CAP} ratings among those rows")
    del X_fused
    torch.cuda.empty_cache()

    if not routes["streamed"]["peak"] < routes["resident"]["peak"]:
        fail(f"[{tag}] streamed peak {routes['streamed']['peak']} is not below the resident "
             f"{routes['resident']['peak']}")
    for name in ("streamed", "resident", "chunked"):
        off = abs(routes[name]["rmse"] - routes["fused"]["rmse"])
        if not off <= RMSE_BF16_TOL:
            fail(f"[{tag}] {name} bf16 RMSE {routes[name]['rmse']} is {off} from fused's")
    before = als.NATIVE_BUCKETS
    t0 = time.perf_counter()
    f = als.als_train(coo, ALS_RANK, iterations=1, lam=ALS_LAM, max_row_len=LAYOUT_ROW_CAP,
                      hbm_resident=False, item0=item0, device=DEVICE)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    if als.NATIVE_BUCKETS != before + 2 or not (torch.isfinite(f.user).all()
                                                and torch.isfinite(f.item).all()):
        fail(f"[{tag}] als_train(max_row_len, hbm_resident=False): native packs "
             f"{als.NATIVE_BUCKETS - before}, finite {torch.isfinite(f.item).all().item()}")
    log(f"[{tag}] als_train(max_row_len={LAYOUT_ROW_CAP}, hbm_resident=False): \"auto\" "
        f"took the bucketed layout, packed natively, streamed one iteration: {t_train:.3f}s "
        f"with the packing, finite factors")
    log(f"[{tag}] seconds: packing and the NumPy check {t_packed - t_phase:.1f}, timed routes "
        f"{t_timed - t_packed:.1f}, profiles {t_profiled - t_timed:.1f}, f32 checks and "
        f"als_train {time.perf_counter() - t_profiled:.1f}")
    if flash_ops.LAUNCHES != flash_before:
        fail(f"[{tag}] the ALS layouts launched the flash kernel")
    table = {name: {k: r[k] for k in ("ms", "launches", "device_ms", "rmse")} |
             {"peak_gb": r["peak"] / 1e9} for name, r in routes.items()}
    if fused9:
        table["fused (phase 9)"] = fused9
    log(f"[{tag}] per iteration, bf16, rank {ALS_RANK}: " + json.dumps(table))


# ---------------------------------------------------------------------------
# phase 34: the in-process device mesh (parallel/mesh.py) over the card
# ---------------------------------------------------------------------------

#: iterations of each timed ALS route (bench.py's 10 cut to 2: the phase's
#: budget is 60 s); the mesh shapes of DP×MP training
MESH_ALS_ITERS = 2
MESH_SHAPES = ((1, 4), (2, 2))
#: sharded against unsharded: RMSE (absolute), the f32 user half-step
#: (relative Frobenius on CG_CHECK_ROWS[0] rows), served scores
#: (absolute), the chunked layout's tables after one iteration (relative
#: Frobenius: index_add_ order)
MESH_RMSE_TOL, MESH_HALF_STEP_RTOL, MESH_SCORE_TOL, MESH_CHUNKED_RTOL = 1e-3, 1e-5, 1e-5, 1e-3
MESH_SERVE_BATCH, MESH_SERVE_K = 256, 100
MESH_ENGINE_QUERIES = 32
MESH_ML100K_AXES = {"data": 2, "model": 2}


def _mesh_devices() -> list[torch.device]:
    """4 mesh positions: 4 cards when there are, else 4 on the first card."""
    if DEVICE != "cuda":
        return [torch.device(DEVICE)] * 4
    if torch.cuda.device_count() >= 4:
        return [torch.device("cuda", i) for i in range(4)]
    return [torch.device("cuda", 0)] * 4


def _mesh(shape, devices=None) -> Mesh:
    devices = devices or _mesh_devices()
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid[: shape[0] * shape[1]].reshape(shape), ("data", "model"))


def _check_row_sharded(tag: str, table: ShardedArray, mesh: Mesh, rows: int) -> None:
    """Each shard of a row-sharded table on its position's device, with
    its share of the (padded) rows."""
    ways = mesh.axis_size("model")
    per = -(-rows // ways)
    if not (isinstance(table, ShardedArray) and table.spec[0] == "model"
            and table.ways("model") == ways and tuple(table.shape) == (rows, ALS_RANK)):
        fail(f"[{tag}] the table is not row-sharded {ways} ways: {table!r}")
    for pos in mesh.local_positions:
        shard = table.local(pos)
        lo = pmesh.axis_index(mesh, pos, "model") * per
        if shard.device != mesh.device(pos) or shard.shape[0] != max(0, min(per, rows - lo)):
            fail(f"[{tag}] shard at {pos} is {tuple(shard.shape)} on {shard.device}")


def _mesh_iterate(layouts, item0: torch.Tensor, iters: int, mesh: Mesh | None,
                  coo: als.RatingsCOO):
    """``iters`` bf16 fused iterations from ``item0``: unsharded, or over
    ``mesh`` with both tables row-sharded (padded to the "model" axis, the
    padding trimmed)."""
    lam, alpha = float(ALS_LAM), 40.0
    if mesh is None:
        return als._als_iterate_fused(item0, *layouts, iters, lam, alpha, False, bf16=True)
    ways = mesh.axis_size("model")
    n_u = coo.num_rows + (-coo.num_rows) % ways
    n_i = coo.num_cols + (-coo.num_cols) % ways
    padded = torch.cat([item0, item0.new_zeros((n_i - coo.num_cols, item0.shape[1]))])
    user, item = als._als_iterate_mesh(padded, *layouts, iters, lam, alpha, False, True, None,
                                       "cg", False, mesh, True, n_u, n_i)
    return user.head(coo.num_rows), item.head(coo.num_cols)


def _mesh_als(coo: als.RatingsCOO, devices) -> dict:
    """Phase 34a: fused DP×MP training at the ML-20M shape over 1×4 and
    2×2 meshes against the unsharded run; then the chunked layout on 2×2."""
    tag = "mesh/als"
    t_start = time.perf_counter()
    ladder = als.ladder_rows(coo), als.ladder_rows(coo.transpose())
    item0 = als.init_item_factors(coo.num_cols, ALS_RANK, SEED).to(DEVICE)
    t_packed = time.perf_counter()
    routes: dict[str, dict] = {}
    warm = tuple(als.stage_buckets(x, ALS_RANK, device=DEVICE) for x in ladder)
    _mesh_iterate(warm, item0, 1, None, coo)   # the first iteration of a process is slower
    del warm
    for name, mesh in [("unsharded", None)] + [
            (f"{d}x{m}", _mesh((d, m), devices)) for d, m in MESH_SHAPES]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        staged = tuple(als.stage_buckets(x, ALS_RANK, device=DEVICE, mesh=mesh) for x in ladder)
        ms, (user, item) = _events_ms(lambda: _mesh_iterate(staged, item0, MESH_ALS_ITERS,
                                                            mesh, coo))
        peak = torch.cuda.max_memory_allocated() - base
        err = als.rmse(als.ALSFactors(user, item), coo)
        routes[name] = {"mesh": mesh, "staged": staged, "user": user, "item": item,
                        "ms": ms / MESH_ALS_ITERS, "rmse": err, "peak_gb": peak / 1e9}
        log(f"[{tag}/{name}] bf16 fused, rank {ALS_RANK}, {MESH_ALS_ITERS} iterations: "
            f"ms_per_iteration={ms / MESH_ALS_ITERS:.3f} rmse={err:.6f} "
            f"peak_mem_gb={peak / 1e9:.3f}")
        if mesh is not None:
            _check_row_sharded(f"{tag}/{name}", user, mesh, coo.num_rows)
            _check_row_sharded(f"{tag}/{name}", item, mesh, coo.num_cols)
            off = abs(err - routes["unsharded"]["rmse"])
            if not off <= MESH_RMSE_TOL:
                fail(f"[{tag}/{name}] RMSE {err} is {off} from the unsharded run's")
    t_timed = time.perf_counter()
    for name, r in routes.items():   # after every timed run: the profiler slows what follows
        r["device_ms"], r["launches"] = _profile(
            lambda: _mesh_iterate(r["staged"], item0, 1, r["mesh"], coo), top=f"{tag}/{name}")
        log(f"[{tag}/{name}] one profiled iteration: launches={r['launches']} "
            f"device_ms={_fmt(r['device_ms'])}")
    t_profiled = time.perf_counter()
    # the f32 user half-step, from the unsharded run's items, on 4,096 rows
    rated, active = _row_locator(ladder[0])
    rows = np.random.default_rng(SEED + 34).choice(active, CG_CHECK_ROWS[0], replace=False)
    V = routes["unsharded"]["item"]
    idx = torch.from_numpy(rows).to(DEVICE)
    X_ref = als.solve_half(V, routes["unsharded"]["staged"][0], ALS_RANK, ALS_LAM,
                           matmul_dtype="float32", cg_matvec_dtype="float32")[idx]
    for name, r in routes.items():
        if r["mesh"] is None:
            continue
        X = als.solve_half(V, r["staged"][0], ALS_RANK, ALS_LAM, matmul_dtype="float32",
                           cg_matvec_dtype="float32", mesh=r["mesh"], shard_factors=True)
        off = (torch.linalg.vector_norm(X[idx].to(DEVICE) - X_ref)
               / torch.linalg.vector_norm(X_ref)).item()
        log(f"[{tag}/{name}] f32 user half-step on {len(rows)} rows against the unsharded one: "
            f"rel_err={off:.3e} (tol {MESH_HALF_STEP_RTOL:g})")
        if not off <= MESH_HALF_STEP_RTOL:
            fail(f"[{tag}/{name}] the f32 half-step is {off:.3e} from the unsharded one")
    table = {n: {k: r[k] for k in ("ms", "launches", "device_ms", "rmse", "peak_gb")}
             for n, r in routes.items()}
    log(f"[{tag}] per iteration, sharded beside unsharded: " + json.dumps(table))
    model_1x4 = {k: routes["1x4"][k] for k in ("mesh", "user", "item")}
    unsharded = {k: routes["unsharded"][k] for k in ("user", "item")}
    for r in routes.values():
        del r["staged"]
    del routes
    torch.cuda.empty_cache()
    t_checked = time.perf_counter()

    # the chunked layout, one iteration on 2×2, against chunked unsharded
    mesh = _mesh((2, 2), devices)
    chunks = als.chunk_rows(coo, LAYOUT_CHUNKS), als.chunk_rows(coo.transpose(), LAYOUT_CHUNKS)
    out = {}
    for name, m in (("unsharded", None), ("2x2", mesh)):
        staged = tuple(als.stage_chunks(c, ALS_RANK, device=DEVICE, mesh=m) for c in chunks)
        kw = dict(matmul_dtype="bfloat16", cg_matvec_dtype="auto", mesh=m, shard_factors=True)
        ms, (user, item) = _events_ms(lambda: (
            lambda u: (u, als.solve_half(u, staged[1], ALS_RANK, ALS_LAM, **kw)))(
                als.solve_half(item0, staged[0], ALS_RANK, ALS_LAM, **kw)))
        out[name] = (ms, user, item, als.rmse(als.ALSFactors(user, item), coo))
        del staged
    (ms_u, _, item_u, rmse_u), (ms_m, _, item_m, rmse_m) = out["unsharded"], out["2x2"]
    off = (torch.linalg.vector_norm(item_m - item_u) / torch.linalg.vector_norm(item_u)).item()
    log(f"[{tag}/chunked] one bf16 iteration: unsharded {ms_u:.3f} ms, 2x2 {ms_m:.3f} ms; "
        f"items rel_err={off:.3e} (tol {MESH_CHUNKED_RTOL:g}), rmse {rmse_u:.6f} / "
        f"{rmse_m:.6f}")
    if not (off <= MESH_CHUNKED_RTOL and abs(rmse_m - rmse_u) <= MESH_RMSE_TOL):
        fail(f"[{tag}/chunked] the 2x2 chunked iteration disagrees with the unsharded one")
    del out
    torch.cuda.empty_cache()
    log(f"[{tag}] seconds: packing {t_packed - t_start:.1f}, staging and timed routes "
        f"{t_timed - t_packed:.1f}, profiles {t_profiled - t_timed:.1f}, checks "
        f"{t_checked - t_profiled:.1f}, chunked {time.perf_counter() - t_checked:.1f}")
    return {"sharded": model_1x4, "unsharded": unsharded}


def _same_topk(tag: str, got, want, tol: float) -> None:
    """Values within ``tol``; indices equal where the score is finite,
    but for near-ties (a neighbour within ``tol``), whose last bits two
    products of other shapes may order differently; they are counted."""
    gv, gi = (x.to(DEVICE) for x in got)
    wv, wi = (x.to(DEVICE) for x in want)
    finite = torch.isfinite(wv)
    v_err = (gv[finite] - wv[finite]).abs().max().item() if finite.any() else 0.0
    gap = (wv[:, :-1] - wv[:, 1:]).abs()
    near = torch.zeros_like(finite)
    near[:, :-1] |= gap <= tol
    near[:, 1:] |= gap <= tol
    clear = finite & ~near
    same = bool((gi[clear] == wi[clear]).all()) and torch.equal(torch.isfinite(gv), finite)
    log(f"[{tag}] max_value_diff={v_err:.3e} (tol {tol:g}) indices_equal_where_finite={same} "
        f"near_ties={int((finite & near).sum())}")
    if v_err > tol or not same:
        fail(f"[{tag}] the sharded top-k disagrees with the flat path")


def _mesh_serving(trained: dict, coo: als.RatingsCOO, devices) -> None:
    """Phase 34b: the 1×4-trained model saved (``"sharded"`` in model.json),
    loaded onto a 1×4 serving mesh, B=256 queries through the sharded
    dispatch against ``recommend_topk`` on the unsharded model; phase 12's
    2M-item top-k sharded 4 ways against the flat path; a catalog whose
    shards hold fewer rows than k, and a batch that does not divide
    "data"."""
    tag = "mesh/serve"
    mesh = trained["sharded"]["mesh"]
    uix = np.random.default_rng(SEED + 341).choice(coo.num_rows, MESH_SERVE_BATCH,
                                                   replace=False)
    seen = _seen_lists(coo, uix)
    width = max(len(s) for s in seen.values())
    cols = np.zeros((MESH_SERVE_BATCH, width), dtype=np.int32)
    mask = np.zeros((MESH_SERVE_BATCH, width), dtype=np.float32)
    for j, u in enumerate(uix):
        cols[j, : len(seen[int(u)])] = seen[int(u)]
        mask[j, : len(seen[int(u)])] = 1.0
    model = ALSModel(rank=ALS_RANK, user_factors=trained["sharded"]["user"],
                     item_factors=trained["sharded"]["item"],
                     user_ids=EntityIdIxMap(BiMap({f"u{u}": u for u in range(coo.num_rows)})),
                     item_ids=EntityIdIxMap(BiMap({f"i{i}": i for i in range(coo.num_cols)})),
                     seen_by_user=seen)
    off = max((torch.linalg.vector_norm(trained["sharded"][s].gather() - t)
               / torch.linalg.vector_norm(t)).item() for s, t in trained["unsharded"].items())
    env = os.environ.get("PIO_SERVING_ANN_BUILD")
    os.environ["PIO_SERVING_ANN_BUILD"] = "0"   # the index is phase 22's, not this one's
    try:
        with tempfile.TemporaryDirectory(prefix="pio-mesh-") as d:
            t0 = time.perf_counter()
            model.save(d)
            with open(os.path.join(d, "model.json")) as f:
                sharded_meta = json.load(f).get("sharded")
            loaded = ALSModel.load(d, DEVICE, mesh=mesh)
            io_s = time.perf_counter() - t0
    finally:
        if env is None:
            os.environ.pop("PIO_SERVING_ANN_BUILD")
        else:
            os.environ["PIO_SERVING_ANN_BUILD"] = env
    log(f"[{tag}] saved and loaded in {io_s:.2f}s: model.json sharded={sharded_meta}; item "
        f"table {loaded.factor_shard_ways} ways; the 1x4 tables {off:.3e} (relative) from "
        f"the unsharded run's")
    if sharded_meta != {"axis": "model", "ways": 4} or loaded.factor_shard_ways != 4:
        fail(f"[{tag}] the 1x4 model did not persist or restore sharded")
    if not off <= MESH_HALF_STEP_RTOL:
        fail(f"[{tag}] the 1x4 tables are {off:.3e} from the unsharded run's")
    k = MESH_SERVE_K
    user_u, item_u = trained["unsharded"]["user"], trained["unsharded"]["item"]
    served = lambda: loaded.batch_topk(uix, cols, mask, None, k)  # noqa: E731
    flat = lambda: topk_ops.recommend_topk(  # noqa: E731
        user_u[torch.from_numpy(uix).to(DEVICE)], item_u,
        torch.from_numpy(cols).long().to(DEVICE), torch.from_numpy(mask).to(DEVICE),
        torch.ones(coo.num_cols, device=DEVICE), k)
    _same_topk(f"{tag}/ml20m", served(), flat(), MESH_SCORE_TOL)
    got_ms, want_ms = time_ms(served, warmup=2, n=10), time_ms(flat, warmup=2, n=10)
    log(f"[{tag}] B={MESH_SERVE_BATCH} k={k} over {coo.num_cols} items ({cols.shape[1]} seen "
        f"columns, from the host): the sharded dispatch {got_ms:.3f} ms, recommend_topk on "
        f"the unsharded model {want_ms:.3f} ms")

    # phase 12's catalog: B=256 × 2M items, k=10, sharded 4 ways
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    item_f = torch.randn((TOPK_ITEMS, ALS_RANK), generator=gen, device=DEVICE)
    uv = torch.randn((TOPK_BATCH, ALS_RANK), generator=gen, device=DEVICE)
    tcols = torch.randint(0, TOPK_ITEMS, (TOPK_BATCH, 32), generator=gen, device=DEVICE)
    tmask = (torch.rand((TOPK_BATCH, 32), generator=gen, device=DEVICE) < 0.5).float()
    allow = torch.ones((TOPK_ITEMS,), device=DEVICE)
    table = pmesh.device_put(item_f, pmesh.model_sharding(mesh))
    sharded = lambda: topk_ops.recommend_topk_sharded(uv, table, tcols, tmask, allow, 10,  # noqa: E731
                                                      mesh)
    flat = lambda: topk_ops.recommend_topk(uv, item_f, tcols, tmask, allow, 10)  # noqa: E731
    _same_topk(f"{tag}/2m", sharded(), flat(), 1e-4)
    s_ms, f_ms = time_ms(sharded, warmup=3, n=20), time_ms(flat, warmup=3, n=20)
    s_dev, s_n = _profile(sharded)
    f_dev, f_n = _profile(flat)
    log(f"[{tag}/2m] B={TOPK_BATCH} I={TOPK_ITEMS} k=10: sharded 4 ways ms={s_ms:.4f} "
        f"device_ms={_fmt(s_dev, 4)} launches={s_n}; flat ms={f_ms:.4f} "
        f"device_ms={_fmt(f_dev, 4)} launches={f_n}")
    del table, item_f
    torch.cuda.empty_cache()

    # k above a shard's rows (12 items, 3 a shard, k 10), B=5 on a 2-wide data axis
    small = torch.randn((12, ALS_RANK), generator=gen, device=DEVICE)
    q = torch.randn((5, ALS_RANK), generator=gen, device=DEVICE)
    c = torch.randint(0, 12, (5, 3), generator=gen, device=DEVICE)
    m = (torch.rand((5, 3), generator=gen, device=DEVICE) < 0.5).float()
    ones = torch.ones(12, device=DEVICE)
    mesh4 = _mesh((1, 4), devices)
    got = topk_ops.recommend_topk_sharded(q, small, c, m, ones, 10, mesh4)
    if tuple(got[0].shape) != (5, 10):
        fail(f"[{tag}] k above the shard rows gave {tuple(got[0].shape)}")
    _same_topk(f"{tag}/k>rows", got, topk_ops.recommend_topk(q, small, c, m, ones, 10),
               MESH_SCORE_TOL)
    _same_topk(f"{tag}/B=5 on 2x2", topk_ops.recommend_topk_sharded(
        q, small, c, m, ones, 10, _mesh((2, 2), devices)),
        topk_ops.recommend_topk(q, small, c, m, ones, 10), MESH_SCORE_TOL)


def _mesh_classification(devices) -> None:
    """Phase 34c: naive Bayes and logreg on phase 21's Covertype sample over
    a 4×1 data mesh against the unsharded fits."""
    tag = "mesh/class"
    rows, _, n_cls = COVTYPE
    X, y = covtype_data(rows, SEED + 21)
    sample = np.random.default_rng(SEED + 22).choice(rows, FOREST_SAMPLE, replace=False)
    Xs, ys = X[sample], y[sample]
    mesh = _mesh((4, 1), devices)
    naive_bayes.train_multinomial(Xs, ys, n_cls, mesh=mesh)   # warm: first calls are slower
    nb_ms, nb = _events_ms(lambda: naive_bayes.train_multinomial(Xs, ys, n_cls, mesh=mesh))
    nb1_ms, nb1 = _events_ms(lambda: naive_bayes.train_multinomial(Xs, ys, n_cls,
                                                                    device=DEVICE))
    exact = torch.equal(nb.log_prior, nb1.log_prior) and torch.equal(nb.log_theta,
                                                                      nb1.log_theta)
    lr_ms, lr = _events_ms(lambda: logreg.train_logreg(
        Xs, ys, n_cls, l2=LOGREG_L2, iterations=LOGREG_STEPS, lr=LOGREG_LR, mesh=mesh))
    lr1_ms, lr1 = _events_ms(lambda: logreg.train_logreg(
        Xs, ys, n_cls, l2=LOGREG_L2, iterations=LOGREG_STEPS, lr=LOGREG_LR, device=DEVICE))
    w_err = (torch.linalg.vector_norm(lr.weights - lr1.weights)
             / torch.linalg.vector_norm(lr1.weights)).item()
    log(f"[{tag}] {FOREST_SAMPLE} rows over a 4x1 data mesh: naive Bayes {nb_ms:.3f} ms "
        f"(unsharded {nb1_ms:.3f}), counts equal: {exact}; logreg {LOGREG_STEPS} Adam steps "
        f"{lr_ms:.3f} ms (unsharded {lr1_ms:.3f}), W rel_err={w_err:.3e} "
        f"(tol {LOGREG_W_RTOL:g})")
    if not exact or not w_err <= LOGREG_W_RTOL:
        fail(f"[{tag}] the data-parallel fits disagree with the unsharded ones")


def _mesh_engine(devices) -> None:
    """Phase 34d: run_train of the ML-100k recommendation engine with
    shardFactors and a 2×2 meshConf on a context given the 4 positions;
    the instance records the meshConf; load_deployed_engine onto a 2-way
    serving mesh; 32 answers against the same engine trained unsharded."""
    tag = "mesh/engine"
    n_users = ML100K[0]
    storage, _ = _ml100k_storage()
    algo = {"rank": 10, "numIterations": 10, "lambda": 0.01, "seed": 3}
    base = {"engineFactory": REC_FACTORY, "datasource": {"params": {"appName": "ML100k"}}}
    t0 = time.perf_counter()
    sharded = run_train(variant={**base, "meshConf": {"axes": MESH_ML100K_AXES},
                                 "algorithms": [{"name": "als",
                                                 "params": {**algo, "shardFactors": True}}]},
                        ctx=EngineContext(storage=storage, device=DEVICE, devices=devices))
    t1 = time.perf_counter()
    plain = run_train(variant={**base, "algorithms": [{"name": "als", "params": algo}]},
                      ctx=EngineContext(storage=storage, device=DEVICE))
    t2 = time.perf_counter()
    row = storage.get_meta_data_engine_instances().get(sharded.instance_id)
    trained_ways = sharded.models[0].factor_shard_ways
    log(f"[{tag}] run_train over {MESH_ML100K_AXES} {sharded.status} in {t1 - t0:.2f}s "
        f"(unsharded {plain.status} in {t2 - t1:.2f}s); instance mesh_conf={row.mesh_conf}; "
        f"trained item table {trained_ways} ways; stages: "
        f"{format_stage_times(sharded.stage_seconds)}")
    if (sharded.status, plain.status) != ("COMPLETED", "COMPLETED") or \
            row.mesh_conf != {"axes": MESH_ML100K_AXES} or trained_ways != 2:
        fail(f"[{tag}] the meshConf run did not train sharded and record its meshConf")
    served = load_deployed_engine(storage, ServerConfig(engine_instance_id=sharded.instance_id,
                                                        device=DEVICE),
                                  ctx=EngineContext(storage=storage, device=DEVICE,
                                                    devices=devices[:2]))
    one = load_deployed_engine(storage, ServerConfig(engine_instance_id=plain.instance_id,
                                                     device=DEVICE))
    ways = served.models[0].factor_shard_ways
    if ways != 2 or one.models[0].factor_shard_ways != 1:
        fail(f"[{tag}] the deploys restored {ways} / {one.models[0].factor_shard_ways} ways")
    diffs = {}
    for side in ("user", "item"):
        a, b = (_whole(getattr(m, f"{side}_factors")) for m in (served.models[0], one.models[0]))
        diffs[side] = (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()
    queries = [rec.Query(user=f"u{u}", num=(10, 20)[j % 2]) for j, u in enumerate(
        np.random.default_rng(SEED + 34).choice(n_users, MESH_ENGINE_QUERIES, replace=False))]
    t0 = time.perf_counter()
    got = [served.query(q) for q in queries]
    q_ms = (time.perf_counter() - t0) * 1e3 / len(queries)
    want = [one.query(q) for q in queries]
    worst, moved = 0.0, 0
    for a, b in zip(got, want):
        ia, ib = [s.item for s in a.item_scores], [s.item for s in b.item_scores]
        sa, sb = [s.score for s in a.item_scores], [s.score for s in b.item_scores]
        if len(ia) != len(ib):
            fail(f"[{tag}] answers of other lengths: {len(ia)} / {len(ib)}")
        worst = max([worst] + [abs(x - z) for x, z in zip(sa, sb)])
        moved += sum(x != z for x, z in zip(ia, ib))
    log(f"[{tag}] 2-way serving mesh ({ways} ways): {len(queries)} DeployedEngine.query "
        f"answers, {q_ms:.3f} ms each; tables from the unsharded run's (relative): "
        f"{json.dumps(diffs)}; max score diff {worst:.3e} (tol {MESH_SCORE_TOL:g}), "
        f"{moved} items in other places")
    if worst > MESH_SCORE_TOL or moved:
        fail(f"[{tag}] the sharded engine's answers differ from the unsharded engine's")


def _whole(table) -> torch.Tensor:
    """A factor table whole on the card, sharded or not."""
    return (table.gather() if isinstance(table, ShardedArray) else table).to(DEVICE)


def _mesh_quality(devices) -> None:
    """Phase 34e: compare_quality at ML-100k over a 2×2 mesh against mesh=None."""
    tag = "mesh/quality"
    ds = movielens.synthesize_ml100k()
    t0 = time.perf_counter()
    got = quality.compare_quality(ds, mesh=_mesh((2, 2), devices), device=DEVICE,
                                  **QUALITY_POINT)
    t1 = time.perf_counter()
    want = quality.compare_quality(ds, device=DEVICE, **QUALITY_POINT)
    t2 = time.perf_counter()
    off = abs(got["rmse_tpu"] - want["rmse_tpu"])
    log(f"[{tag}] compare_quality over 2x2 in {t1 - t0:.2f}s: {json.dumps(got)}; mesh=None "
        f"in {t2 - t1:.2f}s: {json.dumps(want)}; rmse_tpu off by {off:.3e} "
        f"(tol {MESH_RMSE_TOL:g})")
    if not off <= MESH_RMSE_TOL:
        fail(f"[{tag}] the mesh's RMSE is {off} from mesh=None's")


def phase_mesh() -> None:
    """Phase 34: the in-process mesh over the card (4 positions on the one
    card, or 4 cards): (a) DP×MP ALS at the ML-20M shape, (b) sharded
    persistence and serving, (c) the data-parallel classification fits,
    (d) the engine path with meshConf, (e) compare_quality over a mesh.
    Launches no flash kernel."""
    t_phase = time.perf_counter()
    flash_before = flash_ops.LAUNCHES
    devices = _mesh_devices()
    cards = len(set(devices))
    log(f"[mesh] mesh: {len(devices)} shards on {cards} card{'s' if cards > 1 else ''} "
        f"({', '.join(str(d) for d in devices)})")
    n_users, n_items, nnz = ML20M
    coo = als.RatingsCOO(*make_ratings(n_users, n_items, nnz, SEED), n_users, n_items)
    seconds = {}
    t0 = time.perf_counter()
    trained = _mesh_als(coo, devices)
    seconds["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _mesh_serving(trained, coo, devices)
    del trained
    torch.cuda.empty_cache()
    seconds["b"] = time.perf_counter() - t0
    for part, fn in (("c", _mesh_classification), ("d", _mesh_engine), ("e", _mesh_quality)):
        t0 = time.perf_counter()
        fn(devices)
        seconds[part] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    if flash_ops.LAUNCHES != flash_before:
        fail("[mesh] the mesh phase launched the flash kernel")
    log(f"[mesh] seconds by part: {json.dumps({k: round(v, 1) for k, v in seconds.items()})}; "
        f"the phase {time.perf_counter() - t_phase:.1f}s")


# ---------------------------------------------------------------------------
# phase 35: the sequence mesh and the multi-process mesh on the card
# ---------------------------------------------------------------------------

#: (a) ring attention at the long-context attention shape, over 4 "seq"
#: positions on the card, against the single-device blockwise route
RING_SHAPE, RING_SEQ = (4, 4, 4096, 64), 4
#: (b) TRAIN_LONG's Adam steps on each route, from one initial state
SEQ_MESH_STEPS = 4
SEQ_MESH_ROUTES = (("unsharded", None), ("1x4", {"data": 1, "seq": 4}),
                   ("2x2", {"data": 2, "seq": 2}), ("2x2-model", {"data": 2, "model": 2}))
#: the losses of (b) against the unsharded run's, relative: 10× the
#: largest reading of sound routes (1.07e-5, NVIDIA H100 80GB HBM3 at
#: 700 W); one Adam step moves the loss by 1e-3 to 3e-3 relative
SEQ_MESH_LOSS_RTOL = 1e-4
#: (c) the first users of 16a trained through run_train over a sequence
#: mesh at the serving width, then served
SEQ_ENGINE_USERS, SEQ_ENGINE_QUERIES = 16, 8
SEQ_ENGINE_AXES = {"data": 1, "seq": 4}
#: (d) two ranks on the card: their seconds (torch import, the ML-20M
#: ladders, the run) and the tables' relative Frobenius distance from the
#: in-process 2×2 run (the same solves; the write-back's cross-rank sum
#: adds each row to zeros)
DIST_CHILD_TIMEOUT_S = 420
DIST_TABLE_RTOL = 1e-6
#: bf16 routes computed two ways (ring against blockwise): the forward
#: within TOL[bf16], the gradients within TRAIN_GRAD_RTOL (relative
#: Frobenius); after the Adam steps of (b) the parameters' median
#: distance within lr/10 (tests/test_torch_seqrec_train.py's bf16 rule).
#: Their largest distance is logged, not bounded: a bf16 rounding that
#: turns a near-zero gradient's sign moves a parameter by up to lr a
#: step the other way, so sound routes reach 2·lr·steps


def _card() -> torch.device:
    return torch.device("cuda", 0) if DEVICE == "cuda" else torch.device(DEVICE)


def _card_mesh(axes: dict) -> Mesh:
    """``axes`` laid over the first card, one position each."""
    sizes = tuple(axes.values())
    grid = np.empty(math.prod(sizes), dtype=object)
    grid[:] = [_card()] * grid.size
    return Mesh(grid.reshape(sizes), tuple(axes))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def _dist_ring() -> None:
    """Phase 35a: ring attention over 4 "seq" positions on the card
    against blockwise attention on the same bf16 inputs (causal, rows of
    mixed real length): the output and the gradients of sum(out²); ms
    (CUDA events), launches and device ms of each, forward and
    forward+backward; peak memory."""
    from predictionio_tpu_torch.ops.attention import blockwise_attention, ring_attention_sharded

    tag = "dist/ring"
    B, H, S, D = RING_SHAPE
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 35)
    q, k, v = (x.requires_grad_() for x in qkv(B, H, S, D, torch.bfloat16, gen))
    mask = mixed_length_mask(B, S)
    mesh = _card_mesh({"seq": RING_SEQ})
    spec4 = pmesh.NamedSharding(mesh, (None, None, "seq", None))

    def ring():
        return ring_attention_sharded(*(pmesh.device_put(x, spec4) for x in (q, k, v)),
                                      pmesh.device_put(mask, pmesh.NamedSharding(mesh, (None, "seq"))))

    def block():
        return blockwise_attention(q, k, v, causal=True, kv_mask=mask, q_block=128)

    def grads(fn):
        q.grad = k.grad = v.grad = None
        out = fn()
        out = out.gather() if isinstance(out, ShardedArray) else out
        (out.float() ** 2).sum().backward()
        return [x.grad.clone() for x in (q, k, v)]

    with torch.no_grad():
        got, want = ring().gather(), block()
    fwd_err = (got.float() - want.float()).abs().max().item()
    atol, rtol = TOL[torch.bfloat16]
    fwd_ok = bool(torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    g_ring = grads(ring)
    ring_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    torch.cuda.reset_peak_memory_stats()
    g_block = grads(block)
    block_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    g_err = max(_rel(a, b) for a, b in zip(g_ring, g_block))
    times = {}
    for name, fn in (("ring", ring), ("blockwise", block)):
        with torch.no_grad():
            fwd_ms = time_ms(fn, warmup=2, n=5)
            fwd_dev, fwd_n = _profile(fn)
        bwd_ms = time_ms(lambda: grads(fn), warmup=1, n=3)
        bwd_dev, bwd_n = _profile(lambda: grads(fn))
        times[name] = {"fwd_ms": round(fwd_ms, 3), "fwd_launches": fwd_n,
                       "fwd_device_ms": fwd_dev and round(fwd_dev, 3),
                       "fwd_bwd_ms": round(bwd_ms, 3), "fwd_bwd_launches": bwd_n,
                       "fwd_bwd_device_ms": bwd_dev and round(bwd_dev, 3)}
    times["ring"]["peak_gb"], times["blockwise"]["peak_gb"] = round(ring_peak, 3), round(
        block_peak, 3)
    log(f"[{tag}] ({B},{H},{S},{D}) bf16 causal, mixed lengths, {RING_SEQ} seq positions on "
        f"one card against blockwise (q_block 128): output max_abs_err={fwd_err:.3e} "
        f"(tol {atol:g} + {rtol:g}·|x|), gradients of sum(out²) worst rel_err={g_err:.3e} "
        f"(tol {TRAIN_GRAD_RTOL:g})")
    log(f"[{tag}] " + json.dumps(times))
    if not fwd_ok or not g_err <= TRAIN_GRAD_RTOL:
        fail(f"[{tag}] ring attention disagrees with blockwise attention")
    q.grad = k.grad = v.grad = None


def _dist_training() -> None:
    """Phase 35b: TRAIN_LONG (vocab 50,000, S 4096, batch 4, bf16) for
    SEQ_MESH_STEPS Adam steps from one initial state: unsharded (the
    blockwise route), over {"data": 1, "seq": 4}, {"data": 2, "seq": 2}
    and {"data": 2, "model": 2} on the card; losses step by step and the
    final parameters against
    the unsharded run; step ms, launches and device ms of one more step,
    peak memory."""
    tag = "dist/train"
    cfg = _config(TRAIN_LONG)
    lr, batch = TRAIN_LONG["lr"], TRAIN_LONG["batch_size"]
    initial = seqrec.init_params(cfg, torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 351)
    batches = [tuple(torch.from_numpy(rng.integers(1, cfg.vocab, (batch, cfg.max_len))).to(DEVICE)
                     for _ in range(2)) for _ in range(SEQ_MESH_STEPS)]
    routes = {}
    for name, axes in SEQ_MESH_ROUTES:
        mesh = None if axes is None else _card_mesh(axes)
        model = seqrec.SeqRec(cfg, DEVICE)
        model.load_state_dict(initial)
        step = seqrec.make_train_step(model, mesh=mesh)
        opt_m, opt_v = seqrec.adam_state(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        losses, ms = [], []
        for it, (seqs, tgts) in enumerate(batches, 1):
            t, loss = _events_ms(lambda: step(opt_m, opt_v, it, seqs, tgts, lr))
            losses.append(loss.item())
            ms.append(t)
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        params = {k: p.detach().clone() for k, p in model.named_parameters()}
        dev_ms, launches = _profile(lambda: step(opt_m, opt_v, SEQ_MESH_STEPS + 1, *batches[0], lr))
        routes[name] = {"losses": losses, "params": params}
        log(f"[{tag}/{name}] {SEQ_MESH_STEPS} Adam steps: step_ms={[round(x, 3) for x in ms]} "
            f"(median of steps 2-{SEQ_MESH_STEPS} {statistics.median(ms[1:]):.3f}) "
            f"peak_mem_gb={peak:.3f} losses={losses}; one more step profiled: "
            f"launches={launches} device_ms={_fmt(dev_ms)}")
        if not all(math.isfinite(x) for x in losses):
            fail(f"[{tag}/{name}] a loss is not finite: {losses}")
        del model, step, opt_m, opt_v
        torch.cuda.empty_cache()
    want = routes["unsharded"]
    for name, r in routes.items():
        if name == "unsharded":
            continue
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], want["losses"]))
        diff = torch.cat([(r["params"][k] - want["params"][k]).abs().reshape(-1)
                          for k in want["params"]])
        worst, median, mean = diff.max().item(), diff.median().item(), diff.mean().item()
        log(f"[{tag}/{name}] against unsharded: losses worst rel_err={loss_err:.3e} (tol "
            f"{SEQ_MESH_LOSS_RTOL:g}); parameters median abs_diff={median:.3e} (tol "
            f"{lr / 10:g}), max={worst:.3e}, mean={mean:.3e}")
        if not (loss_err <= SEQ_MESH_LOSS_RTOL and median <= lr / 10):
            fail(f"[{tag}/{name}] training over the sequence mesh disagrees with unsharded")
    del routes, want
    torch.cuda.empty_cache()


def _dist_engine() -> int:
    """Phase 35c: 16a's first SEQ_ENGINE_USERS users through run_train
    with meshConf SEQ_ENGINE_AXES at the serving width, on a context given
    4 positions on the card; DeployedEngine.query serves it through the
    flash kernel, checked per answer against the plain attention, and the
    kernel held against its plain version on a served query's q/k/v.
    Returns the kernel's launches in serving."""
    tag = "dist/engine"
    _, length, stride = PIO_SESSION
    storage, n_events = _walk_storage(SEQ_ENGINE_USERS, length, stride)
    before = flash_ops.LAUNCHES
    t0 = time.perf_counter()
    outcome = run_train(variant={
        "engineFactory": "predictionio_tpu_torch.templates.sessionrec.engine_factory",
        "datasource": {"params": {"app_name": "SmokeApp"}},
        "meshConf": {"axes": SEQ_ENGINE_AXES},
        "algorithms": [{"name": "seqrec", "params": PIO_SESSION_TRAIN}],
    }, ctx=EngineContext(storage=storage, device=DEVICE, devices=[_card()] * 4))
    train_s = time.perf_counter() - t0
    row = storage.get_meta_data_engine_instances().get(outcome.instance_id)
    run = outcome.models[0].train_run
    log(f"[{tag}] {n_events} events, run_train over {SEQ_ENGINE_AXES} {outcome.status} in "
        f"{train_s:.2f}s (instance mesh_conf={row.mesh_conf}); steps={len(run.losses)} "
        f"step_ms={[round(s * 1e3, 3) for s in run.step_seconds]} losses={run.losses}; "
        f"stages: {format_stage_times(outcome.stage_seconds)}")
    if outcome.status != "COMPLETED" or row.mesh_conf != {"axes": SEQ_ENGINE_AXES}:
        fail(f"[{tag}] the meshConf run did not complete and record its meshConf")
    if flash_ops.LAUNCHES != before:
        fail(f"[{tag}] training launched the forward-only flash kernel")
    if not all(math.isfinite(x) for x in run.losses):
        fail(f"[{tag}] a loss is not finite: {run.losses}")
    deployed = load_deployed_engine(storage, ServerConfig(
        engine_instance_id=outcome.instance_id, device=DEVICE))
    model = deployed.models[0]
    served_from = flash_ops.LAUNCHES
    deployed.query(sessionrec.Query(user="u0", num=10))   # warm-up, outside the timed window
    before = flash_ops.LAUNCHES
    t0 = time.perf_counter()
    answers = [deployed.query(sessionrec.Query(user=f"u{u}", num=10))
               for u in range(SEQ_ENGINE_QUERIES)]
    q_ms = (time.perf_counter() - t0) * 1e3 / SEQ_ENGINE_QUERIES
    if flash_ops.LAUNCHES - before != SEQ_ENGINE_QUERIES * model.cfg.n_layers:
        fail(f"[{tag}] {SEQ_ENGINE_QUERIES} queries launched the flash kernel "
             f"{flash_ops.LAUNCHES - before} times")
    for u, answer in enumerate(answers):
        served = [(model.item_index[s.item], s.score) for s in answer.item_scores]
        tail = model.histories[f"u{u}"][-model.cfg.max_len:]
        agreement = _check_against_plain(model, tail, [], served, 10, f"{tag} u{u}")
        log(f"[{tag}] u{u}: {agreement}")
    # the kernel against its plain version on the first layer's q/k/v of a served query
    captured = []
    real = seqrec.flash_attention

    def capture(q, k, v, **kw):
        if not captured:
            captured.append((q, k, v, kw.get("kv_mask")))
        return real(q, k, v, **kw)

    seqrec.flash_attention = capture
    try:
        deployed.query(sessionrec.Query(user="u1", num=10))
    finally:
        seqrec.flash_attention = real
    launches = flash_ops.LAUNCHES - served_from   # every served query's, none of the check's
    q, k, v, kv_mask = captured[0]
    mask = (torch.ones(q.shape[0], q.shape[2], device=DEVICE) if kv_mask is None
            else kv_mask.float().contiguous())
    res = torch.empty_like(q)
    flash_ops._launch(q, k, v, mask, res, True)
    ref = flash_ops.flash_attention_reference(q, k, v, causal=True, kv_mask=mask)
    err = (res.float() - ref.float()).abs().max().item()
    atol, rtol = TOL[torch.bfloat16]
    log(f"[{tag}] {SEQ_ENGINE_QUERIES} DeployedEngine.query answers, {q_ms:.3f} ms each, "
        f"launches={launches} in serving ({model.cfg.n_layers} a query); the kernel on a "
        f"served query's "
        f"{tuple(q.shape)} q/k/v against the plain version: max_abs_err={err:.3e} (tol {atol:g} "
        f"+ {rtol:g}·|x|)")
    if not torch.allclose(res.float(), ref.float(), atol=atol, rtol=rtol):
        fail(f"[{tag}] the kernel disagrees with its plain version on a served query")
    return launches


def _dist_reference(coo: als.RatingsCOO, item0: torch.Tensor):
    """The in-process 2×2 fused run of phase 34 (bf16, shard_factors) on
    the children's ratings and initial table: the tables, whole on the card."""
    ladder = als.ladder_rows(coo), als.ladder_rows(coo.transpose())
    mesh = _card_mesh({"data": 2, "model": 2})
    staged = tuple(als.stage_buckets(x, ALS_RANK, mesh=mesh) for x in ladder)
    ms, (user, item) = _events_ms(lambda: _mesh_iterate(staged, item0, MESH_ALS_ITERS, mesh, coo))
    return ms / MESH_ALS_ITERS, user.gather(), item.gather()


def _start_dist_children(work: str) -> list:
    """The two ranks of phase 35d, each a fresh interpreter (the spawn
    rule: this process has initialized CUDA) in a session of its own."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PIO_NUM_HOSTS="2", PIO_HOST_INDEX=str(rank),
                   PIO_COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
        with open(os.path.join(work, f"rank{rank}.log"), "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-child", work],
                env=env, stdout=out, stderr=subprocess.STDOUT, start_new_session=True))
    return procs


def _stop_dist_children(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGKILL)
        p.wait()


def _join_dist_children(work: str, procs: list, coo: als.RatingsCOO,
                        item0: torch.Tensor) -> None:
    """Phase 35d: the reference, then the children's go; their logs, their
    numbers and their tables against the reference."""
    tag = "dist/ranks"
    ref_ms, user_ref, item_ref = _dist_reference(coo, item0)
    log(f"[{tag}] the in-process 2x2 reference: {ref_ms:.3f} ms an iteration")
    for rank in range(2):   # their host work (import, ladders) overlapped phases 35a-c
        _lane_get(work, f"ready{rank}", lambda: all(p.poll() is None for p in procs))
    t0 = time.perf_counter()
    _lane_put(work, "go", {})
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=DIST_CHILD_TIMEOUT_S))
        except subprocess.TimeoutExpired:
            rcs.append(None)
    for rank in range(2):
        with open(os.path.join(work, f"rank{rank}.log")) as f:
            for line in f.read().splitlines():
                log(f"[{tag}/rank{rank}] {line}")
    if rcs != [0, 0]:
        fail(f"[{tag}] the ranks exited {rcs}; their logs are above")
    results = [_lane_get(work, f"result{rank}", lambda: True) for rank in range(2)]
    for rank, r in enumerate(results):
        user, item = (torch.load(os.path.join(work, f"{side}{rank}.pt")).to(DEVICE)
                      for side in ("user", "item"))
        r["user_rel"], r["item_rel"] = _rel(user, user_ref), _rel(item, item_ref)
        r["max_abs_diff"] = max((user - user_ref).abs().max().item(),
                                (item - item_ref).abs().max().item())
    log(f"[{tag}] two ranks over gloo, 2 positions each on the card, after the go: "
        f"{time.perf_counter() - t0:.1f}s; per rank: " + json.dumps(results))
    if not all(r["user_rel"] <= DIST_TABLE_RTOL and r["item_rel"] <= DIST_TABLE_RTOL
               for r in results):
        fail(f"[{tag}] the two-rank tables differ from the in-process 2x2 run's")


def dist_child(work: str) -> None:
    """One rank of phase 35d (``--dist-child DIR``): joins the gloo group
    over the PIO_* contract without initializing CUDA, packs the ML-20M
    ladders, waits for the go, then runs the cross-rank psum and the
    fused 2×2 ``shard_factors`` ALS (bf16, rank 32) on its two positions
    of the card; writes its tables and numbers to DIR."""
    from predictionio_tpu_torch.parallel import distributed

    t0 = time.perf_counter()
    if not distributed.maybe_initialize_distributed():
        fail("PIO_NUM_HOSTS=2 did not join the group")
    if torch.cuda.is_initialized():
        fail("joining the group initialized CUDA")
    import torch.distributed as dist

    rank = dist.get_rank()
    devices, owners = distributed.global_devices([_card()] * 2)
    devices, owners = np.array(devices, dtype=object), np.array(owners)
    log(f"rank {rank}: backend {distributed.BACKEND}, devices {[str(d) for d in devices]} "
        f"owned by {owners.tolist()}, joined in {time.perf_counter() - t0:.1f}s")
    n_users, n_items, nnz = ML20M
    coo = als.RatingsCOO(*make_ratings(n_users, n_items, nnz, SEED), n_users, n_items)
    ladder = als.ladder_rows(coo), als.ladder_rows(coo.transpose())
    item0 = als.init_item_factors(coo.num_cols, ALS_RANK, SEED)
    _lane_put(work, f"ready{rank}", {})
    _lane_get(work, "go", lambda: True)
    t_go = time.perf_counter()
    mesh4 = Mesh(devices, ("data",), ranks=owners)
    arr = pmesh.device_put_local(pmesh.NamedSharding(mesh4, ("data",)),
                                 torch.full((2, 4), float(rank + 1)), (4, 4))
    total = pmesh.psum(pmesh.local_map(mesh4, lambda x: x.sum(0), arr), "data").local(mesh4.home)
    if total.device != _card() or not torch.equal(total.cpu(), torch.full((4,), 6.0)):
        fail(f"rank {rank}: the cross-rank psum gave {total}")
    mesh = Mesh(devices.reshape(2, 2), ("data", "model"), ranks=owners.reshape(2, 2))
    staged = tuple(als.stage_buckets(x, ALS_RANK, mesh=mesh) for x in ladder)
    item0 = item0.to(DEVICE)
    _mesh_iterate(staged, item0, 1, mesh, coo)   # the first iteration of a process is slower
    for key in pmesh.COMM:
        pmesh.COMM[key] = 0 if key != "seconds" else 0.0
    ms, (user, item) = _events_ms(lambda: _mesh_iterate(staged, item0, MESH_ALS_ITERS, mesh, coo))
    comm = dict(pmesh.COMM)
    device_ms, launches = _profile(lambda: _mesh_iterate(staged, item0, 1, mesh, coo))
    _check_row_sharded(f"rank{rank}", user, mesh, coo.num_rows)
    for side, table in (("user", user), ("item", item)):
        torch.save(table.gather().cpu(), os.path.join(work, f"{side}{rank}.pt"))
    _lane_put(work, f"result{rank}", {
        "ms_per_iteration": round(ms / MESH_ALS_ITERS, 3), "launches_per_iteration": launches,
        "device_ms_per_iteration": device_ms and round(device_ms, 3),
        "collectives": comm["calls"], "collective_s": round(comm["seconds"], 3),
        "host_staged_mb": round(comm["host_bytes"] / 1e6, 1),
        "seconds_after_go": round(time.perf_counter() - t_go, 1),
        "seconds": round(time.perf_counter() - t0, 1)})
    log(f"rank {rank}: psum 6.0 on the card; {MESH_ALS_ITERS} fused 2x2 iterations "
        f"{ms / MESH_ALS_ITERS:.3f} ms each; collectives {comm}")


def phase_dist() -> int:
    """Phase 35: the sequence mesh and the multi-process mesh on the card:
    (a) ring attention, (b) long-context training over two sequence
    meshes, (c) the engine trained over a sequence mesh and served through
    the flash kernel, (d) two ranks on the card (started first, so that
    their host work overlaps a-c). Returns the flash launches of (c)."""
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="pio-dist-")
    procs = _start_dist_children(work)
    seconds = {}
    try:
        for part, fn in (("a", _dist_ring), ("b", _dist_training)):
            t0 = time.perf_counter()
            fn()
            seconds[part] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launches = _dist_engine()
        seconds["c"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        n_users, n_items, nnz = ML20M
        coo = als.RatingsCOO(*make_ratings(n_users, n_items, nnz, SEED), n_users, n_items)
        item0 = als.init_item_factors(coo.num_cols, ALS_RANK, SEED).to(DEVICE)
        _join_dist_children(work, procs, coo, item0)
        seconds["d"] = time.perf_counter() - t0
    finally:
        _stop_dist_children(procs)
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[dist] seconds by part: {json.dumps({k: round(v, 1) for k, v in seconds.items()})}; "
        f"the phase {time.perf_counter() - t_phase:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# phase 36: the launchers, the port's tarball and its walk-throughs
# ---------------------------------------------------------------------------

#: the walk-throughs phase 36 runs verbatim from the unpacked tarball,
#: sessionrec first (its deploy builds the kernel into the tree)
QUICKSTART_DOCS = ("quickstart-sessionrec.md", "quickstart-recommendation.md")
#: pio-start-all's ports. They and the walk-throughs' (27172-29178) lie
#: below the loopback ephemeral range (32768-60999) from which every other
#: server of this script takes its port (port 0, `_free_ports`)
QUICKSTART_STACK = {"PIO_EVENTSERVER_PORT": "27070", "PIO_ADMINSERVER_PORT": "27071",
                    "PIO_DASHBOARD_PORT": "29000"}
QUICKSTART_DIR = os.path.dirname(os.path.abspath(__file__))


def _quickstart_env(tree: str, base: str) -> dict:
    """The environment of a user's shell in the unpacked tree: nothing of
    this checkout on the path, no storage or device settings, logs and
    pidfiles under ``base``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_", "PYTHON")) and k != "DEVICE"}
    env.update(QUICKSTART_STACK, PIO_PID_DIR=base, PIO_LOG_DIR=base,
               PIO_FS_BASEDIR=os.path.join(base, "stack-store"))
    return env


def _end_session(pid: int) -> None:
    """SIGTERM, then SIGKILL, to every process left in ``pid``'s session."""
    for sig in (signal.SIGTERM, signal.SIGKILL):
        try:
            os.killpg(pid, sig)
        except ProcessLookupError:
            return
        time.sleep(1.0)


def _session(cmd: list[str], cwd: str, env: dict, stdin: str | None = None,
             keep: bool = False) -> tuple[int | None, str, str, int]:
    """``cmd`` in a session of its own: (exit code, None on a timeout;
    stdout; stderr; the session's id). Unless ``keep``, every process
    left in the session is stopped when it ends."""
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, text=True, start_new_session=True,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    try:
        out, err = proc.communicate(input=stdin, timeout=PIO_STEP_TIMEOUT)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        rc, err = None, err + f"\n(timed out after {PIO_STEP_TIMEOUT}s)"
    finally:
        if not keep:
            _end_session(proc.pid)
    return rc, out, err, proc.pid


def _quickstart_stack(tag: str, tree: str, env: dict, during: Callable[[], object]
                      ) -> tuple[dict, object]:
    """pio-start-all from the tree, the event server alive on ``/``, a
    shell bound from the tree (and no JAX package reachable), then
    ``during()`` with the stack up, then pio-stop-all: (seconds by step,
    what ``during`` returned)."""
    seconds = {}
    t0 = time.perf_counter()
    rc, out, err, session = _session([os.path.join(tree, "bin_torch", "pio-start-all")], tree,
                                     env, keep=True)
    try:
        seconds["pio-start-all"] = time.perf_counter() - t0
        if rc != 0:
            fail(f"[{tag}] pio-start-all exited {rc}:\n{out}\n{err}")
        port = int(env["PIO_EVENTSERVER_PORT"])
        deadline = time.monotonic() + 60
        while True:
            try:
                alive = _get(port, "/")
                break
            except OSError:
                if time.monotonic() > deadline:
                    fail(f"[{tag}] the event server never answered on :{port}")
                time.sleep(0.2)
        if alive != (200, {"status": "alive"}):
            fail(f"[{tag}] the event server's GET / answered {alive}")
        log(f"[{tag}] pio-start-all from the tree: {out.strip()!r}; GET / on :{port} "
            f"answered {json.dumps(alive[1])}")
        t0 = time.perf_counter()
        probe = ("import importlib.util, predictionio_tpu_torch\n"
                 "print('port at', predictionio_tpu_torch.__file__)\n"
                 "print('jax package', importlib.util.find_spec('predictionio_tpu'))\n")
        rc, out, err, _ = _session([os.path.join(tree, "bin_torch", "pio-shell")],
                                   tempfile.gettempdir(), env, stdin=probe)
        seconds["pio-shell"] = time.perf_counter() - t0
        want = [f"predictionio_tpu_torch {__version__} shell",
                "bound: storage (Storage.default()), EventStore",
                f"port at {os.path.join(tree, 'predictionio_tpu_torch', '__init__.py')}",
                "jax package None"]
        if rc != 0 or out.splitlines() != want:
            fail(f"[{tag}] pio-shell from the tree (rc {rc}):\n{out}\n{err[-2000:]}")
        log(f"[{tag}] pio-shell binds storage from {tree}; the JAX package is not on its path")
        result = during()
    finally:
        t0 = time.perf_counter()
        rc, out, err, _ = _session([os.path.join(tree, "bin_torch", "pio-stop-all")], tree, env)
        seconds["pio-stop-all"] = time.perf_counter() - t0
        _end_session(session)
    if "Stopped eventserver" not in out or os.path.exists(
            os.path.join(env["PIO_PID_DIR"], "eventserver.pid")):
        fail(f"[{tag}] pio-stop-all (rc {rc}):\n{out}\n{err}")
    return seconds, result


def _walkthrough(tag: str, tree: str, env: dict, doc: str, base: str
                 ) -> tuple[dict, dict, dict, tuple[str, str]]:
    """``docs_torch/<doc>`` verbatim in one bash from the tree (under the
    docs test's preamble), the time marked before each block, and ``GET
    /`` and ``/stats.json`` of its deploy read before its tear-down block:
    (seconds by block, the status page, the stats, (the document's store,
    its working directory))."""
    with open(os.path.join(tree, "docs_torch", doc)) as f:
        blocks = re.findall(r"```bash\n(.*?)```", f.read(), re.S)
    stem = doc.removesuffix(".md")
    marks, dirs = (os.path.join(base, f"{stem}.{n}") for n in ("marks", "dirs"))
    status_path, stats_path = (os.path.join(base, f"{stem}.{n}.json") for n in ("status", "stats"))
    teardown = re.match(r"pio undeploy --port (\d+)", blocks[-1])
    if teardown is None:
        fail(f"[{tag}] {doc}: its last block is no tear-down: {blocks[-1]!r}")
    script = "set -euo pipefail\ntrap 'kill $(jobs -p) 2>/dev/null || true' EXIT\n"
    for i, block in enumerate(blocks):
        if i == len(blocks) - 1:
            port = teardown.group(1)
            script += (f'curl -sf localhost:{port}/ > "{status_path}"\n'
                       f'curl -sf localhost:{port}/stats.json > "{stats_path}"\n')
        script += f'echo "{i} $(date +%s.%N)" >> "{marks}"\n{block}\n'
    script += (f'echo "end $(date +%s.%N)" >> "{marks}"\n'
               f'printf "%s\\n%s\\n" "$PIO_FS_BASEDIR" "$WORK" > "{dirs}"\n')
    rc, out, err, _ = _session(["bash", "-c", script], tree, env)
    if rc != 0:
        fail(f"[{tag}] {doc} exited {rc} from the tree:\n--- stdout:\n{out[-3000:]}\n"
             f"--- stderr:\n{err[-3000:]}")
    with open(marks) as f:
        stamps = [float(line.split()[1]) for line in f]
    firsts = [re.sub(r"\s+# .*", "", block.splitlines()[0])[:48] for block in blocks]
    seconds = {f"{i}: {first}": stamps[i + 1] - stamps[i] for i, first in enumerate(firsts)}
    with open(status_path) as f:
        status = json.load(f)
    with open(stats_path) as f:
        stats = json.load(f)
    with open(dirs) as f:
        store, work = f.read().splitlines()
    return seconds, status, stats, (store, work)


def phase_quickstart(docs: bool = False) -> int:
    """Phase 36: (a) make-distribution-torch.sh into a temporary directory
    outside the checkout, the tarball unpacked there; (b) pio-start-all,
    the event server's GET /, pio-shell and, at the end, pio-stop-all
    from the unpacked tree; (c) docs_torch's sessionrec and recommendation
    walk-throughs run verbatim there, each in one bash, with the tree as
    the working directory and nothing of this checkout on the path, so
    that `pio train` and `pio deploy` run on the card; (d) the kernel's
    library built by the sessionrec deploy from the tree's own csrc/ into
    the tree's own build/; (e) that deploy's kernel launches, from its
    GET /; (f) the seconds of every step, of the build and of the phase.
    With ``docs``, phase 37 (:func:`phase_docs`) follows (e) on the same
    tree, stack and walk-through stores. Returns the launches of (e) and
    of phase 37."""
    tag = "quickstart"
    base = tempfile.mkdtemp(prefix="pio-quickstart-")
    seconds: dict[str, float] = {}
    walked: list[str] = []      # the walk-throughs' own temporary directories
    try:
        t0 = time.perf_counter()
        made = subprocess.run([os.path.join(QUICKSTART_DIR, "make-distribution-torch.sh"),
                               os.path.join(base, "dist")],
                              capture_output=True, text=True, timeout=300)
        if made.returncode != 0:
            fail(f"[{tag}] make-distribution-torch.sh exited {made.returncode}:\n"
                 f"{made.stdout}\n{made.stderr}")
        tarball = made.stdout.strip().splitlines()[-1]
        unpacked = os.path.join(base, "unpacked")
        os.makedirs(unpacked)
        subprocess.run(["tar", "-xzf", tarball, "-C", unpacked], check=True, timeout=300)
        tree = os.path.join(unpacked, os.listdir(unpacked)[0])
        seconds["(a) tarball made and unpacked"] = time.perf_counter() - t0
        top = sorted(os.listdir(tree))
        if top != sorted(["README.md", "bin_torch", "conf", "docs_torch",
                          "predictionio_tpu_torch", "pyproject.toml"]):
            fail(f"[{tag}] the tarball holds {top}")
        log(f"[{tag}] {os.path.basename(tarball)} ({os.path.getsize(tarball)} bytes) unpacked "
            f"into {tree}: {', '.join(top)}")
        env = _quickstart_env(tree, base)

        def walk_and_docs() -> int:
            launches, dirs = 0, {}
            for doc in QUICKSTART_DOCS:
                t0 = time.perf_counter()
                steps, status, stats, dirs[doc] = _walkthrough(tag, tree, env, doc, base)
                walked.extend(dirs[doc])
                seconds[f"(c) {doc}"] = time.perf_counter() - t0
                log(f"[{tag}] {doc} ran verbatim from the tree on the card; seconds by block: "
                    + json.dumps({k: round(v, 3) for k, v in steps.items()}))
                built = stats.get("compile", {})
                log(f"[{tag}] {doc}: its deploy (instance {status['engineInstanceId']}) "
                    f"kernelLaunches={json.dumps(status['kernelLaunches'])} "
                    f"compile={json.dumps(built)}")
                if doc != "quickstart-sessionrec.md":
                    continue
                # (d) the kernel's library, built by this deploy from the tree's csrc/
                src = os.path.join(tree, "predictionio_tpu_torch", "csrc", "flash_attention.cu")
                with open(src, "rb") as f:
                    digest = hashlib.sha256(f.read() + " ".join(_build.NVCC_FLAGS).encode())
                lib = os.path.join(tree, "build", "kernels",
                                   f"libflash_attention-{digest.hexdigest()[:16]}.so")
                if not os.path.exists(lib) or \
                        built.get("byFunction", {}).get("flash_attention") != 1:
                    fail(f"[{tag}] the deploy did not build {lib} from {src}: "
                         f"{os.listdir(os.path.dirname(lib)) if os.path.isdir(os.path.dirname(lib)) else 'no build/kernels'}, "
                         f"compile {built}")
                seconds["(d) the kernel's build in the deploy"] = built["compileSeconds"]
                log(f"[{tag}] the deploy built {os.path.relpath(lib, tree)} from "
                    f"{os.path.relpath(src, tree)} in {built['compileSeconds']:.3f}s")
                # (e) the deploy's launches: one a query and layer
                launches = status["kernelLaunches"]["flash_attention"]
                if launches < 1:
                    fail(f"[{tag}] the sessionrec deploy never launched the flash kernel")
            if docs:
                launches += phase_docs(tree, env, base, dirs)
            return launches

        stack_seconds, launches = _quickstart_stack(tag, tree, env, walk_and_docs)
        for step, s in stack_seconds.items():
            seconds[f"(b) {step}"] = s
    finally:
        for path in [base, *walked]:
            shutil.rmtree(path, ignore_errors=True)
    for step, s in seconds.items():
        log(f"[phases] phase 36 {step} took {s:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# phase 37: the operator documents against live servers on the card
# ---------------------------------------------------------------------------

#: the deploys' ports (the documents' 8000, substituted), below the
#: loopback ephemeral range like phase 36's
DOCS_POOL_PORT, DOCS_ONLINE_PORT = 28400, 28410
#: the workers of the documented pool command, and its queries (distinct,
#: each on a fresh connection, so that the kernel spreads them)
DOCS_POOL_WORKERS, DOCS_POOL_QUERIES = 4, 24
#: seconds the online deploy may take to fold one new rating
DOCS_FOLD_WAIT_S = 30.0
#: the conditions of the documents' "present" column each live server
#: meets in this phase
DOCS_POOL_MEETS = frozenset({"always", "--workers", "card"})
DOCS_ONLINE_MEETS = frozenset({"always", "--online", "card", "after a fold"})
DOCS_EVENT_MEETS = frozenset({"always", "after ingest"})


def _doc_text(tree: str, doc: str) -> str:
    with open(os.path.join(tree, "docs_torch", doc)) as f:
        return f.read()


def _doc_command(tree: str, doc: str, pattern: str, port: int) -> str:
    """The first command line of a code block of ``doc`` that matches
    ``pattern`` (continuation lines joined), its port 8000 replaced by
    ``port``, its trailing comment dropped."""
    for block in re.findall(r"```\w*\n(.*?)```", _doc_text(tree, doc), re.S):
        for line in re.sub(r"\\\n\s*", " ", block).splitlines():
            line = re.sub(r"\s+#.*$", "", line).strip()
            if re.match(pattern, line):
                return re.sub(r"--port 8000\b", f"--port {port}", line)
    fail(f"[docs] {doc} has no command line matching {pattern!r}")


def _doc_table(tree: str, doc: str, header: str) -> list[list[str]]:
    """The rows of the table of ``doc`` whose header row starts with
    ``header``, each a list of cells with backticks stripped."""
    lines = _doc_text(tree, doc).splitlines()
    for i, line in enumerate(lines):
        if line.startswith(header):
            rows = []
            for row in lines[i + 2:]:
                if not row.startswith("|"):
                    break
                rows.append([c.strip().strip("`") for c in row.strip().strip("|").split("|")])
            return rows
    fail(f"[docs] {doc} has no table headed {header!r}")


def _doc_names(rows: list[list[str]], server: str, meets: set[str]) -> list[str]:
    """The names (first column) of ``rows`` whose server column names
    ``server`` and whose present column is a condition ``meets`` holds."""
    return [row[0] for row in rows
            if server in [s.strip() for s in row[-3].split(",")] and row[-2] in meets]


def _families(port: int) -> set[str]:
    """The families of a server's ``/metrics``."""
    status, body, _ = _request(port, "GET", "/metrics")
    if status != 200:
        fail(f"[docs] GET /metrics on :{port} answered {status}")
    return set(parse_prometheus(body.decode()))


def _hold_documented(tag: str, port: int, families: list[str], keys: list[str]) -> None:
    """``/metrics`` has every family of ``families`` and ``/stats.json``
    every key of ``keys``."""
    have = _families(port)
    missing = [f for f in families if f not in have]
    status, stats = _get(port, "/stats.json")
    lost = [k for k in keys if k not in stats]
    if missing or lost or status != 200:
        fail(f"[{tag}] /metrics lacks the documented families {missing}; /stats.json "
             f"({status}) lacks the documented keys {lost}")
    log(f"[{tag}] /metrics has the {len(families)} documented families and /stats.json the "
        f"{len(keys)} documented keys ({len(have)} families exported)")


def _docs_process(line: str, tree: str, env: dict, cwd: str, out_path: str
                  ) -> subprocess.Popen:
    """A documented command line in a bash of its own session, the tree's
    bin_torch first on PATH, output to ``out_path``."""
    env = {**env, "PATH": f"{os.path.join(tree, 'bin_torch')}:{env.get('PATH', '')}"}
    with open(out_path, "w") as out:
        return subprocess.Popen(["bash", "-c", f"exec {line}"], cwd=cwd, env=env,
                                stdout=out, stderr=subprocess.STDOUT, start_new_session=True)


def _docs_listening(tag: str, proc: subprocess.Popen, out_path: str) -> int:
    deadline = time.monotonic() + PIO_STEP_TIMEOUT
    while True:
        with open(out_path) as f:
            text = f.read()
        found = re.search(r"listening on [\d.]+:(\d+)", text)
        if found:
            return int(found.group(1))
        if proc.poll() is not None or time.monotonic() > deadline:
            fail(f"[{tag}] the documented deploy did not come up:\n{text[-3000:]}")
        time.sleep(0.1)


def _docs_event_server(tag: str, env: dict, metrics: list[list[str]],
                       keys: list[list[str]]) -> None:
    """pio-start-all's event server: an app made through the stack's admin
    server, events in two distinct seconds, the documented families on
    /metrics, and /stats.json without --stats answering the documented 404."""
    es, admin = int(env["PIO_EVENTSERVER_PORT"]), int(env["PIO_ADMINSERVER_PORT"])
    status, made, _ = _http(admin, "POST", "/cmd/app", {"name": "DocsApp"})
    if status != 201:
        fail(f"[{tag}] the admin server's POST /cmd/app answered {status}: {made}")
    key = made["accessKey"]
    for i in range(3):
        batch = [{"event": "view", "entityType": "user", "entityId": f"u{i}",
                  "targetEntityType": "item", "targetEntityId": f"i{j}"} for j in range(5)]
        status, body, _ = _http(es, "POST", f"/batch/events.json?accessKey={key}", batch)
        if status != 200 or any(r["status"] != 201 for r in body):
            fail(f"[{tag}] a batch to the event server answered {status}: {body}")
        time.sleep(1.1)
    families = _doc_names(metrics, "event", DOCS_EVENT_MEETS)
    missing = [f for f in families if f not in _families(es)]
    status, body = _get(es, f"/stats.json?accessKey={key}")
    if missing or status != 404 or "--stats" not in body.get("message", ""):
        fail(f"[{tag}] the event server's /metrics lacks the documented families {missing}; "
             f"/stats.json without --stats answered {status} {body}")
    documented = [k for k, servers, present, _ in keys if "event" in servers]
    log(f"[{tag}] pio-start-all's event server: {len(families)} documented families on "
        f"/metrics after 15 events in 3 batches; /stats.json without --stats answers 404 "
        f"(its {len(documented)} documented keys need --stats)")


def phase_docs(tree: str, env: dict, base: str, walks: dict[str, tuple[str, str]]) -> int:
    """Phase 37: the operator documents of ``docs_torch/`` against live
    servers on the card, from the unpacked ``tree`` of phase 36, beside
    its stack (pio-start-all) and over its walk-throughs' stores: (a) the
    documented command lines run verbatim, the deploys' port 8000
    replaced: observability.md's `pio train --profile` in the
    recommendation walk-through's directory, serving-performance.md's
    pool deploy (`--workers 4 --supervise ...`) of the sessionrec
    walk-through's instance, freshness.md's `pio deploy --online` of the
    recommendation instance; (b) queries to each deploy, a rating folded
    by the online deploy, then every metric family and /stats.json key
    that observability.md's and serving-performance.md's catalogs name
    for that server and condition, present on its /metrics and
    /stats.json, and the same for pio-start-all's event server; no
    deploy or train on the CPU; (c) the seconds of each step and the
    pool's flash launches, read worker by worker. Returns those
    launches."""
    tag = "docs"
    t_phase = time.perf_counter()
    seconds: dict[str, float] = {}
    metrics = _doc_table(tree, "observability.md", "| family | type | server | present |")
    keys = _doc_table(tree, "serving-performance.md", "| key | server | present |")
    seq_store, seq_work = walks["quickstart-sessionrec.md"]
    rec_store, rec_work = walks["quickstart-recommendation.md"]
    seq_env = {**env, "PIO_FS_BASEDIR": seq_store, "TMPDIR": os.path.join(base, "pool-tmp")}
    rec_env = {**env, "PIO_FS_BASEDIR": rec_store}
    os.makedirs(seq_env["TMPDIR"])
    train_line = _doc_command(tree, "observability.md", r"pio train --profile", 0)
    pool_line = _doc_command(tree, "serving-performance.md",
                             rf"pio deploy .*--workers {DOCS_POOL_WORKERS}\b", DOCS_POOL_PORT)
    online_line = _doc_command(tree, "freshness.md", r"pio deploy --port 8000 --online$",
                               DOCS_ONLINE_PORT)
    procs: list[subprocess.Popen] = []
    try:
        # (a) the pool first (its siblings take longest to start), the
        # profiled train beside it, then the online deploy of what it trained
        t_pool = time.perf_counter()
        pool = _docs_process(pool_line, tree, seq_env, seq_work, os.path.join(base, "pool.out"))
        procs.append(pool)
        t0 = time.perf_counter()
        train = _docs_process(train_line, tree, rec_env, rec_work, os.path.join(base, "train.out"))
        procs.append(train)
        train.wait(timeout=PIO_STEP_TIMEOUT)
        seconds[f"(a) `{train_line}`"] = time.perf_counter() - t0
        with open(os.path.join(base, "train.out")) as f:
            train_out = f.read()
        report_path = os.path.join(rec_work, "TRAIN_REPORT.json")
        if train.returncode != 0 or not os.path.exists(report_path):
            fail(f"[{tag}] `{train_line}` exited {train.returncode}:\n{train_out[-3000:]}")
        with open(report_path) as f:
            report = json.load(f)
        peak = (report.get("hbm") or {}).get("peakBytes")
        if report.get("schema") != "pio.train_report.v1" or not peak:
            fail(f"[{tag}] TRAIN_REPORT.json is not a report of a run on the card: "
                 f"schema {report.get('schema')}, hbm {report.get('hbm')}")
        traces = os.listdir(os.path.join(rec_work, "traces"))
        log(f"[{tag}] `{train_line}` on the card: {train_out.strip().splitlines()[-1]}; "
            f"mfu {report.get('mfu')} ({report.get('mfuReason')}), peak {peak} bytes, "
            f"Chrome trace {traces}")
        t0 = time.perf_counter()
        online = _docs_process(online_line, tree, rec_env, rec_work,
                               os.path.join(base, "online.out"))
        procs.append(online)
        # (b) pio-start-all's event server while the deploys start
        t_es = time.perf_counter()
        _docs_event_server(tag, env, metrics, keys)
        seconds["(b) pio-start-all's event server"] = time.perf_counter() - t_es
        port = _docs_listening(tag, online, os.path.join(base, "online.out"))
        seconds[f"(a) `{online_line}` to listening"] = time.perf_counter() - t0
        # (b) the online deploy: queries, one rating folded, the documents
        t0 = time.perf_counter()
        status, doc, _ = _post(port, {"user": "u1", "num": 4})
        if status != 200 or not doc.get("itemScores"):
            fail(f"[{tag}] the online deploy answered {status}: {doc}")
        home = _get(port, "/")[1]
        if not str(home.get("device", "")).startswith("cuda"):
            fail(f"[{tag}] the online deploy serves on {home.get('device')}, not the card")
        storage = Storage({"PIO_FS_BASEDIR": rec_store})
        try:
            app = storage.get_meta_data_apps().get_by_name("RecDemoApp")
            storage.get_events().insert(Event(
                event="rate", entity_type="user", entity_id="u1", target_entity_type="item",
                target_entity_id="i2", properties=DataMap({"rating": 5.0}),
                event_time=datetime.now(timezone.utc)), app.id)
        finally:
            storage.close()
        deadline = time.monotonic() + DOCS_FOLD_WAIT_S
        while _get(port, "/stats.json")[1]["online"]["foldedEventsTotal"] < 1:
            if time.monotonic() > deadline:
                fail(f"[{tag}] the online deploy folded no event in {DOCS_FOLD_WAIT_S}s: "
                     f"{_get(port, '/stats.json')[1]['online']}")
            time.sleep(0.2)
        online_doc = _get(port, "/stats.json")[1]["online"]
        _hold_documented(f"{tag}-online", port,
                         _doc_names(metrics, "engine", DOCS_ONLINE_MEETS),
                         _doc_names(keys, "engine", DOCS_ONLINE_MEETS - {"card", "after a fold"}))
        seconds["(b) the online deploy: a query, a fold, the documents"] = time.perf_counter() - t0
        log(f"[{tag}] the online deploy on {home.get('device')} folded u1's rating: lag "
            f"{online_doc['lagSeconds']} s, {online_doc['foldCycles']} fold cycles")
        # (b) the pool: distinct queries over fresh connections, the
        # documents, the kernel's launches worker by worker
        port = _docs_listening(tag, pool, os.path.join(base, "pool.out"))
        deadline = time.monotonic() + PIO_STEP_TIMEOUT
        while len(_spool_workers(seq_env["TMPDIR"])) < DOCS_POOL_WORKERS:
            if pool.poll() is not None or time.monotonic() > deadline:
                fail(f"[{tag}] the documented pool never had {DOCS_POOL_WORKERS} workers")
            time.sleep(0.1)
        seconds[f"(a) `{pool_line}` to {DOCS_POOL_WORKERS} workers listening"] = \
            time.perf_counter() - t_pool
        t0 = time.perf_counter()
        for i in range(DOCS_POOL_QUERIES):
            # cold sessions (the walk-through's users have seen all 6 items)
            first = i % 6
            body = {"items": [f"i{first}", f"i{(first + 1 + i // 6) % 6}"], "num": 1 + i % 3}
            status, doc, _ = _post(port, body)
            if status != 200 or not 1 <= len(doc.get("itemScores", [])) <= body["num"]:
                fail(f"[{tag}] the pool answered {json.dumps(body)} with {status}: {doc}")
        workers = {w: _get(e["port"], "/")[1] for w, e in _spool_workers(seq_env["TMPDIR"]).items()}
        launches = {w: doc["kernelLaunches"]["flash_attention"] for w, doc in workers.items()}
        devices = {w: doc["device"] for w, doc in workers.items()}
        if sum(launches.values()) < 1 or any(
                not d.startswith("cuda") for d in devices.values()):
            fail(f"[{tag}] the pool's workers launched the flash kernel {launches} times "
                 f"on {devices}")
        _hold_documented(f"{tag}-pool", port, _doc_names(metrics, "engine", DOCS_POOL_MEETS),
                         _doc_names(keys, "engine", DOCS_POOL_MEETS - {"card"}))
        seconds["(b) the pool: queries and the documents"] = time.perf_counter() - t0
        log(f"[{tag}] `{pool_line}`: {len(workers)} workers on {sorted(set(devices.values()))}, "
            f"{DOCS_POOL_QUERIES} queries, flash launches by worker {launches}")
    finally:
        # SIGTERM (a pool drains its siblings), then what is left of each session
        _stop_all(procs)
        for proc in procs:
            _end_session(proc.pid)
    seconds["in all"] = time.perf_counter() - t_phase
    for step, s in seconds.items():
        log(f"[phases] phase 37 {step} took {s:.1f}s")
    return sum(launches.values())


# ---------------------------------------------------------------------------
# phase 33: Parquet `pio export` / `pio import`
# ---------------------------------------------------------------------------

NO_PYARROW = ("[ERROR] Parquet support requires pyarrow "
              "(pip install 'predictionio-tpu[parquet]').")


def phase_parquet(pio: _Pio) -> None:
    """Phase 33: `pio export --format parquet` of 16b's ML-100k app from
    ``pio``'s store (read only), `pio import` of the file (Parquet by its
    suffix) into a fresh store, and JSON-lines exports of both apps,
    equal line for line. Without pyarrow, both commands must exit 1 with
    the JAX package's message."""
    tag = "parquet"
    storage = Storage({"PIO_FS_BASEDIR": pio.env["PIO_FS_BASEDIR"]})
    try:
        app_id = storage.get_meta_data_apps().get_by_name("ML100k").id
    finally:
        storage.close()
    want = ML100K[2] + ML100K[3]
    with tempfile.TemporaryDirectory(prefix="pio-parquet-") as work:
        path = os.path.join(work, "ml100k.parquet")
        copy = _Pio(work)
        copy_app = copy.new_app(tag, "ML100kCopy")
        export = ("export", "--appid", str(app_id), "--output", path, "--format", "parquet")
        if importlib.util.find_spec("pyarrow") is None:
            out, _ = pio.run(tag, *export, expect=1)
            with open(path, "wb") as f:
                f.write(b"PAR1")
            out_import, _ = copy.run(tag, "import", "--appid", str(copy_app), "--input", path,
                                     expect=1)
            if NO_PYARROW not in out or NO_PYARROW not in out_import:
                fail(f"[{tag}] without pyarrow: {out!r} / {out_import!r}")
            log(f"[{tag}] pyarrow is not installed: `pio export --format parquet` and `pio "
                f"import` of a .parquet file exit 1 with the JAX package's message")
            return
        src, dst = os.path.join(work, "src.jsonl"), os.path.join(work, "copy.jsonl")
        with ThreadPoolExecutor(1) as side:   # the source's JSON export beside the round trip
            src_export = side.submit(pio.run, tag, "export", "--appid", str(app_id),
                                     "--output", src)
            out, t_export = pio.run(tag, *export)
            if f"Exported {want} events to {path}" not in out:
                fail(f"[{tag}] export: {out}")
            out, t_import = copy.run(tag, "import", "--appid", str(copy_app), "--input", path)
            if f"Imported {want} events from {path}" not in out:
                fail(f"[{tag}] import: {out}")
            src_export.result()
        copy.run(tag, "export", "--appid", str(copy_app), "--output", dst)
        lines = []
        for p in (src, dst):
            with open(p) as f:
                lines.append(sorted(f.read().splitlines()))
        if lines[0] != lines[1] or len(lines[0]) != want:
            fail(f"[{tag}] the JSON exports differ: {len(lines[0])} against {len(lines[1])} "
                 f"lines, {sum(a != b for a, b in zip(*lines))} unequal")
        log(f"[{tag}] {want} events of app {app_id}: `pio export --format parquet` "
            f"{t_export:.3f}s ({want / t_export:.0f} events/s, {os.path.getsize(path)} bytes), "
            f"`pio import` into a fresh store {t_import:.3f}s ({want / t_import:.0f} events/s); "
            f"the JSON exports of both apps equal line for line")


# ---------------------------------------------------------------------------
# the host lane: phases 16, 17a, 18, 24, 26, 28 and 29 in a child process
# ---------------------------------------------------------------------------

#: seconds either lane waits for the other's hand-over file
LANE_WAIT_S = 2 * PIO_STEP_TIMEOUT
#: seconds the child has to stop its processes after a SIGTERM
LANE_STOP_S = 30


def _lane_put(lane_dir: str, name: str, doc) -> None:
    tmp = os.path.join(lane_dir, f".{name}.json.tmp")
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, os.path.join(lane_dir, f"{name}.json"))


def _lane_get(lane_dir: str, name: str, alive) -> object:
    """The other lane's ``name`` hand-over, waiting while ``alive()``."""
    path = os.path.join(lane_dir, f"{name}.json")
    deadline = time.monotonic() + LANE_WAIT_S
    while not os.path.exists(path):
        if not alive():
            fail(f"[lanes] the other lane ended before it handed over {name}")
        if time.monotonic() > deadline:
            fail(f"[lanes] no {name} hand-over within {LANE_WAIT_S}s")
        time.sleep(0.2)
    with open(path) as f:
        return json.load(f)


def _stop_with_parent() -> None:
    """Ends this process's session when the process that started it is
    gone (killed at its time limit, say): a SIGTERM to the group, which
    the lane's handler turns into an exit through its `finally` blocks."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os.killpg(os.getpgrp(), signal.SIGTERM)

    threading.Thread(target=watch, name="lane-parent-watch", daemon=True).start()


def host_lane(lane_dir: str) -> None:
    """The `pio` chain over one store, run by ``--host-lane DIR`` beside
    the main lane: phase 16 (its instances handed over as phase16.json),
    17a, 18, 24 (on phase 14's grid scores, taken from phase14.json), 26,
    28 and 29. Its flash launches, read from its deploy processes and
    this process's counter, go into result.json."""
    # a SIGTERM unwinds the phases, whose `finally` blocks stop their servers
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    _stop_with_parent()
    pio = _Pio(os.path.join(lane_dir, "pio"))
    launches, instance, rec_instance = timed("16", phase_pio, pio)
    _lane_put(lane_dir, "phase16", {"instance": instance, "rec_instance": rec_instance})
    serve_launches = timed("17a", phase_serve_sessionrec, pio, instance)
    if serve_launches == 0:
        fail("batched serving never launched the flash_attention kernel")
    launches += serve_launches
    ingest_launches = timed("18", phase_ingest, pio)
    if ingest_launches == 0:
        fail("the feedback loop's deploy never launched the flash_attention kernel")
    launches += ingest_launches
    phase14 = _lane_get(lane_dir, "phase14", lambda: True)   # the watcher ends a lone lane
    # the grid's launches happen in `pio eval` processes and their
    # forked workers, which log them per fold
    grid_launches = timed("24", phase_grid, pio, phase14)
    if grid_launches == 0:
        fail("the grid's workers never launched the flash_attention kernel")
    launches += grid_launches
    # the launches of phase 26 happen in its `pio deploy` processes
    # (their GET /) and in its in-process server (LAUNCHES)
    obs_launches = timed("26", phase_obs, pio, instance[1])
    if obs_launches == 0:
        fail("the traced deploys never launched the flash_attention kernel")
    launches += obs_launches
    # phase 28's in the router's replicas, read replica by replica
    router_launches = timed("28", phase_router, pio, instance[0], instance[1],
                            tuple(rec_instance), GRID_INSTANCE[0])
    if router_launches == 0:
        fail("the router's replicas never launched the flash_attention kernel")
    launches += router_launches
    # phase 29's in its `pio deploy` process, read on its GET /
    storage_launches = timed("29", phase_storage, pio, pio.base, GRID_INSTANCE[0],
                             (PIO_SESSION[0] * PIO_SESSION[1], instance[2]))
    if storage_launches == 0:
        fail("the S3-loaded deploy never launched the flash_attention kernel")
    launches += storage_launches
    _lane_put(lane_dir, "result", {"launches": launches})


class _HostLane:
    """``host_lane`` as a child process in a session of its own (so that
    every process it starts is stopped with it), its output in a file
    that the main lane prints when it joins it."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="pio-lane-")
        self.base = os.path.join(self.dir, "pio")
        os.makedirs(self.base)
        self.log_path = os.path.join(self.dir, "lane.log")
        self.t0 = time.perf_counter()
        with open(self.log_path, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--host-lane", self.dir],
                stdout=out, stderr=subprocess.STDOUT, start_new_session=True)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def put(self, name: str, doc) -> None:
        _lane_put(self.dir, name, doc)

    def get(self, name: str):
        return _lane_get(self.dir, name, self.alive)

    def _print_log(self) -> None:
        with open(self.log_path) as f:
            sys.stdout.write(f.read())
        sys.stdout.flush()

    def join(self) -> int:
        """Waits for the lane, prints its log; its flash launches."""
        t0 = time.perf_counter()
        try:
            rc = self.proc.wait(timeout=LANE_WAIT_S)
        except subprocess.TimeoutExpired:
            rc = None
        self._print_log()
        log(f"[lanes] the host lane took {time.perf_counter() - self.t0:.1f}s (waited "
            f"{time.perf_counter() - t0:.1f}s at the join)")
        if rc != 0:
            fail(f"[lanes] the host lane exited {rc}; its log is above")
        with open(os.path.join(self.dir, "result.json")) as f:
            return json.load(f)["launches"]

    def stop(self) -> None:
        """Stops the lane's session (SIGTERM, then SIGKILL) and removes its
        directory; after a failure, its log goes to stderr."""
        if self.alive():
            with contextlib.suppress(ProcessLookupError):
                os.killpg(self.proc.pid, signal.SIGTERM)
            try:
                self.proc.wait(timeout=LANE_STOP_S)
            except subprocess.TimeoutExpired:
                pass
            with open(self.log_path) as f:
                sys.stderr.write(f.read()[-20_000:])
        with contextlib.suppress(ProcessLookupError):
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    wall = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    # checkpoints of the in-process training runs (phases 5-15)
    os.environ["PIO_MODEL_DIR"] = tempfile.mkdtemp(prefix="pio-models-")
    try:
        run_phases(wall)
    finally:
        shutil.rmtree(os.environ.pop("PIO_MODEL_DIR"), ignore_errors=True)


#: phase 40: users, their histories' lengths (log-uniform) and the item
#: law's exponent (item 1+floor(49,999·u^1.8)); one batch's queries, the
#: batches with a bound trace and under the profiler
SPANS_USERS, SPANS_LENGTHS, SPANS_EXPONENT = 4_096, (16, 2048), 1.8
SPANS_BATCH, SPANS_TRACED, SPANS_PROFILED = 64, 16, 4
SPAN_NAMES = ["seqrec.prepare", "seqrec.stack", "seqrec.copy_in", "seqrec.forward",
              "seqrec.topk", "seqrec.fetch", "seqrec.decode"]
#: calls of phase 40a's span loop
SPAN_CALLS = 100_000


def _spans_engine() -> tuple[DeployedEngine, list[str]]:
    """A deployed sessionrec engine over random weights at the serving
    config, and its users."""
    cfg = seqrec.SeqRecConfig(**SERVING, dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED + 40)
    lo, hi = SPANS_LENGTHS
    lengths = np.exp(rng.uniform(np.log(lo), np.log(hi + 1), SPANS_USERS)).astype(np.int64)
    flat = 1 + np.floor((cfg.vocab - 1) * rng.random(int(lengths.sum())) ** SPANS_EXPONENT)
    flat = np.minimum(flat, cfg.vocab - 1).astype(np.int64)
    users = [f"u{u}" for u in range(SPANS_USERS)]
    histories = dict(zip(users, (h.tolist() for h in np.split(flat, np.cumsum(lengths)[:-1]))))
    model = sessionrec.SeqRecEngineModel(
        params=seqrec.init_params(cfg, torch.Generator().manual_seed(SEED)), cfg=cfg,
        item_index=BiMap({str(i): i for i in range(1, cfg.vocab)}), histories=histories,
        device=torch.device(DEVICE))
    engine = sessionrec.engine_factory()
    params = EngineParams.of(algorithms=[("seqrec", sessionrec.AlgorithmParams())])
    _, _, algorithms, serving = engine.make_components(params)
    return DeployedEngine(engine, "spans", algorithms, serving, [model], DEVICE), users


def phase_spans() -> int:
    """Phase 40: the serve path's stage spans; returns its flash launches."""
    from torch.profiler import ProfilerActivity, profile

    tag = "spans"
    launches0 = flash_ops.LAUNCHES
    # (a) the off path: no trace bound, no profiler recording
    if torch.autograd._profiler_enabled() or ptrace.active_trace() is not None:
        fail(f"[{tag}] a profiler or a trace is already on")
    if ptrace.span("seqrec.prepare") is not ptrace._NULL_SPAN:
        fail(f"[{tag}] span() with no trace and no profiler is not the shared no-op")
    t0 = time.perf_counter()
    for _ in range(SPAN_CALLS):
        with ptrace.span("seqrec.prepare"):
            pass
    log(f"[{tag}] off path: a span() block {(time.perf_counter() - t0) / SPAN_CALLS * 1e9:.1f} "
        f"ns over {SPAN_CALLS:,}")

    deployed, users = _spans_engine()
    rng = np.random.default_rng(SEED + 41)
    batches = [[sessionrec.Query(user=users[u], num=10)
                for u in rng.integers(0, len(users), SPANS_BATCH)]
               for _ in range(1 + SPANS_TRACED + SPANS_PROFILED)]
    deployed.query_batch(batches[0])      # warm-up: kernel, shapes, allocator

    # (b) a Trace bound around each query_batch: the seven stages in order
    stage_ms: dict[str, list[float]] = {n: [] for n in SPAN_NAMES}
    for queries in batches[1 : 1 + SPANS_TRACED]:
        trace = ptrace.start_trace("query_batch")
        with ptrace.use_trace(trace):
            deployed.query_batch(queries)
        spans = trace.spans()
        names = [s[0] for s in spans]
        if names != SPAN_NAMES:
            fail(f"[{tag}] a bound trace's spans are {names}, not {SPAN_NAMES}")
        for name, _, _, _, dur in spans:
            stage_ms[name].append(dur * 1e3)
    log(f"[{tag}] a batch of {SPANS_BATCH} by its stage spans (median ms over "
        f"{SPANS_TRACED} traced batches): " + ", ".join(
            f"{n} {statistics.median(v):.3f}" for n, v in stage_ms.items()))

    # (c) under the profiler: the stages as host annotations, and each
    # annotation the profiler mirrors onto the card's timeline flagged as one
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for queries in batches[1 + SPANS_TRACED :]:
            deployed.query_batch(queries)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("seqrec.")]
    host = [e.name() for e in sorted(events, key=lambda e: e.start_ns())
            if e.device_type() == torch.autograd.DeviceType.CPU]
    card = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
    if host != SPAN_NAMES * SPANS_PROFILED:
        fail(f"[{tag}] the profiler's host annotations are {host[:8]}")
    flagged = sum(bool(e.is_user_annotation()) for e in card)
    log(f"[{tag}] seqrec.* annotations over {SPANS_PROFILED} profiled batches: {len(host)} on "
        f"the host, {len(card)} mirrored on the card, {flagged} of them flagged user "
        f"annotations")
    if flagged != len(card):
        fail(f"[{tag}] a mirrored stage annotation is not flagged as an annotation")
    del deployed
    torch.cuda.empty_cache()
    return flash_ops.LAUNCHES - launches0


def timed(phase: str, fn, *args):
    """``fn(*args)``, logging the phase's seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phases] phase {phase} took {time.perf_counter() - t0:.1f}s")
    return out


def run_phases(wall: float) -> None:
    if sys.argv[1:2] == ["--host-lane"]:   # the main path's child process
        host_lane(sys.argv[2])
        return
    if sys.argv[1:2] == ["--dist-child"]:   # one rank of phase 35d
        dist_child(sys.argv[2])
        return
    if sys.argv[1:] == ["--dist-only"]:   # phase 35 alone; prints no result line
        log_card()
        phase_dist()
        return
    if sys.argv[1:] == ["--quickstart-only"]:   # phase 36 alone; prints no result line
        log_card()
        timed("36", phase_quickstart)
        return
    if sys.argv[1:] == ["--docs-only"]:   # phases 36-37 alone; prints no result line
        log_card()
        timed("36-37", phase_quickstart, True)
        return
    if sys.argv[1:] == ["--lint-only"]:   # phase 30 alone
        log_card()
        join_lint(start_lint())
        return
    if sys.argv[1:] == ["--pool-only"]:   # phase 27 alone, over fresh 16a and 16b instances
        phase_build()
        with tempfile.TemporaryDirectory(prefix="pio-") as base:
            pio = _Pio(base)
            instance_id, engine_json, _ = pio_sessionrec_instance(pio)
            rec_json, rec_id, storage, _ = pio_recommendation_instance(pio)
            storage.close()
            phase_pool(pio, instance_id, engine_json, (rec_json, rec_id))
        return
    if sys.argv[1:] == ["--router-only"]:   # phase 28 alone, over fresh 16a and 16b instances
        phase_build()
        with tempfile.TemporaryDirectory(prefix="pio-") as base:
            pio = _Pio(base)
            instance_id, engine_json, _ = pio_sessionrec_instance(pio)
            rec_json, rec_id, storage, _ = pio_recommendation_instance(pio)
            storage.close()
            # phase 24's two grid points, serially: the experiment's variants
            run = _pio_eval(pio, "router-eval", GRID_SPEC, "chip_smoke.GridParams",
                            "--parallel", "1")
            _grid_scores("router-eval", run)
            phase_router(pio, instance_id, engine_json, (rec_json, rec_id), run["row"].id)
        return
    if sys.argv[1:] == ["--storage-only"]:   # phase 29 alone, with a small pio eval of its own
        phase_build()
        with tempfile.TemporaryDirectory(prefix="pio-") as base:
            pio = _Pio(base)
            import_sessions(pio, STORAGE_EVAL_USERS)
            run = _pio_eval(pio, "storage-eval", GRID_SPEC, "chip_smoke.GridParams",
                            "--parallel", "1")
            _grid_scores("storage-eval", run)
            phase_storage(pio, base, run["row"].id, None)
        return
    if sys.argv[1:] == ["--als-only"]:   # phases 9-13 alone; prints no result line
        phase_als()
        return
    if sys.argv[1:] == ["--als-layouts-only"]:   # phase 32 alone; prints no result line
        log_card()
        phase_als_layouts(None)
        return
    if sys.argv[1:] == ["--mesh-only"]:   # phase 34 alone; prints no result line
        log_card()
        phase_mesh()
        return
    if sys.argv[1:] == ["--parquet-only"]:   # phase 33 alone, over a fresh 16b import and train
        log_card()
        with tempfile.TemporaryDirectory(prefix="pio-") as base:
            pio = _Pio(base)
            pio_recommendation_instance(pio)[2].close()
            phase_parquet(pio)
        return
    if sys.argv[1:] == ["--eval-only"]:  # phases 14-15 alone; prints no result line
        log_card()
        phase_eval_sessionrec()
        phase_eval_recommendation()
        return
    if sys.argv[1:] == ["--ann-only"]:   # phase 22 alone, over a random ML-20M-shape model
        log_card()
        phase_ann(random_als_model())
        return
    if sys.argv[1:] == ["--online-only"]:   # phase 23 alone, over 16b's import and train
        log_card()
        with tempfile.TemporaryDirectory(prefix="pio-") as base:
            pio = _Pio(base)
            engine_json, instance_id, storage, _ = pio_recommendation_instance(pio)
            storage.close()
            phase_online(pio, (engine_json, instance_id))
        return
    if sys.argv[1:] == ["--grid-only"]:   # phase 24 alone, over 16a's import
        phase_build()
        with tempfile.TemporaryDirectory(prefix="pio-") as base:
            pio = _Pio(base)
            import_sessions(pio)
            phase_grid(pio, None)
        return
    if sys.argv[1:] == ["--examples-only"]:   # phase 31 alone
        log_card()
        phase_examples()
        return
    if sys.argv[1:] == ["--e2-only"]:   # phase 25 alone
        log_card()
        phase_e2()
        return
    if sys.argv[1:] == ["--obs-only"]:   # phase 26 alone, over 16a's import
        phase_build()
        with tempfile.TemporaryDirectory(prefix="pio-") as base:
            pio = _Pio(base)
            import_sessions(pio)
            phase_obs(pio, sessionrec_engine_json(pio))
        return
    if sys.argv[1:] == ["--templates-only"]:   # phases 19-21 alone; no result line
        log_card()
        with tempfile.TemporaryDirectory(prefix="pio-") as base:
            phase_templates(_Pio(base))
        return
    if sys.argv[1:] in (["--pio-only"], ["--serve-only"], ["--ingest-only"]):
        # phase 16, or phase 17 over 16a's instance, or phase 18 over 16a's
        # import, alone; no result line
        phase_build()
        with tempfile.TemporaryDirectory(prefix="pio-") as base:
            pio = _Pio(base)
            if sys.argv[1] == "--pio-only":
                phase_pio(pio)
                phase_tie_order()
            elif sys.argv[1] == "--serve-only":
                phase_serve(pio, pio_sessionrec_instance(pio), random_als_model())
            else:
                import_sessions(pio)
                phase_ingest(pio)
        return
    lint = start_lint()   # phase 30 runs on the host while 1-2 build and check
    max_abs_err = timed("1-2", lambda: (phase_build(), phase_kernel_vs_plain())[1])
    join_lint(lint)
    times = timed("3", phase_times)
    launches = timed("4", phase_serving)
    if launches == 0:
        fail("the serving path never launched the flash_attention kernel")
    # from here on two lanes: the `pio` chain in a child process, the
    # in-process phases here; the launches of 16-18, 24, 26 and 28-29
    # happen in the child's `pio deploy` and `pio eval` processes and in
    # the child itself, which reports their sum
    lane = _HostLane()
    try:
        trained_launches = timed("5-8", phase_training)
        if trained_launches == 0:
            fail("serving the trained model never launched the flash_attention kernel")
        launches += trained_launches
        flash_ops.LAUNCHES = 0
        als_model, fused9 = timed("9-13", phase_als)
        timed("17b", phase_serve_als, als_model)
        if flash_ops.LAUNCHES:
            fail(f"the ALS path and its serving launched the flash kernel "
                 f"{flash_ops.LAUNCHES} times")
        torch.cuda.empty_cache()
        eval_launches, phase14 = timed("14", phase_eval_sessionrec)
        lane.put("phase14", phase14)   # phase 24's first serial run
        launches += eval_launches
        torch.cuda.empty_cache()
        flash_ops.LAUNCHES = 0
        timed("15", phase_eval_recommendation)
        if flash_ops.LAUNCHES:
            fail(f"the ALS evaluation launched the flash kernel {flash_ops.LAUNCHES} times")
        timed("16c", phase_tie_order)   # its seqrec check runs a small model through flash
        torch.cuda.empty_cache()
        # phases 36-37's shells and their `pio` processes beside 19-35;
        # their launches happen in their deploy processes, which report
        # them
        side = ThreadPoolExecutor(1)
        quickstart = side.submit(timed, "36-37", phase_quickstart, True)
        with tempfile.TemporaryDirectory(prefix="pio-") as base:
            timed("19-21", phase_templates, _Pio(base))
        torch.cuda.empty_cache()
        timed("22", phase_ann, als_model)
        torch.cuda.empty_cache()
        timed("25", phase_e2)
        torch.cuda.empty_cache()
        timed("31", phase_examples)
        torch.cuda.empty_cache()
        timed("32", phase_als_layouts, fused9)
        torch.cuda.empty_cache()
        timed("34", phase_mesh)
        torch.cuda.empty_cache()
        dist_launches = timed("35", phase_dist)
        if dist_launches == 0:
            fail("serving the sequence-mesh-trained model never launched the flash kernel")
        launches += dist_launches
        torch.cuda.empty_cache()
        spans_launches = timed("40", phase_spans)
        if spans_launches == 0:
            fail("the stage-span phase never launched the flash_attention kernel")
        launches += spans_launches
        launches += quickstart.result()
        side.shutdown()
        # 33, 23 and 27 over phase 16's store, beside the child's later
        # phases; 33 reads 16b's app before 23 and 27 add events to it
        handed = lane.get("phase16")
        instance, rec_instance = handed["instance"], tuple(handed["rec_instance"])
        pio = _Pio(lane.base)
        timed("33", phase_parquet, pio)
        timed("23", phase_online, pio, rec_instance)
        # phase 27's launches in its pools' workers, read worker by worker
        pool_launches = timed("27", phase_pool, pio, instance[0], instance[1], rec_instance)
        if pool_launches == 0:
            fail("the worker pools never launched the flash_attention kernel")
        launches += pool_launches
        launches += lane.join()
    finally:
        lane.stop()
    log(f"[wall] chip_smoke.py took {time.perf_counter() - wall:.1f}s")
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "design": "cuda-wgmma",
        "kv_tile": KV_TILE,
        "source": "predictionio_tpu_torch/csrc/flash_attention.cu",
        "replaces": "predictionio_tpu/ops/pallas_attention.py:78",
        "launches": launches,
        "max_abs_err": max_abs_err,
        **times,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
