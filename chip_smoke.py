#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one CUDA card: the quickest proof
that the port still starts on the GPU.

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure (exit code 1, no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from lightgbm_tpu_torch/csrc with nvcc;
  3. fifty-three paths at full width, each lgb.train (cv_int8:
     lgb.cv) on the Higgs-1M shape
     (1,000,000 rows x 28 dense features, binary, 255 leaves; the efb
     and sparse paths: a sparse table of 697 features), then
     predict 100,000 held-out rows; the launch counters are set to 0 just
     before each path and read just after, and each kernel of the path
     must have launched:
       hilo    255 bins, tpu_partition_impl=kernel, hilo histograms, 10
               iterations: B1 and B3;
       int8    as hilo with tpu_hist_precision=int8 and its defaults
               (stochastic rounding, leaf refit), 10 iterations: B1's
               integer variant at the root, B2 in every grower round,
               B3, and the refit's fixed-order leaf sums (kernels
               leaf_group and leaf_sums, as on every path that refits);
       flat    as hilo with tpu_hist_impl=pallas, 10 iterations: B4
               (the grouped body under its own instance), B3;
       flat_int8  flat with tpu_hist_precision=int8, 5 iterations: B4's
               integer variant every round, B3, the leaf sums;
       packed  max_bin=15 with every other parameter at the JAX
               package's default (select partition, auto histogram),
               10 iterations: the bins are 4-bit packed and every
               histogram is B1's packed variant;
       packed_int8  as packed with tpu_hist_precision=int8 and
               tpu_hist_impl=pallas2 (auto would take B2, which never
               packs), 5 iterations: B1's packed integer variant and the
               leaf sums;
       packed_flat  packed with tpu_hist_impl=pallas, 10 iterations: the
               bins 4-bit packed in 256-row blocks, every histogram B4's
               packed variant;
       packed_flat_int8  packed_flat with tpu_hist_precision=int8, 5
               iterations: B4's packed integer variant, the leaf sums;
       valid_bag_int8  int8 under its defaults with bagging_fraction=0.8,
               bagging_freq=1, feature_fraction=0.8, the 100,000
               held-out rows as a validation set (reference= the training
               set), metric auc and binary_logloss, early_stopping_rounds
               5, 20 iterations: B1-int, B2, B3 and the leaf sums on
               bagged rows and masked features; the valid AUC of every
               iteration, the trees, the best iteration, the host waits,
               and the added cost of evaluating (5 more iterations
               without and with it, twice in turns, and the host waits of
               one iteration each way);
       fobj_hilo  hilo with binary logloss gradients given as fobj
               (numpy on the host) through the sync step, 5 iterations:
               B1 and B3; its held-out AUC beside the hilo path's;
       wide    hilo at max_bin=1023: the learner stores the bins int32
               (about 1,023 bins a feature), 10 iterations: B1's wide
               variant (16-bit row-major bins, a slot's sums spread
               over a thread-block cluster, one tile of bins a block)
               and B3's (the int32 matrix in place);
       wide_int8  wide with tpu_hist_precision=int8, 10 iterations: B1's
               wide integer variant at the root, B2's wide variant every
               round, B3's, the leaf sums;
       wide_flat, wide_flat_int8  wide with tpu_hist_impl=pallas (and
               int8), 5 iterations: B4's wide variants, B3's, the leaf
               sums;
       goss_int8  int8 with boosting=goss (top_rate 0.2, other_rate 0.1),
               15 iterations: 10 of warm-up (learning_rate 0.1), then 5
               sampled on the card; B1-int at the root, B2, B3, the leaf
               sums; the kept-row share of every tree (1.0, then about
               0.3);
       bynode_int8  int8 with feature_fraction_bynode=0.5, 5 iterations:
               one feature mask a node, so the grower leaves B2's scan:
               B1-int every round, B3, the leaf sums, and no B2 launch;
       dart_hilo  hilo with boosting=dart under its defaults (drop_rate
               0.1, skip_drop 0.5, max_drop 50), 15 iterations through
               the sync step: B1, B3; the trees dropped at each iteration,
               the CUDA-event time of each f64 walk of a drop set on the
               path, and the profiled device time of one such walk;
       rf_int8  int8 with boosting=rf, bagging_fraction 0.8 every
               iteration, feature_fraction 0.8, 10 iterations: B1-int,
               B2, B3, the leaf sums; the averaged forest's held-out AUC;
       cv_int8  lgb.cv with int8, 3 stratified folds of the training
               rows, 5 rounds: each fold's B1-int, B2, B3 and leaf sums;
               the AUC mean and stdv after each round, each round's wall
               seconds, the bytes of the fold datasets on the card;
       multiclass_int8  objective=multiclass, num_class=5 on the latent
               (the generator's logits plus its logistic noise) cut at
               its quintiles, int8, metrics multi_logloss and
               multi_error, 5 iterations (25 trees, one fused step a
               class): B1-int and the leaf sums once a tree (5 an
               iteration), B2, B3; held-out multi_logloss and error;
       lambdarank_int8  objective=lambdarank on queries of 100
               consecutive rows (10,000), relevance 0-4 from the latent's
               quintiles, int8, ndcg at 1, 3 and 5, 5 iterations through
               the sync step with the lambdas on the host: B1-int, B2,
               B3, the leaf sums; the host seconds an iteration of the
               lambdas and their share of the sync step; held-out ndcg
               beside that of random scores;
       l1_hilo  objective=regression_l1 on the latent, hilo, 5 iterations
               through the sync step with the host percentile refit of
               every leaf: B1 and B3; the refit's host seconds and share;
               held-out l1 beside the median's;
       cat_hilo  columns 22-27 recoded as categorical_feature, cut at
               their training quantiles into 3, 7, 12, 31, 100 and 250
               categories relabelled by a seeded permutation, hilo with
               tpu_partition_impl=select, 5 iterations: B1 every round,
               the categorical split search (one-hot on the 3-category
               column, sorted-CTR on the others), bin LUT, mask routing
               and bitset walk as torch ops, no B3; the trees must hold
               categorical splits, counted per mode (phase 5 requires
               both modes);
       cat_int8  cat_hilo with tpu_hist_precision=int8, 5 iterations:
               B1-int every round and the leaf sums; B2 (categorical data
               leaves its scan) and B3 must not launch;
       efb_hilo  the Flight Delay-shaped table of LightGBM's EFB
               experiments (efb_data: Distance and one-hot Month,
               DayofMonth, DayOfWeek, DepHour, UniqueCarrier, Origin and
               Dest, 697 features, 8 stored values a row) as a scipy CSR
               matrix, one Dataset for both paths, hilo with
               tpu_partition_impl=select, 5 iterations: the plan must
               be EFB_COLUMNS bundle columns (printed with their bins,
               the plan's host seconds and the bytes on the card); B1
               every round on the bundle columns, the expansion to the
               features (timed a search) and the bundle-column partition
               as torch ops, no B2, no B3; predict from CSR;
       efb_int8  efb_hilo with tpu_hist_precision=int8: B1-int every
               round and the leaf sums; no B2 (bundles leave its scan),
               no B3;
       mono_int8  int8 under its defaults with monotone_constraints 0 on
               columns 0-7 and the sign of the generator's linear
               coefficient on 8-27, on a Dataset of its own (the
               constraints are read when a Dataset is constructed), 10
               iterations: B1-int at the root, B2 with the children's
               bounds every round, B3, the leaf sums (the refit clipped
               to the bounds); the predictions of 1,000 held-out rows
               along 32 grid values of each constrained column must be
               monotone in its direction; it prints the splits on
               constrained columns;
       cegb_int8  int8 with CEGB (coupled penalties on columns 0-13, lazy
               ones on 14-17, a split penalty), 10 iterations through the
               sync step: B1-int every round, B3, the leaf sums, no B2;
               fewer distinct features than int8's may split; it prints
               both paths' root gains;
       forced_hilo  hilo with a forcedsplits_filename JSON (the root on
               column 8 at 0.0, its children on 9 and 10), 10
               iterations: B1 and B3; every tree's first three splits
               must be the forced ones at their thresholds' bins;
       det_f64  hilo with deterministic=true and tpu_hist_impl=xla, 5
               iterations, trained twice: the f64 histograms are torch
               ops, so no histogram kernel may launch; B3; the two model
               texts must be byte-identical; it prints ms an iteration
               beside hilo's;
       file_int8  the training rows written once as `label,f0..f27` CSV
               (%.9g), loaded in one pass (parse, bin finding, binning
               on the card), int8, 5 iterations: B1-int, B2, B3, the
               leaf sums; the model text must equal an in-memory run's
               on the file's values (which round to the rows' float32
               values); it prints the file's bytes, the parse and ingest
               seconds and the load's peak host RSS;
       file_two_round_int8  the same file with two_round and
               save_binary (pass 1 samples the rows for bin finding,
               pass 2 bins chunk by chunk on the card), 5 iterations:
               the same kernels; the load must be the two-round loader's
               (ingest_s["two_round"]) with under half the one-pass
               load's peak host RSS, and the same path loaded again must
               take the binary cache without parsing and train the same
               text; it prints both loads' peak host RSS;
       predict_dataset  the int8 path's booster predicts the 100,000
               held-out rows from a Dataset binned with reference= the
               training set (its bins walked on the card); the raw
               scores must equal predict of the rows bit for bit; rows/s
               of both;
       sparse_hilo  efb_data with enable_bundle=false and
               tpu_sparse_threshold=0.02, hilo, 5 iterations: Origin's
               and Dest's 600 one-hot columns stored as COO (row, bin)
               entries, the other 97 features dense; B1 on the dense
               columns, the COO histograms as torch ops, no B3; its
               held-out AUC within AUC_TOL of the same path with every
               feature dense; it prints the dense and COO bytes against
               the all-dense matrix's, the sparse histograms' ms a round
               (random operands, K slots), host ops and device busy ms
               of one profiled iteration and iters/s of both;
       continue_int8  int8 for 5 iterations with the held-out rows as a
               validation set, saved; then lgb.train(init_model=<that
               file>) for 5 more with snapshot_freq=5 into a temp
               output_model, kept for training, then rollback_one_iter:
               B1-int, B2, B3, the leaf sums; the first 5 trees must be
               the init model's, the snapshot the model text it was
               written from, and after the rollback the train scores
               within 1e-6 of the 9-iteration model's predict; it prints
               the replay's seconds (5 trees onto 1,100,000 rows),
               iters/s of the continued rounds and the valid AUC;
       refit_int8  the int8 booster refit on a fresh 1,000,000-row draw
               of the generator (seed 43): leaf_group and the f64 leaf
               sums; each tree's leaf values bit for bit those of a refit
               whose sums are the CPU twin's on the card's leaf ids and
               gradients; refit seconds, the f64 sums' ms a tree beside
               the f32 instance's on the same operands, held-out AUC
               before and after;
       raw_walk  the hilo booster's text without its mapper trailer,
               loaded on the card: raw scores, pred_leaf, the trained
               booster with tpu_predict_device=false and pred_early_stop
               (freq 2, margin 1.5) of the held-out rows through the
               raw-value walker (torch ops): the f64 scores bit for bit
               the numpy Tree.predict walk's and within 1e-6 of the
               bin-space predict, the leaves the bin-space leaf index,
               the early stop the numpy loop's; rows/s of each and the
               stopped share;
       contrib_hilo  pred_contrib of the hilo booster on the held-out
               rows, TreeSHAP batched over rows as f64 torch ops: the
               first 64 rows bit for bit the numpy twin's, each row
               summing to its raw f64 score within 1e-9; rows/s;
     the sharded tree learners (ROADMAP A9a), 5 iterations each, every
     shard a thread on the one card (a simulated grid), B2 never
     launched, the held-out AUC within AUC_TOL of the serial path's at 5
     iterations, with their launches a tree a shard and iters/s:
       data_int8  int8 with tree_learner=data, 2 shards, tpu_hist_agg
               auto (scatter): B1-int, the torch split search, B3 and the
               leaf sums on each shard's half of the rows;
       data_psum_hilo  hilo with tree_learner=data, 2 shards,
               tpu_hist_agg=psum: B1 and B3 on each shard;
       voting_int8  int8 with tree_learner=voting, 2 shards, top_k=20;
       feature_int8  int8 with tree_learner=feature, 2 shards: each
               shard's B1-int on its 32-feature slice of every row, B3
               on the whole matrix;
       data_feature_int8  int8 with tree_learner=data_feature, 4 shards,
               tpu_feature_shards=2, tpu_topology_hosts=2;
     the distributed learners across processes (ROADMAP A9b): two
     workers of this script (`--mp-worker`), each a process on the first
     card, join a gloo group over a machine list on localhost, one shard
     each, 5 iterations; each rank's launch counters are set to 0 just
     before each path and read just after (B1-int, B3 and the leaf sums
     must launch on each rank, B2 never), with its iters/s, held-out
     AUC, process-level collectives' seconds and bytes a tree and host
     waits a tree:
       mp_data_int8  data_int8 with every row on each rank; both ranks'
               texts equal, and equal to an in-process run at
               num_machines=2, tpu_topology_hosts=2;
       mp_prepart_int8  pre_partition: each rank its half of the rows,
               bins from distributed binning, its half of the held-out
               rows a partitioned validation set (AUC merged across the
               ranks each iteration); both ranks' texts equal but for
               the tpu_feature_profile: trailer of each rank's rows;
     the next four run after phase 4 (and --profile's profiles), before
     phase 5:
       resume_int8  valid_bag_int8's parameters with tpu_checkpoint_dir
               (interval 2, keep 3), 10 iterations with early stopping
               armed: B1-int, B2, B3, the leaf sums; the text must be the
               same run's without checkpoints, byte for byte; a run whose
               grow_step raises at its 7th iteration must leave bundles
               6, 4 and 2 (the flush finds 6 valid) and a booster that
               predicts; resume=True to 10 must give the uninterrupted
               text; it prints the bundle's bytes, its save and restore
               seconds, the snapshot's ms an iteration and iters/s with
               and without checkpoints;
       guard_int8  the same parameters under tpu_guard_numerics=skip with
               the 4th iteration's scores NaN-poisoned: one skip, finite
               scores, 10 trees; under raise, 3 iterations left and a
               finite predict; the guard's ms an iteration (5 more
               iterations with it off and on, twice in turns) and its
               check's ms alone;
       oom_int8  int8 with tpu_hist_impl=fused pinned and the chunk
               rows one halving above the ladder's floor, two OOMs
               injected at the 3rd iteration (device_alloc): the ladder
               takes shrink_chunk_rows, then fused_unfuse, the later
               iterations launch B1-int and no B2, the text is the
               undisturbed fused run's, and the recoveries and steps
               counters move by 2; then a genuine OOM (after the first
               iteration the caching allocator capped 8 MiB above what
               it holds and its free blocks filled, the cap lifted and
               the blocks freed after): the run
               settles at an undisturbed run's text at the settled
               configuration, or, its last rung (stream_layout) taken,
               finishes streamed with a booster that predicts, or ends in
               MemoryLadderExhausted with a final checkpoint and a
               booster that predicts, never a raw
               torch.OutOfMemoryError (it prints which);
               torch.empty past capacity inside
               oom_guard("predict_chunk") must be a DeviceOutOfMemory
               naming the site;
       preflight  plan_training of a fresh hilo and int8 learner: each
               component the live tensors give (membudget.live_bytes,
               after one iteration) must equal the plan's; the plan's
               total beside one steady iteration's peak (its rise of
               max_memory_allocated plus the resident bins, row-major
               copy, scores and row mask); tpu_hbm_preflight=raise with
               a budget of the int8 plan less one byte must refuse before
               iteration 0, print the itemized table and launch no
               kernel;
     and after those the streamed layout (ops/stream.py, the bins in
     pinned host blocks of 131,072 rows copied through two device slots,
     B1 once per block per pass, never B2 or B3), on a Dataset of its
     own:
       stream_int8  int8 with tpu_stream_mode=streamed, 10 iterations:
               B1-int (blocks x (rounds + 1) a tree) and the leaf sums;
               its text must be the resident int8 run's on the sync
               path, byte for byte (it prints whether it is also the
               fused step's); iters/s beside both resident runs', H2D
               GB/s, overlap_pct, peak bytes beside the resident sync
               run's; B1-int on one block against its twin; the plan's
               stream_slots the live slots, its kernel scratch covering
               the build ledger's largest hist plan;
       stream_hilo  the same in hilo: B1; held-out AUC within AUC_TOL
               of the hilo path's;
       stream_goss_int8  stream_int8 with tpu_stream_goss_top=0.2 and
               tpu_stream_goss_other=0.1: the blocks skipped and
               replayed; two runs and a run with
               tpu_stream_double_buffer=false write one text;
       stream_large_int8  10,000,000 rows of the generator (seed 43),
               int8, 3 iterations under tpu_stream_mode=auto and a
               400 MiB budget (select_layout streams), blocks of
               1,048,576 rows: no [F, n] bins matrix nor [n, FR]
               row-major copy on the card, its bins in host memory, the
               slots two of the largest block; set-up over 60 s fails;
     then the telemetry phase (after the stream paths), each Dataset made
     under its mode:
       trace_int8  int8 with the held-out rows as a validation set, 20
               iterations, tpu_telemetry=trace into a temp directory,
               beside the same run with telemetry off: B1-int, B2, B3,
               the leaf sums; the model texts equal, the host waits
               (count_syncs) equal, trace-host0.json with the 20
               train/round spans covering at least ROUND_COVER of the
               loop's wall and the names TRACE_NAMES,
               events-host0.jsonl parsed line by line; then a
               torch.profiler profile of 2 more iterations holds the
               mirrored annotations train/iteration and train_dispatch,
               and every kernel launch call of the training thread lies
               inside a train/iteration annotation;
       metrics_hilo  hilo under tpu_telemetry=metrics, 10 iterations and
               the held-out predict: B1, B3; 10 train_dispatch runs in
               the phase timer, lgbm_phase_seconds_total and
               lgbm_device_phase_peak_bytes in the Prometheus text, the
               phase peaks ingest, hist_build and predict in (0, the
               card's memory], hist_build at least the resident bins,
               memory_snapshot equal to the allocator's numbers;
       trace_data_int8  data_int8's learner (2 shards) traced, 3
               iterations: each step holds one shard/grow span a shard,
               on distinct threads other than the training thread, one
               level below the step, and every exchange span lies
               inside its shard's span;
       telemetry overhead  int8 iterations a second, 10 iterations a
               run, off, metrics, trace, trace, metrics, off on one
               Dataset, beside the card's name and power limit; their
               texts must agree;
     the wide paths print the bytes of the int32 bins and of their 16-bit
     row-major copy;
  4. each kernel against its plain PyTorch twin on the card, at the
     shapes its path gives it, with times (ms: the kernel's device time
     per call from torch.profiler; event_ms: CUDA events around 20
     back-to-back calls, which read the host's time when a call is
     shorter than its wrapper), the bound (every leaf id, the
     bins and stats of the live rows, the output) and, where one exists,
     one PyTorch library call computing the same function; B1, B4, their
     integer and packed variants at random operands and at the root
     call's operands (every row in slot 0, the other slots dead); B3 also
     with two slots holding one leaf id; the leaf refit's grouping
     (leaf_group, bitwise against its twin on the card) and sums (the
     whole call bitwise against index_add_ on the CPU), at uniform leaf
     ids and with one leaf holding SKEW_LEAF_ROWS of the rows (the
     largest leaf of multiclass_int8); B1-int and B2 also at bagged
     operands (about
     20% of the rows with zero stats, about 20% of the features masked)
     and at GOSS operands (the grad, hess and row mask of one sampled
     tree of goss_int8: about 70% of the rows out, the rest kept by the
     draw upscaled by 8), at multiclass operands (class 0's softmax
     gradients of an iteration of multiclass_int8) and at lambdarank
     operands (the host lambdas of lambdarank_int8), bitwise;
     the wide variants of B1, B4 (random and root), B2 (random and
     root) and B3 on the wide paths' learners, each wide row with its
     plan's cluster (blocks a cluster, bins a block) and the walks of
     each entry (1 at max_bin=1023; where more, a second bound counts
     the live rows once a walk); the leaf sums beside the floor that
     their row-order contract sets (the largest leaf's dependent adds),
     at phase 4's operands and on every path that refits; B1 and B1-int
     on the efb learners' bundle columns, random and root operands; B2
     and B2-wide at monotone operands (constraints on half of the
     features, finite bounds binding on two thirds of the children),
     bitwise, and the constraints must change some record; the leaf
     sums' f64 instance (Booster.refit's) at the uniform and skewed
     operands, bitwise against index_add_ in f64 on the CPU, beside its
     floor at DADD_CYCLES an add; B1 (data_psum_hilo), B1-int (the
     shard's own grad, hess and row mask), B3 and the leaf sums of
     data_int8 on one shard's operands (shard 1 of 2: n_pad/2 rows from
     row0 = n_pad/2);
  5. the card against the CPU path at a reduced size (50,000 rows): hilo,
     binary int8 and packed hilo by AUC; regression int8 (fused) and
     packed regression int8 (pallas2, and pallas: B4), all with the leaf
     refit off, by their whole model text (only the device_type line
     normalized), which must be byte-identical, and the packed ones also
     to the card's unpacked run; two refit-on int8 trainings on the
     card, which must write the same text; and int8 regression with the
     refit off, bagging, feature_fraction, a validation set and an early
     stop that fires, built in and with fobj, whose texts, evals_result
     curves and best iterations must be equal card to CPU; at
     max_bin=1023 (wide bins), hilo by AUC and regression int8 with the
     refit off, fused and pallas (B4), by their whole model text; int8
     regression with the refit off under goss (learning_rate 0.25, 8
     iterations), dart (drop_rate 0.5, skip_drop 0), rf and
     feature_fraction_bynode=0.5, by their whole model text, and lgb.cv
     (3 folds) by its result dict; hilo dart by AUC; int8
     regression_l1, huber, quantile, lambdarank (queries of 50) and GOSS
     with regression_l1, the refit off, by their whole model text;
     multiclass hilo and int8 by the held-out multi_logloss of the last
     fifth of the rows, within AUC_TOL; a saved model file loaded back
     on the card, whose raw scores must equal the saving booster's; and,
     with columns 22-27 as categories, int8 regression with the refit off
     on a label with category effects, by its whole model text, with
     one-hot and sorted-CTR splits, at max_bin=255, at max_bin=511 with
     column 27 as 300 categories (wide) and at max_bin=15 with the columns
     of 12 categories or fewer categorical (packed), categorical hilo by AUC,
     the categorical hilo model saved and loaded back on the card (raw
     scores equal on rows with NaN and unseen categories), and
     LGBMClassifier's text equal to lgb.train's with its params; and on
     the first 20,000 rows of the sparse table (63 leaves), int8
     regression with the refit off by its whole model text, hilo by AUC,
     and predict of the CSR rows equal to predict of their dense copy;
     and on the first 20,000 dense rows (63 leaves, 4 iterations), int8
     regression with the refit off under mono_int8's constraints and
     under CEGB by their whole model text, hilo with the forced splits by
     its trees (leaf values within 1e-5 of each tree's largest; a
     threshold may differ only at a gain tie that cuts the node's rows
     the same way),
     deterministic=true by its trees (within 1e-12), and int8 with
     deterministic=true against the same without it on the card, by the
     model text; the first 20,000 dense rows as CSV loaded with
     two_round, int8 regression with the refit off, by the whole model
     text; and the first 20,000 rows of the sparse table with sparse
     storage, max_bin=63 and deterministic=true, 3 iterations, by their
     f64 trees (within 1e-12), and on the card by its whole model text
     against a second card run and the card's all-dense run; and an int8
     regression continuation with a validation set by its whole model
     text, its refit by the refit's text (leaf values bit for bit) and its
     contributions of 500 rows bit for bit; and an int8 regression
     bundle (bagging) written on the card after 3 iterations and resumed
     on the CPU to 6, and one written on the CPU and resumed on the card,
     each by its whole model text against the uninterrupted card run;
     and a streamed int8 regression (blocks of 16,384 rows, refit off)
     card against CPU by its whole text, and its bundle written at the
     midpoint on either device resumed on the other, both the
     uninterrupted card run's text; and data_int8's regression (refit
     on) card against CPU by its whole text, and at full width data_int8
     with the refit off against the serial int8 path's text on the
     card; and the workers' small int8 regression across the two
     processes, card against CPU and against the CPU's in-process run.
A line "build ledger" before the kernels line gives the kernel
library's build (built or loaded, seconds, hash), the distinct launch
plans of each kernel site over the run, and stream_int8's plan held to
the ledger (membudget.ledger_cross_check).
With --profile, after phase 4, two more iterations of every path run
under torch.profiler and the device time by op, each port kernel's
device time per call on the path and the device's idle share are
printed.
The line before the last is {"kernels": [...]}, the last is
{"ok": true, "device": {...}}.  The dense data is the seeded synthetic
generator of bench.py (its non-env branch), copied here; the sparse
table is efb_data's, from the same seed.
"""

import atexit
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

N_TRAIN = 1_000_000
N_HOLD = 100_000
N_FEAT = 28
ITERS = 10
# the integer flat and packed paths, which exist to launch their variants
ITERS_INT_VARIANT = 5
N_SMALL = 50_000
ITERS_SMALL = 5
# the small run's AUC on the card and on the CPU: their trees differ only
# where f32 sums taken in another order flip an exact tie between split
# gains (noise-level gains of pure leaves), which moves a few leaves
AUC_TOL = 5e-3
# kernel B1 against its twin: count rows exact; g and h within this
# fraction of the slot's sum of |stat|, the f32 summation-order bound
HIST_RTOL = 1e-6
# device_ms: profiles taken before a timing with too few launches seen
# fails
PROFILE_TRIES = 3
# device_ms: the least calls one profile times.  After minutes of
# training a profile drops its first device records, a number that
# grows with the process's age and not with the calls (on an H100: 12
# of 20 calls and 12 of 200 after 150 s, the profiler's log counting
# them "Out-of-range"; 17-20 of 20 in phase 4;
# probes/profiler_starvation.py)
PROFILE_CALLS = 100
# phase 4's bagged operands: the share of the rows with zero stats and of
# the features masked (bagging_fraction and feature_fraction 0.8)
BAG_OUT = 0.2
PEAK_BYTES_S = 3.35e12     # H100 SXM HBM3
PEAK_F32_S = 67e12         # H100 SXM f32 outside the tensor cores
PEAK_ALU_S = 67e12         # H100 SXM scalar rate (the f32 row of the table)
# cycles from one f32 add to the next that depends on it (the issue
# latency of FADD on sm_70 and later): the leaf sums' serial chain
FADD_CYCLES = 4
# H100 SXM f64 outside the tensor cores (NVIDIA's data sheet); the
# dependent-issue latency of DADD assumed for the refit's f64 chain (8
# cycles, as measured for sm_70 by Jia et al., "Dissecting the NVIDIA
# Volta GPU Architecture via Microbenchmarking", 2018); phase 4 prints
# the cycles an add the f64 sums take beside it
PEAK_F64_S = 34e12
DADD_CYCLES = 8
# phase 4's skewed leaf-sum operands: one leaf holds this many of the
# n_pad rows (multiclass_int8's largest leaf on an H100)
SKEW_LEAF_ROWS = 570_000
PARAMS = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
          "min_data_in_leaf": 20, "max_bin": 255, "metric": "auc",
          "tree_learner": "serial", "tpu_hist_precision": "hilo",
          "tpu_partition_impl": "kernel", "tpu_shape_buckets": 0,
          "verbosity": -1}
# the JAX package's defaults (select partition, shape buckets, auto
# histogram) at max_bin=15: every feature has 16 bins or fewer, so the
# learner stores the bins 4-bit packed
PACKED_PARAMS = {"objective": "binary", "num_leaves": 255,
                 "learning_rate": 0.1, "min_data_in_leaf": 20,
                 "max_bin": 15, "metric": "auc", "verbosity": -1}
# the wide paths: more than 256 bins a feature, stored int32
WIDE_PARAMS = dict(PARAMS, max_bin=1023)
# (name, params, iterations, kernels the path must launch)
PATHS = [
    ("hilo", PARAMS, ITERS, ("hist_batched", "partition_rows")),
    ("int8", dict(PARAMS, tpu_hist_precision="int8"), ITERS,
     ("hist_batched_int", "fused_hist_scan", "partition_rows",
      "leaf_group", "leaf_sums")),
    ("flat", dict(PARAMS, tpu_hist_impl="pallas"), ITERS,
     ("hist_flat", "partition_rows")),
    ("flat_int8", dict(PARAMS, tpu_hist_impl="pallas",
                       tpu_hist_precision="int8"), ITERS_INT_VARIANT,
     ("hist_flat_int", "partition_rows", "leaf_group", "leaf_sums")),
    ("packed", PACKED_PARAMS, ITERS, ("hist_batched_packed",)),
    ("packed_int8", dict(PACKED_PARAMS, tpu_hist_precision="int8",
                         tpu_hist_impl="pallas2"), ITERS_INT_VARIANT,
     ("hist_batched_packed_int", "leaf_group", "leaf_sums")),
    ("packed_flat", dict(PACKED_PARAMS, tpu_hist_impl="pallas"), ITERS,
     ("hist_flat_packed",)),
    ("packed_flat_int8", dict(PACKED_PARAMS, tpu_hist_impl="pallas",
                              tpu_hist_precision="int8"), ITERS_INT_VARIANT,
     ("hist_flat_packed_int", "leaf_group", "leaf_sums")),
    ("wide", WIDE_PARAMS, ITERS, ("hist_batched_wide",
                                  "partition_rows_wide")),
    ("wide_int8", dict(WIDE_PARAMS, tpu_hist_precision="int8"), ITERS,
     ("hist_batched_wide_int", "fused_hist_scan_wide", "partition_rows_wide",
      "leaf_group", "leaf_sums")),
    ("wide_flat", dict(WIDE_PARAMS, tpu_hist_impl="pallas"),
     ITERS_INT_VARIANT, ("hist_flat_wide", "partition_rows_wide")),
    ("wide_flat_int8", dict(WIDE_PARAMS, tpu_hist_impl="pallas",
                            tpu_hist_precision="int8"), ITERS_INT_VARIANT,
     ("hist_flat_wide_int", "partition_rows_wide", "leaf_group",
      "leaf_sums")),
]


# the validation path (the configuration users run): int8 under its
# defaults with bagging, feature_fraction, a held-out validation set built
# with reference= the training set, two metrics and early stopping
VALID_PARAMS = dict(PARAMS, tpu_hist_precision="int8", bagging_fraction=0.8,
                    bagging_freq=1, feature_fraction=0.8,
                    metric=["auc", "binary_logloss"])
ITERS_VALID = 20
EARLY_STOP = 5
# the custom-objective path: binary logloss gradients from the host
ITERS_FOBJ = 5
# iterations timed with and without evaluating the validation set, twice
ITERS_EVAL_COST = 5

# the boosting modes and per-node feature sampling, at full width
INT_KERNELS = ("hist_batched_int", "fused_hist_scan", "partition_rows",
               "leaf_group", "leaf_sums")
# GOSS at learning_rate 0.1: 10 full iterations, then 5 sampled
GOSS_PARAMS = dict(PARAMS, tpu_hist_precision="int8", boosting="goss",
                   top_rate=0.2, other_rate=0.1)
ITERS_GOSS = 15
# per-node feature masks: the grower leaves B2's in-launch scan
BYNODE_PARAMS = dict(PARAMS, tpu_hist_precision="int8",
                     feature_fraction_bynode=0.5)
# DART's defaults; its drop generator (drop_seed 4) skips every drop of
# the first 12 iterations and drops 1 and 2 trees at iterations 13 and 15
DART_PARAMS = dict(PARAMS, boosting="dart", drop_rate=0.1, skip_drop=0.5,
                   max_drop=50)
ITERS_DART = 15
RF_PARAMS = dict(PARAMS, tpu_hist_precision="int8", boosting="rf",
                 bagging_fraction=0.8, bagging_freq=1, feature_fraction=0.8)
CV_PARAMS = dict(PARAMS, tpu_hist_precision="int8")
ITERS_CV = 5
NFOLD = 3

# the objective zoo at full width, its labels cut from the generator's
# latent (the logits plus their logistic noise) at its quintiles
ITERS_ZOO = 5
# the categorical and EFB paths: 5 iterations keep the whole run, the
# sharded paths included, well inside its time limit
ITERS_CAT = 5
ITERS_EFB = 5
# LightGBM's examples/multiclass_classification: 5 classes, one tree a
# class an iteration, each through the fused int8 step
MULTICLASS_PARAMS = dict(PARAMS, objective="multiclass", num_class=5,
                         tpu_hist_precision="int8",
                         metric=["multi_logloss", "multi_error"])
# learning to rank on MSLR-WEB-style queries of about 100 documents:
# relevance 0-4, the sync step with the lambdas on the host
QUERY_ROWS = 100
RANK_PARAMS = dict(PARAMS, objective="lambdarank", tpu_hist_precision="int8",
                   metric="ndcg", eval_at=[1, 3, 5])
# MAE regression on the latent: the sync step with the host percentile
# refit of every leaf
L1_PARAMS = dict(PARAMS, objective="regression_l1", metric="l1")


# categorical features at full width: the generator's columns 22-27 cut
# into the cardinalities of the airline data of LightGBM's categorical
# experiments (day of week, month, hour, day of month, carrier, airport)
CAT_COLS = [22, 23, 24, 25, 26, 27]
CAT_CARDS = [3, 7, 12, 31, 100, 250]
# categorical splits keep the select-family partition (B3 takes numerical
# splits only, as the JAX package's partition kernel does).  The
# 3-category column searches in the one-hot mode (max_cat_to_onehot 4),
# but on this data its splits never win at full width: the generator's
# label is a function of the underlying values, which the 100 and 250
# categories keep at a finer grain (0 one-hot of 218 categorical splits in
# 10 trees on an H100; the JAX package also makes none at 200,000 rows).
# Phase 5 holds both modes to the CPU on a label with category effects
CAT_PARAMS = dict(PARAMS, tpu_partition_impl="select")
# (name, params, kernels the path must launch, kernels it must not)
CAT_PATHS = [
    ("cat_hilo", CAT_PARAMS, ("hist_batched",), ("partition_rows",)),
    ("cat_int8", dict(CAT_PARAMS, tpu_hist_precision="int8"),
     ("hist_batched_int", "leaf_group", "leaf_sums"),
     ("fused_hist_scan", "partition_rows")),
]
# phase 5's wide categorical run: column 27 recoded into this many
CAT_WIDE_CARD = 300

# sparse one-hot data in the shape of the Flight Delay table of LightGBM's
# EFB experiments (Ke et al., "LightGBM: A Highly Efficient Gradient
# Boosting Decision Tree", NIPS 2017, Table 1: 10M rows x 700 features):
# a numerical Distance and these one-hot blocks, 697 features, 8 stored
# values a row, in a scipy CSR matrix
EFB_BLOCKS = (("Month", 12), ("DayofMonth", 31), ("DayOfWeek", 7),
              ("DepHour", 24), ("UniqueCarrier", 22), ("Origin", 300),
              ("Dest", 300))
# the carriers and airports take category k with weight k^-EFB_SKEW (the
# busiest airport about 1% of the flights, the quietest 0.25%): every
# category stays far under the 20% a bundle candidate may hold, and at
# this skew the seeded data packs into the plan of EFB_COLUMNS (at 0.3
# and above, Origin's and Dest's rarest airports meet on too few rows of
# the plan's sample to keep apart, and the greedy spreads them over more
# bundles)
EFB_SKEW = 0.25
# B3 is refused with bundles (as the JAX package refuses its partition
# kernel), so the JAX package's default partition, select, applies
EFB_PARAMS = dict(PARAMS, tpu_partition_impl="select")
# (name, params, kernels the path must launch, kernels it must not)
EFB_PATHS = [
    ("efb_hilo", EFB_PARAMS, ("hist_batched",),
     ("fused_hist_scan", "partition_rows")),
    ("efb_int8", dict(EFB_PARAMS, tpu_hist_precision="int8"),
     ("hist_batched_int", "leaf_group", "leaf_sums"),
     ("fused_hist_scan", "partition_rows")),
]
# the plan's columns: one bundle a small block, two for each of Origin
# and Dest (a bundle holds at most B - 1 = 254 one-hot features), and
# Distance alone
EFB_COLUMNS = 10
# phase 5 on the first rows of the same data; 63 leaves (K=3) keep the
# CPU's split searches over 697 features short
N_EFB_SMALL = 20_000
EFB_SMALL_LEAVES = 63


# monotone constraints, CEGB, forced splits and deterministic=true, at
# full width on the dense data: 0 on the squared columns 0-7, the sign of
# the generator's linear coefficient on columns 8-27 (mono_constraints)
MONO_PARAMS = dict(PARAMS, tpu_hist_precision="int8")
# rows and grid values of each constrained column of the monotonicity
# check
MONO_ROWS, MONO_GRID = 1000, 32
# CEGB, sized from the split gains of the int8 path at 1M rows (root
# about 48,000 falling to 12,000 by the tenth tree, median split about
# 400): a coupled penalty of 2,000 on columns 0-13 (a feature is bought
# once, by a split gaining that much), a lazy 0.02 a row not yet paid on
# columns 14-17 (20,000 at the root), a split penalty of 0.001 a row
CEGB_PARAMS = dict(PARAMS, tpu_hist_precision="int8",
                   cegb_penalty_feature_coupled=[2000.0] * 14 + [0.0] * 14,
                   cegb_penalty_feature_lazy=[0.0] * 14 + [0.02] * 4
                   + [0.0] * 10,
                   cegb_penalty_split=0.001)
# the forced splits: the root on column 8 at 0.0, its children on
# columns 9 and 10 at 0.0
FORCED_TREE = {"feature": 8, "threshold": 0.0,
               "left": {"feature": 9, "threshold": 0.0},
               "right": {"feature": 10, "threshold": 0.0}}
FORCED_HEAD = (8, 9, 10)
DET_PARAMS = dict(PARAMS, deterministic=True, tpu_hist_impl="xla")
ITERS_DET = 5
# file ingest: the training rows as `label,f0..f27` CSV with
# %.9g (make_data's values are float32, whose nine digits round back to
# them), int8
FILE_PARAMS = dict(PARAMS, tpu_hist_precision="int8")
ITERS_FILE = 5
# sparse COO storage on efb_data: Origin's and Dest's one-hot columns
# (about 1% of the rows each, or less) go to COO, the calendar, hour and
# carrier columns (3.2% of the rows or more) stay dense
SPARSE_THRESHOLD = 0.02
SPARSE_PARAMS = dict(EFB_PARAMS, enable_bundle=False,
                     tpu_sparse_threshold=SPARSE_THRESHOLD)
ITERS_SPARSE = 5
SPARSE_COO_FEATURES = 600
# phase 5 of the file paths: rows bin_construct_sample_cnt samples from
TWO_ROUND_SMALL_SAMPLE = 5000
# phase 5 of sparse_hilo, f64: the CPU side's f64 one-hot blocks of the
# 97 dense columns grow with the bins, so the check bins to 63
SPARSE_SMALL_MAX_BIN = 63
ITERS_SPARSE_SMALL = 3
# phase 5 of these paths: rows, leaves and iterations on card and CPU
N_CONSTRAINT_SMALL = 20_000
CONSTRAINT_SMALL_LEAVES = 63
ITERS_CONSTRAINT_SMALL = 4
# f64 trees card against CPU: leaf values within this share of the
# tree's largest
F64_RTOL = 1e-12
# float trees card against CPU (tests/test_torch_slice.py:test_trees_equal)
FLOAT_RTOL = 1e-5


def mono_constraints(w):
    """The mono_int8 path's constraints: 0 on columns 0-7, the sign of
    make_data's linear coefficient w_j on columns 8-27."""
    return [0] * 8 + [int(np.sign(v)) for v in w[8:]]


def logloss_fobj(scores, train_set):
    """Binary logloss gradients on the host (numpy), as a user's fobj."""
    s = scores.reshape(-1)
    p = 1.0 / (1.0 + np.exp(-s))
    return p - train_set.get_label(), p * (1.0 - p)


def l2_fobj(scores, train_set):
    """L2 regression gradients on the host (numpy)."""
    s = scores.reshape(-1)
    return s - train_set.get_label(), np.ones_like(s)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def make_data(n, f, seed=42, with_w=False):
    """bench.py's synthetic Higgs-shaped generator (non-env branch);
    with_w: also its linear coefficients w."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.normal(size=(f,))
    logits = (X[:, :8] ** 2 - 1.0).sum(axis=1) * 0.3 + X @ w * 0.5
    y = (logits + rng.logistic(size=n) > 0).astype(np.float64)
    if with_w:
        return X.astype(np.float64), y, w
    return X.astype(np.float64), y


def make_latent(n, f, seed=42):
    """make_data's latent of each row (its logits plus the logistic
    noise that y thresholds at 0), from the same generator draws."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.normal(size=(f,))
    logits = (X[:, :8] ** 2 - 1.0).sum(axis=1) * 0.3 + X @ w * 0.5
    return logits + rng.logistic(size=n)


def cat_data(X, cols=CAT_COLS, cards=CAT_CARDS, n_fit=N_TRAIN):
    """X with the columns `cols` recoded as category codes: each cut at
    the quantiles of its first n_fit rows into `cards` categories, the
    codes relabelled through a permutation from np.random.default_rng(42),
    so that their order carries no signal a numerical split could use."""
    Xc = X.copy()
    rng = np.random.default_rng(42)
    for c, k in zip(cols, cards):
        edges = np.quantile(X[:n_fit, c], np.arange(1, k) / k)
        Xc[:, c] = rng.permutation(k)[np.digitize(X[:, c], edges)]
    return Xc


def cat_splits(booster):
    """(one-hot, sorted-CTR) categorical splits over the booster's trees:
    a categorical node on a feature of max_cat_to_onehot bins or fewer
    was found in the one-hot mode."""
    booster.num_trees()                  # the lazy trees materialized
    driver = booster._driver
    num_bin = driver.learner.meta_np["num_bin"]
    onehot_max = int(driver.config.max_cat_to_onehot)
    onehot = ctr = 0
    for tree in driver.models:
        for j in range(tree.num_leaves - 1):
            if int(tree.decision_type[j]) & 1:
                if num_bin[int(tree.split_feature_inner[j])] <= onehot_max:
                    onehot += 1
                else:
                    ctr += 1
    return onehot, ctr


def cat_path(lgb, kernels, ds, Xc, y, params, must_launch, must_not):
    """Phase 3, paths cat_hilo and cat_int8: main_path on the categorical
    data; fails unless the trees hold categorical splits, which it counts
    by mode."""
    report, booster = main_path(lgb, kernels, ds, Xc, y, params, ITERS_CAT,
                                must_launch, must_not)
    onehot, ctr = cat_splits(booster)
    if onehot + ctr == 0:
        fail("no categorical split on a categorical path")
    report.update(cat_splits_onehot=onehot, cat_splits_ctr=ctr,
                  cat_splits_per_tree=(onehot + ctr) / ITERS_CAT)
    return report, booster


def efb_data(n, seed=42):
    """(X, y, latent): the Flight Delay-shaped one-hot table, n rows as a
    scipy CSR matrix of f64.  Distance is gamma distributed; each row
    takes one category of each block, uniform for the calendar blocks,
    and with weights k^-EFB_SKEW by rank for the carriers and airports;
    the latent adds a seeded effect of each category, a distance term
    and normal noise, and y cuts it at its median."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    dist = rng.gamma(2.0, 350.0, n) + 30.0
    latent = 0.0008 * dist + rng.normal(size=n)
    cols = [np.zeros(n, np.int64)]
    off = 1
    for name, k in EFB_BLOCKS:
        if name in ("UniqueCarrier", "Origin", "Dest"):
            w = np.arange(1, k + 1) ** -EFB_SKEW
            code = rng.choice(k, size=n, p=w / w.sum())
        else:
            code = rng.integers(0, k, n)
        latent += rng.normal(size=k)[code] * 0.5
        cols.append(off + code)
        off += k
    indices = np.stack(cols, axis=1).reshape(-1).astype(np.int32)
    data = np.ones((n, len(cols)))
    data[:, 0] = dist
    X = sp.csr_matrix((data.reshape(-1), indices,
                       np.arange(0, n * len(cols) + 1, len(cols))),
                      shape=(n, off))
    y = (latent > np.median(latent)).astype(np.float64)
    return X, y, latent


def efb_path(lgb, kernels, ds, X, y, params, must_launch, must_not):
    """Phase 3, paths efb_hilo and efb_int8: main_path on the sparse
    data (the held-out rows predicted from CSR); fails unless the learner
    planned EFB_COLUMNS bundle columns.  Adds the plan, the bytes of the
    bins on the card against the plain columns', the plan's host
    seconds, and the expansion of one round's 2K bundle histograms to
    the features (split search's first step) timed on the card."""
    import torch
    from lightgbm_tpu_torch.ops.grower import expand_bundles

    report, booster = main_path(lgb, kernels, ds, X, y, params, ITERS_EFB,
                                must_launch, must_not)
    learner = booster._driver.learner
    plan = learner.bundle_plan
    if plan is None or plan.num_columns != EFB_COLUMNS:
        fail(f"EFB planned {None if plan is None else plan.num_columns} "
             f"columns, expected {EFB_COLUMNS}")
    B = learner.num_bins
    C = 2 * learner.params.split_batch
    dev = learner.bins_t.device
    gen = torch.Generator(device=dev).manual_seed(11)
    hist = torch.rand((C, learner.g_pad, B, 3), generator=gen, device=dev)
    tot = hist[:, 0].sum(1)
    expand_ms = cuda_ms(lambda: expand_bundles(
        hist, tot[:, 0], tot[:, 1], tot[:, 2], learner.meta), 20)
    report.update(
        plan_columns=plan.num_columns,
        plan_groups=[len(g) for g in plan.groups],
        plan_column_bins=[int(b) for b in plan.num_bin],
        num_features=learner.num_features, g_pad=learner.g_pad,
        plain_bins_bytes=learner.num_features * learner.n_pad,
        efb_plan_s=learner.efb_s["plan"], efb_apply_s=learner.efb_s["apply"],
        expand_ms_per_search=expand_ms,
        expand_shape=f"[{C}, {learner.g_pad}, {B}, 3] -> "
                     f"[{C}, {learner.f_pad}, {B}, 3]")
    return report, booster


def split_features(booster):
    """The real feature of every split of every tree of a booster."""
    return np.concatenate([t.split_feature[:t.num_leaves - 1]
                           for t in booster._driver.models])


def mono_path(lgb, kernels, X, y, w):
    """mono_int8: int8 under its defaults (the refit on) with
    `mono_constraints(w)`, B2's scan reading the children's bounds; the
    predictions of MONO_ROWS held-out rows along MONO_GRID values of each
    constrained column must be monotone in its direction.  The
    constraints are a Dataset parameter, read when it is constructed (as
    in the JAX package), so the path bins its own."""
    import torch

    mono = mono_constraints(w)
    params = dict(MONO_PARAMS, monotone_constraints=mono)
    t0 = time.perf_counter()
    ds = lgb.Dataset(X[:N_TRAIN], label=y[:N_TRAIN],
                     params=dict(params)).construct()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    if list(ds._inner.monotone_constraints) != mono:
        fail("mono_int8: the dataset does not hold the constraints")
    report, booster = main_path(lgb, kernels, ds, X, y, params, ITERS,
                                INT_KERNELS)
    report["ingest_s"] = ingest_s
    report.update(check_monotone(booster, X, mono, "mono_int8"))
    return report, booster


def check_monotone(booster, X, mono, name):
    """The predictions of MONO_ROWS held-out rows along MONO_GRID values
    of each constrained column must be monotone in its direction; fails
    otherwise.  Returns the check's counts for the path's report."""
    feats = split_features(booster)
    constrained = [j for j, c in enumerate(mono) if c]
    rows = X[N_TRAIN:N_TRAIN + MONO_ROWS]
    grid = np.linspace(-3.0, 3.0, MONO_GRID)
    worst = 0.0
    for j in constrained:
        probe = np.repeat(rows, MONO_GRID, axis=0)
        probe[:, j] = np.tile(grid, MONO_ROWS)
        pred = booster.predict(probe, raw_score=True).reshape(MONO_ROWS,
                                                              MONO_GRID)
        step = np.diff(pred, axis=1) * mono[j]
        worst = min(worst, float(step.min()))
        if step.min() < 0:
            fail(f"{name}: predictions fall along column {j} against "
                 f"its constraint {mono[j]} (by {-step.min()})")
    return {"constraints": mono, "splits": int(feats.size),
            "splits_on_constrained": int(np.isin(feats, constrained).sum()),
            "grid_checks": len(constrained) * MONO_ROWS * (MONO_GRID - 1),
            "worst_step": worst}


def cegb_path(lgb, kernels, ds, X, y, plain):
    """cegb_int8: CEGB_PARAMS through the sync step, B1-int every round
    and no B2; fewer distinct features than the int8 path `plain` (the
    same iterations) may split.  Prints both paths' root gains."""
    report, booster = main_path(lgb, kernels, ds, X, y, CEGB_PARAMS, ITERS,
                                ("hist_batched_int", "leaf_group",
                                 "leaf_sums"),
                                must_not=("fused_hist_scan",))
    used, used_plain = (sorted({int(f) for f in split_features(b)})
                        for b in (booster, plain))
    report.update({
        "features_used": used, "int8_features_used": used_plain,
        "root_gains": [float(t.split_gain[0])
                       for t in booster._driver.models],
        "int8_root_gains": [float(t.split_gain[0])
                            for t in plain._driver.models]})
    if len(used) >= len(used_plain):
        fail(f"cegb_int8 split on {len(used)} features, the int8 path on "
             f"{len(used_plain)}: the penalties took none away")
    return report, booster


def forced_path(lgb, kernels, ds, X, y, path):
    """forced_hilo: hilo (B1, B3) with FORCED_TREE in the JSON file
    `path`; every tree's first three splits must be the forced ones, on
    the bins of their thresholds."""
    report, booster = main_path(lgb, kernels, ds, X, y,
                                dict(PARAMS, forcedsplits_filename=path),
                                ITERS, ("hist_batched", "partition_rows"))
    report["forced_bins"] = check_forced(booster, ds, "forced_hilo")
    return report, booster


def check_forced(booster, ds, name):
    """Every tree's first three splits must be FORCED_TREE's, on the
    bins of their thresholds; fails otherwise.  Returns the bins."""
    mappers = ds._inner.mappers
    want = [int(mappers[f].value_to_bin(0.0)) for f in FORCED_HEAD]
    for i, t in enumerate(booster._driver.models):
        head = [int(f) for f in t.split_feature[:3]]
        bins = [int(b) for b in t.threshold_in_bin[:3]]
        if head != list(FORCED_HEAD) or bins != want:
            fail(f"{name}: tree {i} starts with features {head} at "
                 f"bins {bins}, not {list(FORCED_HEAD)} at {want}")
    return want


def det_path(lgb, kernels, ds, X, y, hilo_report):
    """det_f64: deterministic=true (f64 histograms in torch ops, no
    histogram kernel; B3), trained twice: the two model texts must be
    byte-identical.  Returns the second run's report with both texts'
    equality and ms an iteration beside hilo's."""
    must_not = ("hist_batched", "hist_batched_int", "fused_hist_scan")
    texts, runs = [], []
    for _ in range(2):
        report, booster = main_path(lgb, kernels, ds, X, y, DET_PARAMS,
                                    ITERS_DET, ("partition_rows",), must_not)
        if booster._driver.learner.params.precision != "f64":
            fail("det_f64: the learner does not run f64 histograms")
        texts.append(booster.model_to_string())
        runs.append(report["train_s"])
    if texts[0] != texts[1]:
        fail("det_f64: two runs wrote different model texts")
    report.update({"texts_identical": True,
                   "ms_per_iter": [1e3 * s / ITERS_DET for s in runs],
                   "hilo_ms_per_iter": 1e3 * hilo_report["train_s"] / ITERS})
    return report, booster


def write_csv(path, X, y):
    """The rows as `label,f0..f<F-1>` CSV, %.9g; returns the seconds."""
    t0 = time.perf_counter()
    with open(path, "w") as f:
        f.write(",".join(["label"] + [f"f{i}" for i in range(X.shape[1])])
                + "\n")
        np.savetxt(f, np.column_stack([y, X]), delimiter=",", fmt="%.9g")
    return time.perf_counter() - t0


def _rss_bytes():
    """This process's resident memory, from /proc/self/status."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


class PeakRss:
    """The peak resident memory of this process over a with block,
    above its level at the block's start, sampled every 2 ms by a
    thread (`peak_bytes`)."""

    def __enter__(self):
        import threading

        self.base = _rss_bytes()
        self.peak_bytes = 0
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.002):
                self.peak_bytes = max(self.peak_bytes,
                                      _rss_bytes() - self.base)
        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak_bytes = max(self.peak_bytes, _rss_bytes() - self.base)
        return False


def load_file(lgb, path, params):
    """(constructed Dataset, wall seconds, peak RSS bytes) of a file."""
    import torch

    with PeakRss() as rss:
        t0 = time.perf_counter()
        ds = lgb.Dataset(path, params=dict(params)).construct()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return ds, wall, rss.peak_bytes


def file_paths(lgb, kernels, X, y, tmp):
    """file_int8 and file_two_round_int8: the training rows written once
    as CSV; file_int8 loads it in one pass and trains FILE_PARAMS, whose
    model text must equal an in-memory run's on the values the file
    holds (named f0..f27); file_two_round_int8 loads it with two_round
    and save_binary, trains, then loads the same path again, which must
    take the binary cache without parsing and train the same text.

    %.9g of a float32 value reads back as the double nearest its nine
    digits, which is seldom the float32 value itself, but rounds to it:
    so the in-memory run takes the file's values, read with pandas'
    correctly rounded converter (float_precision="round_trip"), not the
    parser's, and they must round to the rows' float32 values.  Returns
    {name: (report, booster)}."""
    import pandas as pd

    path = os.path.join(tmp, "higgs.csv")
    Xtr, ytr = X[:N_TRAIN], y[:N_TRAIN]
    write_s = write_csv(path, Xtr, ytr)
    size = os.path.getsize(path)
    names = [f"f{i}" for i in range(X.shape[1])]
    ds, ingest_s, rss = load_file(lgb, path, FILE_PARAMS)
    parts = ds._inner.ingest_s
    report, booster = main_path(lgb, kernels, ds, X, y, FILE_PARAMS,
                                ITERS_FILE, INT_KERNELS)
    held = pd.read_csv(path, float_precision="round_trip").to_numpy(
        np.float64)[:, 1:]
    if not np.array_equal(held.astype(np.float32), Xtr.astype(np.float32)):
        fail("file_int8: the file's values do not round to the rows'")
    mem = lgb.train(dict(FILE_PARAMS), lgb.Dataset(
        held, label=ytr, feature_name=names, params=dict(FILE_PARAMS)),
        ITERS_FILE)
    del held
    if mem.model_to_string() != booster.model_to_string():
        fail("file_int8: the model text differs from the in-memory run's")
    report.update(file_bytes=size, write_s=write_s, ingest_s=ingest_s,
                  parse_s=parts["parse"], sketch_s=parts["sketch"],
                  binning_s=parts["binning"], peak_rss_bytes=rss,
                  text_equals_in_memory=True)
    out = {"file_int8": (report, booster)}
    del ds
    two = dict(FILE_PARAMS, two_round=True, save_binary=True)
    ds, ingest_s, rss2 = load_file(lgb, path, two)
    parts = ds._inner.ingest_s
    if parts.get("two_round") != 1.0:
        fail("file_two_round_int8: the load did not take the two-round "
             "loader")
    # pass 2 holds one chunk of the raw rows, the one-pass load all of them
    if rss2 > rss / 2:
        fail(f"file_two_round_int8: peak RSS {rss2} B, not under half the "
             f"one-pass load's {rss} B")
    if not os.path.exists(path + ".bin"):
        fail("file_two_round_int8: save_binary wrote no cache")
    report, booster = main_path(lgb, kernels, ds, X, y, two, ITERS_FILE,
                                INT_KERNELS)
    del ds
    again, bin_s, rss3 = load_file(lgb, path, two)
    if "binary" not in again._inner.ingest_s \
            or "parse" in again._inner.ingest_s:
        fail("file_two_round_int8: the second load did not take the "
             "binary cache")
    b3 = lgb.train(dict(two), again, ITERS_FILE)
    if b3.model_to_string() != booster.model_to_string():
        fail("file_two_round_int8: the cached dataset trains another text")
    report.update(file_bytes=size, ingest_s=ingest_s, parse_s=parts["parse"],
                  sketch_s=parts["sketch"], binning_s=parts["binning"],
                  peak_rss_bytes=rss2, one_pass_peak_rss_bytes=rss,
                  cache_bytes=os.path.getsize(path + ".bin"),
                  cache_load_s=bin_s, cache_peak_rss_bytes=rss3,
                  cache_text_identical=True)
    out["file_two_round_int8"] = (report, booster)
    return out


def predict_dataset_path(lgb, ds, booster, X, y):
    """predict_dataset: the held-out rows as a Dataset binned with the
    training set's mappers (reference=), predicted from its bins; the
    raw scores must equal predict of the rows bit for bit.  Rows/s of
    both, the Dataset's construction apart."""
    import torch

    Xho = X[N_TRAIN:]
    t0 = time.perf_counter()
    valid = lgb.Dataset(Xho, label=y[N_TRAIN:], reference=ds).construct()
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    booster.predict(valid, raw_score=True)        # the forest tables made
    t0 = time.perf_counter()
    from_ds = booster.predict(valid, raw_score=True)
    ds_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    from_rows = booster.predict(Xho, raw_score=True)
    rows_s = time.perf_counter() - t0
    if not np.array_equal(from_ds, from_rows):
        fail("predict_dataset: the Dataset's raw scores differ from the "
             "rows' (max |diff| "
             f"{float(np.abs(from_ds - from_rows).max())})")
    return {"rows": len(Xho), "construct_s": construct_s,
            "dataset_rows_per_s": len(Xho) / ds_s,
            "array_rows_per_s": len(Xho) / rows_s, "bit_equal": True}


# ---- the model utilities ---------------------------------------------------
# continue_int8: 5 iterations, then 5 more from the saved model
ITERS_CONTINUE = 5
# refit_int8: a fresh draw of the generator
REFIT_SEED = 43
# raw_walk: the prediction early stop's frequency and margin
EARLY_STOP_FREQ = 2
EARLY_STOP_MARGIN = 1.5
# contrib_hilo: rows of the numpy twin's check (one row at a time)
CONTRIB_TWIN_ROWS = 64


def strip_mapper_trailer(text):
    """A model text without its `tpu_bin_mappers:` line, as upstream
    LightGBM writes it: loaded, it predicts through the raw-value
    walker."""
    return "".join(line for line in text.splitlines(True)
                   if not line.startswith("tpu_bin_mappers:"))


def _tree_blocks(text):
    return text.split("\ntree_sizes=")[1].split("\nend of trees")[0]


def continue_path(lgb, kernels, ds, X, y, tmp):
    """continue_int8: int8 for ITERS_CONTINUE iterations with the
    held-out rows as a validation set, its model saved; then
    lgb.train(init_model=<that file>) for ITERS_CONTINUE more with
    snapshot_freq=ITERS_CONTINUE into a temp output_model, on a
    keep_training_booster; then one rollback.  The replay's seconds (the
    init trees onto the 1,000,000 training and 100,000 validation rows),
    iters/s of the continued rounds, the valid AUC."""
    import torch
    from lightgbm_tpu_torch.models.gbdt import GBDT

    params = dict(PARAMS, tpu_hist_precision="int8")
    Xho, yho = X[N_TRAIN:], y[N_TRAIN:]
    valid = ds.create_valid(Xho, label=yho)
    init_file = os.path.join(tmp, "continue_init.txt")
    out_model = os.path.join(tmp, "continue.txt")
    replay = []
    merge = GBDT.merge_from_model_string

    def timed_merge(self, text):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        merge(self, text)
        torch.cuda.synchronize()
        replay.append(time.perf_counter() - t0)

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    init = lgb.train(params, ds, ITERS_CONTINUE, valid_sets=[valid],
                     valid_names=["v"], verbose_eval=False)
    init.save_model(init_file)
    init_s = time.perf_counter() - t0
    evals = {}
    rounds_from = []

    def first_round(env):
        # the continued rounds start: the booster built, the init model
        # replayed
        if env.iteration == 0:
            torch.cuda.synchronize()
            rounds_from.append(time.perf_counter())
    first_round.before_iteration = True

    GBDT.merge_from_model_string = timed_merge
    try:
        t0 = time.perf_counter()
        booster = lgb.train(dict(params, snapshot_freq=ITERS_CONTINUE,
                                 output_model=out_model), ds,
                            ITERS_CONTINUE, valid_sets=[valid],
                            valid_names=["v"], init_model=init_file,
                            evals_result=evals, verbose_eval=False,
                            callbacks=[first_round],
                            keep_training_booster=True)
        trees = booster.num_trees()
        torch.cuda.synchronize()
        done = time.perf_counter()
        train_s = done - t0
    finally:
        GBDT.merge_from_model_string = merge
    text = booster.model_to_string()
    booster.rollback_one_iter()
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    for name in INT_KERNELS:
        if launches[name] <= 0:
            fail(f"continue_int8: kernel {name} was not launched")
    if trees != 2 * ITERS_CONTINUE or booster.num_trees() != trees - 1:
        fail(f"continue_int8: {trees} trees, then {booster.num_trees()} "
             "after the rollback")
    with open(init_file) as f:
        init_text = f.read()
    if _tree_blocks(booster.model_to_string(num_iteration=ITERS_CONTINUE)) \
            != _tree_blocks(init_text):
        fail("continue_int8: the first trees are not the init model's")
    snap = f"{out_model}.snapshot_iter_{ITERS_CONTINUE}"
    with open(snap) as f:
        if f.read() != text:
            fail("continue_int8: the snapshot differs from the model text "
                 "it was written from")
    scores = booster._driver.train_scores.numpy()[0]
    pred = booster.predict(X[:N_TRAIN], raw_score=True)
    err = float(np.abs(scores - pred).max())
    if not err <= 1e-6:
        fail(f"continue_int8: after the rollback the train scores are "
             f"{err} from the {trees - 1}-iteration model's predict")
    valid_auc = evals["v"]["auc"][-1]
    if not 0.6 < valid_auc <= 1.0:
        fail(f"continue_int8: valid AUC {valid_auc}")
    return {"init_train_s": init_s, "replay_s": replay[0],
            "replay_rows": N_TRAIN + N_HOLD, "replay_trees": ITERS_CONTINUE,
            "continued_train_s": train_s,
            "set_up_s": rounds_from[0] - t0,
            "iters_per_s": ITERS_CONTINUE / (done - rounds_from[0]),
            "valid_auc": valid_auc,
            "rollback_max_abs_err": err, "snapshot_equal": True,
            "init_trees_equal": True, "launches": launches,
            "launches_per_tree": {k: v / (2 * ITERS_CONTINUE)
                                  for k, v in launches.items()}}, booster


def refit_path(lgb, kernels, booster, X, y):
    """refit_int8: the int8 path's 10-iteration booster refit on a fresh
    N_TRAIN-row draw of the generator (seed REFIT_SEED): leaf_group and
    the f64 leaf sums must launch; each tree's leaf values must equal, bit
    for bit, a second refit whose sums are the CPU twin's (index_add_ in
    f64) on the card's leaf ids and gradients.  Refit seconds, the f64
    sums' device ms a tree (one call at each tree's operands, beside the
    f32 instance on the same operands), held-out AUC before and after."""
    import torch
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops import leafsum

    Xr, yr = make_data(N_TRAIN, N_FEAT, seed=REFIT_SEED)
    Xho, yho = X[N_TRAIN:], y[N_TRAIN:]
    before_auc = auc(booster.predict(Xho), yho)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    refit = booster.refit(Xr, yr, decay_rate=0.9)
    trees = refit.num_trees()
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    for name in ("leaf_group", "leaf_sums_f64"):
        if launches[name] <= 0:
            fail(f"refit_int8: kernel {name} was not launched")
    operands = []

    def cpu_sums(ids, vals, L, out_dtype):
        operands.append((ids.clone(), vals.clone(), L))
        return leafsum.leaf_sums_plain(ids.cpu(), vals.cpu(), L,
                                       out_dtype).to(ids.device)

    twin = lgb.Booster(model_str=booster._driver.save_model_to_string(),
                       params=booster.params)
    twin._driver.refit(Xr, yr, 0.9, config=Config(booster.params),
                       sums=cpu_sums)
    for a, b in zip(refit._driver.models, twin._driver.models):
        nl = a.num_leaves
        if not np.array_equal(a.leaf_value[:nl], b.leaf_value[:nl]):
            fail("refit_int8: a tree's leaf values differ from the CPU "
                 "twin's sums on the same leaf ids and gradients")
    after_auc = auc(refit.predict(Xho), yho)
    # the sums alone at each tree's operands (the twin's, taken on the
    # card): the grouping and the sums of each instance, by CUDA events
    # (a profile here would leave phase 4's profiles short of events)
    ms = {torch.float64: [], torch.float32: []}
    for ids, vals, L in operands:
        for dt in ms:
            ms[dt].append(cuda_ms(
                lambda: leafsum.leaf_sums_kernel(ids, vals, L, dt), 10))
    largest = max(int(torch.bincount(ids.long()).max())
                  for ids, _, _ in operands)
    return {"refit_s": refit_s, "rows": N_TRAIN, "trees": trees,
            "f64_sums_event_ms_per_tree": float(np.mean(ms[torch.float64])),
            "f32_sums_event_ms_per_tree_same_operands":
                float(np.mean(ms[torch.float32])),
            "largest_leaf_rows": largest,
            "holdout_auc_before": before_auc,
            "holdout_auc_after": after_auc, "twin_bit_equal": True,
            "launches": launches,
            "launches_per_tree": {k: v / trees for k, v in launches.items()}}


def raw_walk_path(lgb, kernels, booster, X):
    """raw_walk: the hilo booster's text without its mapper trailer,
    loaded on the card, predicts the held-out rows through the raw-value
    walker: raw scores, pred_leaf, the trained booster with
    tpu_predict_device=false, and pred_early_stop (EARLY_STOP_FREQ,
    EARLY_STOP_MARGIN).  The f64 scores must equal the numpy Tree.predict
    walk bit for bit and lie within 1e-6 of the bin-space predict; the
    leaves must be the bin-space leaf index; the early stop must equal the
    numpy walk's loop.  Rows/s of each, the stopped share."""
    import torch
    from lightgbm_tpu_torch.ops.predict import leaf_index, raw_scores_plain

    Xho = X[N_TRAIN:]
    bare = lgb.Booster(model_str=strip_mapper_trailer(
        booster.model_to_string()))
    if bare._driver._pred_ctx is not None:
        fail("raw_walk: the stripped text still carries its mappers")
    trees = bare._driver.models
    # a second margin: the median |raw score|, which stops rows early
    median = float(np.median(np.abs(booster.predict(Xho, raw_score=True))))
    kernels.reset_launches()
    out, secs = {}, {}
    for name, fn in (
            ("raw", lambda: bare.predict(Xho, raw_score=True)),
            ("leaf", lambda: bare.predict(Xho, pred_leaf=True)),
            ("host", lambda: booster.predict(Xho, raw_score=True,
                                             tpu_predict_device=False)),
            ("early_stop", lambda: bare.predict(
                Xho, raw_score=True, pred_early_stop=True,
                pred_early_stop_freq=EARLY_STOP_FREQ,
                pred_early_stop_margin=EARLY_STOP_MARGIN)),
            ("early_stop_median", lambda: bare.predict(
                Xho, raw_score=True, pred_early_stop=True,
                pred_early_stop_freq=EARLY_STOP_FREQ,
                pred_early_stop_margin=median))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = raw_scores_plain(trees, Xho, 1)[0]
    plain_s = time.perf_counter() - t0
    if not np.array_equal(out["raw"], plain):
        fail("raw_walk: the f64 scores differ from the numpy walk's (max "
             f"{float(np.abs(out['raw'] - plain).max())})")
    if not np.array_equal(out["host"], plain):
        fail("raw_walk: tpu_predict_device=false differs from the numpy "
             "walk")
    binned = booster.predict(Xho, raw_score=True)
    err = float(np.abs(out["raw"] - binned).max())
    if not err <= 1e-6:
        fail(f"raw_walk: {err} from the bin-space predict")
    drv = booster._driver
    tables, depth = drv._forest(len(drv.models))
    ctx = drv._pred_ctx
    bins_leaf = leaf_index(tables, ctx.bin_rows_t(Xho, drv.device),
                           *ctx.meta_dev(drv.device), depth)
    if not np.array_equal(out["leaf"], bins_leaf.T.cpu().numpy()):
        fail("raw_walk: pred_leaf differs from the bin-space leaf index")
    for key, margin in (("early_stop", EARLY_STOP_MARGIN),
                        ("early_stop_median", median)):
        es_plain = raw_scores_plain(trees, Xho, 1, EARLY_STOP_FREQ,
                                    margin)[0]
        if not np.array_equal(out[key], es_plain):
            fail(f"raw_walk: the early stop at margin {margin} differs from "
                 "the numpy walk's")
    return {"rows": len(Xho), "trees": len(trees),
            **{f"{k}_rows_per_s": len(Xho) / v for k, v in secs.items()},
            "numpy_walk_rows_per_s": len(Xho) / plain_s,
            "stopped_share": float(np.mean(out["early_stop"] != out["raw"])),
            "median_margin": median, "stopped_share_median": float(
                np.mean(out["early_stop_median"] != out["raw"])),
            "max_abs_err_to_bin_space": err, "launches": dict(
                kernels.launches)}


def contrib_path(lgb, booster, X):
    """contrib_hilo: pred_contrib of the hilo booster (10 trees of 255
    leaves) on the 100,000 held-out rows, batched on the card; the first
    CONTRIB_TWIN_ROWS rows bit for bit the numpy twin's, and every row's
    contributions summing to its raw f64 score within 1e-9.  Rows/s."""
    import torch
    from lightgbm_tpu_torch.models import shap

    Xho = X[N_TRAIN:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = booster.predict(Xho, pred_contrib=True)
    secs = time.perf_counter() - t0
    trees = booster._driver.models
    if got.shape != (len(Xho), N_FEAT + 1) or not np.isfinite(got).all():
        fail(f"contrib_hilo: contributions of shape {got.shape}")
    t0 = time.perf_counter()
    twin = shap.forest_contribs(trees, Xho[:CONTRIB_TWIN_ROWS], len(trees),
                                1)[:, 0, :]
    twin_s = time.perf_counter() - t0
    if not np.array_equal(got[:CONTRIB_TWIN_ROWS], twin):
        fail("contrib_hilo: the batched contributions differ from the "
             "numpy twin's")
    raw = booster.predict(Xho, raw_score=True, tpu_predict_device=False)
    err = float(np.abs(got.sum(axis=1) - raw).max())
    if not err <= 1e-9:
        fail(f"contrib_hilo: the contributions sum {err} from the raw score")
    return {"rows": len(Xho), "trees": len(trees), "seconds": secs,
            "rows_per_s": len(Xho) / secs,
            "twin_rows_per_s": CONTRIB_TWIN_ROWS / twin_s,
            "max_abs_sum_err": err, "twin_bit_equal": True}


def sparse_hist_ms(learner):
    """Device ms of one round's sparse histograms and their merge with the
    dense columns' into feature order (the torch ops beside B1), at K
    slots over random leaf ids of the learner's rows."""
    import torch
    from lightgbm_tpu_torch.ops.grower import merged_histograms

    meta = learner.meta
    dev = learner.bins_t.device
    p = learner.params
    K, L, B = p.split_batch, p.num_leaves, p.num_bins
    gen = torch.Generator(device=dev).manual_seed(5)
    leaf = torch.randint(0, L, (learner.n_pad,), generator=gen, device=dev,
                         dtype=torch.int32)
    slots = torch.arange(0, 2 * K, 2, dtype=torch.int32, device=dev)
    sp_stats = torch.rand((meta["sp_rows"].shape[0], 5), generator=gen,
                          device=dev)
    dense = torch.rand((K, learner.g_pad, B, 3), generator=gen, device=dev)

    return cuda_ms(lambda: merged_histograms(dense, meta, sp_stats, leaf,
                                             slots, B, L, "hilo"), 20)


def sparse_path(lgb, kernels, ds, X, y):
    """sparse_hilo: SPARSE_PARAMS on the efb_data Dataset (the bins are
    the features'; the learner lays them out), B1 on the dense columns
    and no B3, SPARSE_COO_FEATURES features as COO; the same with
    tpu_sparse_threshold=0 (every feature dense), whose held-out AUC the
    sparse path's must meet within AUC_TOL.  Returns both paths' reports
    and boosters."""
    must = ("hist_batched",)
    must_not = ("partition_rows", "hist_batched_int", "fused_hist_scan")
    report, booster = main_path(lgb, kernels, ds, X, y, SPARSE_PARAMS,
                                ITERS_SPARSE, must, must_not)
    learner = booster._driver.learner
    if learner.sparse is None or len(learner.sparse["sparse_idx"]) \
            != SPARSE_COO_FEATURES:
        fail(f"sparse_hilo: {0 if learner.sparse is None else len(learner.sparse['sparse_idx'])} "
             f"features as COO, expected {SPARSE_COO_FEATURES}")
    dense_report, dense_booster = main_path(
        lgb, kernels, ds, X, y, dict(SPARSE_PARAMS, tpu_sparse_threshold=0.0),
        ITERS_SPARSE, must, must_not)
    diff = abs(report["holdout_auc"] - dense_report["holdout_auc"])
    if diff > AUC_TOL:
        fail(f"sparse_hilo: held-out AUC {report['holdout_auc']} against "
             f"{dense_report['holdout_auc']} all dense")
    dl = dense_booster._driver.learner
    prof = profile(booster, iters=1)
    report.update(
        coo_features=len(learner.sparse["sparse_idx"]),
        num_features=learner.num_features,
        coo_share=len(learner.sparse["sparse_idx"]) / learner.num_features,
        coo_entries=learner.sparse["entries"],
        coo_bytes=learner.sparse["coo_bytes"],
        dense_columns=learner.num_columns,
        dense_bins_bytes=report["bins_bytes"],
        stored_bytes=report["bins_bytes"] + learner.sparse["coo_bytes"],
        all_dense_bins_bytes=dl.bins_t.numel() * dl.bins_t.element_size(),
        all_dense_feature_bytes=dl.num_features * dl.n_pad,
        sparse_hist_ms_per_round=sparse_hist_ms(learner),
        host_ops_per_iter=prof["host_torch_ops_per_iter"],
        profiled_kernels=prof["kernels"],
        device_busy_ms_per_iter=1e3 * prof["device_busy_s"],
        device_idle_share=prof["device_idle_share"],
        all_dense_iters_per_s=dense_report["iters_per_s"],
        all_dense_holdout_auc=dense_report["holdout_auc"],
        auc_diff=diff)
    return report, booster


def quintiles(latent):
    """0-4: the latent cut at the quintiles of its first N_TRAIN rows."""
    return np.digitize(latent, np.quantile(latent[:N_TRAIN],
                                           [0.2, 0.4, 0.6, 0.8])
                       ).astype(np.float64)


def metric_value(name, score, label, obj=None, group=None, **params):
    """The port's metric `name` of raw scores [k, n] through the output
    conversion of the objective `obj` (each ndcg@k of eval_at for
    ndcg); params configure it."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.models.metrics import create_metric

    cfg = Config({"metric": name, **params})
    m = create_metric(name, cfg)
    m.init(Metadata(len(label), label, None, group), len(label))
    vals = m.eval_all(np.asarray(score, np.float64), obj)
    return vals[0][1] if len(vals) == 1 else dict(vals)


def auc(score, label):
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.models.metrics import AUCMetric

    m = AUCMetric(None)
    m.init(Metadata(len(label), label), len(label))
    return m.eval(np.asarray(score, np.float64)[None, :], None)


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps launches, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps, kernels_of=None, launches=1):
    """Device time per fn() of the port's own kernels, from
    torch.profiler: unlike cuda_ms it leaves out the time the device
    waits for the host between calls, which is what back-to-back CUDA
    events read when a call is shorter than its Python wrapper.
    kernels_of: as profile's.  launches: the port kernel launches one
    fn() makes (one for each port wrapper), or None where that is not a
    fixed number.

    A profile's last device events can arrive only in a later profile
    (seen on an H100: 15 of 20 launches seen, or none and then twice as
    many; a sum over the launches seen then read a quarter low).  So an
    empty profile first takes stragglers of earlier ones, another after
    the timed one takes its own, and the time is the mean over the
    launches seen times `launches`; with launches=None it is the sum
    seen over the calls.  A profile drops its first device records once
    the process has trained for minutes (seen on an H100: 0 to 9 of 20
    launches in phase 4's first row), so it times at least
    PROFILE_CALLS calls.  Where a profile saw fewer than half the
    launches, more are taken, up to PROFILE_TRIES in all, until the
    launches seen in them together reach half of one profile's."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()

    def launches_of(prof):
        events = _device_events(prof)
        labels = (kernels_of or port_kernels)([ev.name for ev in events])
        return [float(ev.self_device_time_total)
                for ev, label in zip(events, labels) if label is not None]

    calls = max(reps, PROFILE_CALLS)
    us = []
    for _ in range(PROFILE_TRIES):
        with tprofile(activities=acts):
            torch.cuda.synchronize()
        with tprofile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        with tprofile(activities=acts) as late:
            torch.cuda.synchronize()
        if launches is None:
            return sum(launches_of(prof) + launches_of(late)) / 1e3 / calls
        us += launches_of(prof) + launches_of(late)
        if len(us) >= calls * launches // 2:
            return sum(us) / len(us) * launches / 1e3
    fail(f"torch.profiler saw {len(us)} port kernel launches in "
         f"{PROFILE_TRIES} profiles of {calls} calls")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    """The card's highest SM clock, MHz (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0])


def leaf_sums_floor(n, L, longest, mhz, cycles=FADD_CYCLES, out_bytes=4):
    """The least time of the leaf sums (ms) on this card, from what the
    row-order contract imposes: the largest leaf's `longest` rows as one
    chain of dependent adds (`cycles` each at the highest SM clock: f32
    FADD_CYCLES; f64 DADD_CYCLES, out_bytes 8), after the function's own
    bytes moved once (n leaf ids and 2n f32 values read, 2L sums
    written).  Returns (floor, chain)."""
    chain = longest * cycles / (mhz * 1e3)
    nbytes = n * 4 + 2 * n * 4 + 2 * L * out_bytes
    return chain + nbytes / PEAK_BYTES_S * 1e3, chain


def largest_leaf(booster):
    """The most rows of one leaf over the booster's trees."""
    booster.num_trees()                  # the lazy trees materialized
    return max(int(t.leaf_count[:t.num_leaves].max())
               for t in booster._driver.models)


def main_path(lgb, kernels, ds, X, y, params, iters, must_launch,
              must_not=()):
    """Phase 3, one path: train + predict at full width; returns the
    report and the booster.  must_not: kernels the path must not launch."""
    import torch

    Xho, yho = X[N_TRAIN:], y[N_TRAIN:]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    booster = lgb.train(dict(params), ds, num_boost_round=iters,
                        keep_training_booster=True)
    trees = booster.num_trees()       # materializes: one records fetch
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    driver = booster._driver
    train_auc = [v for _, name, v, _ in booster.eval_train()
                 if name == "auc"][0]
    t0 = time.perf_counter()
    pred = booster.predict(Xho)
    predict_s = time.perf_counter() - t0
    if trees != iters:
        fail(f"trained {trees} trees, expected {iters}")
    if not np.all(np.isfinite(pred)) or pred.shape != (N_HOLD,):
        fail(f"held-out predictions: shape {pred.shape}, finite "
             f"{bool(np.all(np.isfinite(pred)))}")
    for name in must_launch:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on this path")
    for name in must_not:
        if launches[name] != 0:
            fail(f"kernel {name} was launched {launches[name]} times on "
                 "this path, which must not launch it")
    packed = any("_packed" in name for name in must_launch)
    if driver.learner.packed_bins != packed:
        fail(f"the bins are {'not ' if packed else ''}4-bit packed on "
             "this path")
    wide = any("_wide" in name for name in must_launch)
    if (driver.learner.bins_t.dtype == torch.int32) != wide:
        fail(f"the bins are {driver.learner.bins_t.dtype} on this path")
    hold_auc = auc(pred, yho)
    if not 0.6 < train_auc <= 1.0 or not 0.6 < hold_auc <= 1.0:
        fail(f"AUC out of range: train {train_auc}, held-out {hold_auc}")
    learner = driver.learner
    rows = getattr(learner.bins_t, "_lgbt_rows", (None, None))[1]
    return {"train_s": train_s, "iters_per_s": iters / train_s,
            "train_auc": train_auc, "holdout_auc": hold_auc,
            "predict_s": predict_s, "predict_rows_per_s": N_HOLD / predict_s,
            "host_syncs_per_tree": driver.grower_syncs / trees,
            "launches_per_tree": {k: v / trees for k, v in launches.items()},
            "launches": launches, "n_pad": learner.n_pad,
            "f_pad": learner.f_pad, "hist_impl": learner.params.hist_impl,
            "packed_bins": learner.packed_bins,
            "num_bins": learner.num_bins,
            "bins_dtype": str(learner.bins_t.dtype),
            "bins_bytes": learner.bins_t.numel()
            * learner.bins_t.element_size(),
            "row_major_bytes": (None if rows is None else
                                rows.numel() * rows.element_size()),
            "precision": learner.params.precision,
            "split_batch": learner.params.split_batch}, booster


def count_syncs(fn):
    """Run fn() and return the host waits on the device it made, as
    torch's sync debug mode reports them (one warning each: a blocking
    copy, `.item()`, a stream synchronize)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(1 for w in seen if "synchroniz" in str(w.message))


def valid_path(lgb, kernels, ds, X, y):
    """Phase 3, path valid_bag_int8: lgb.train with the held-out rows as
    a validation set, evaluated every iteration, early stopping on; then
    the added cost of that evaluation.  Returns (report, booster)."""
    import torch

    valid = lgb.Dataset(X[N_TRAIN:], label=y[N_TRAIN:],
                        reference=ds).construct()
    evals = {}
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    booster = lgb.train(dict(VALID_PARAMS), ds, num_boost_round=ITERS_VALID,
                        valid_sets=[valid], valid_names=["valid"],
                        evals_result=evals, early_stopping_rounds=EARLY_STOP,
                        verbose_eval=False, keep_training_booster=True)
    trees = booster.num_trees()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    grower_syncs = booster._driver.grower_syncs
    for name in ("hist_batched_int", "fused_hist_scan", "partition_rows",
                 "leaf_group", "leaf_sums"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on path valid_bag_int8")
    driver = booster._driver
    curve = evals["valid"]["auc"]
    best = booster.best_iteration
    if len(curve) != trees or not 1 <= best <= trees \
            or len(evals["valid"]["binary_logloss"]) != trees:
        fail(f"valid_bag_int8: {trees} trees, {len(curve)} evaluations, "
             f"best iteration {best}")
    if not all(0.6 < v <= 1.0 for v in curve):
        fail(f"valid_bag_int8: valid AUC out of range: {curve}")
    # predict defaults to the best iteration and agrees with the valid
    # scores kept on the card (trees summed in another order)
    hold_auc = auc(booster.predict(X[N_TRAIN:]), y[N_TRAIN:])
    if abs(hold_auc - curve[best - 1]) > 1e-4:
        fail(f"valid_bag_int8: predict's AUC {hold_auc} is not the best "
             f"iteration's valid AUC {curve[best - 1]}")
    if driver._bag_cfg is None:
        fail("valid_bag_int8: bagging is not configured")
    # the added cost of evaluating: iterations without and with it, in
    # turns (the host's pace drifts), in wall time; then the host waits
    # of one iteration each way, counted apart from the timing
    def iterations(evaluate, count):
        for _ in range(count):
            booster.update()
            if evaluate:
                booster.eval_valid()
        booster.num_trees()
        torch.cuda.synchronize()

    spent = {False: [], True: []}
    for evaluate in (False, True, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iterations(evaluate, ITERS_EVAL_COST)
        spent[evaluate].append((time.perf_counter() - t0) / ITERS_EVAL_COST)
    mean = {e: sum(v) / len(v) for e, v in spent.items()}
    # all waits, and the grower's stop tests among them, an iteration
    waits, grower_waits = {}, {}
    for evaluate in (False, True):
        before = driver.grower_syncs
        waits[evaluate] = count_syncs(
            lambda: iterations(evaluate, ITERS_EVAL_COST)) / ITERS_EVAL_COST
        grower_waits[evaluate] = (driver.grower_syncs
                                  - before) / ITERS_EVAL_COST
    return {"train_s": train_s, "iters_per_s": trees / train_s,
            "valid_auc": curve, "trees": trees, "best_iteration": best,
            "best_score": booster.best_score, "holdout_auc": hold_auc,
            "host_syncs_per_tree": grower_syncs / trees,
            "host_waits_per_iter_without_eval": waits[False],
            "host_waits_per_iter_with_eval": waits[True],
            "grower_waits_per_iter_without_eval": grower_waits[False],
            "grower_waits_per_iter_with_eval": grower_waits[True],
            "iter_s_without_eval": spent[False],
            "iter_s_with_eval": spent[True],
            "eval_s_per_iter": mean[True] - mean[False],
            "launches_per_tree": {k: v / trees for k, v in launches.items()},
            "launches": launches, "n_pad": driver.learner.n_pad,
            "n_valid": N_HOLD}, booster


def fobj_path(lgb, kernels, ds, X, y):
    """Phase 3, path fobj_hilo: binary logloss gradients given as fobj
    (numpy on the host) through the sync step, hilo histograms and B3.
    Returns (report, booster)."""
    import torch

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    booster = lgb.train(dict(PARAMS), ds, num_boost_round=ITERS_FOBJ,
                        fobj=logloss_fobj, keep_training_booster=True)
    trees = booster.num_trees()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    for name in ("hist_batched", "partition_rows"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on path fobj_hilo")
    driver = booster._driver
    if trees != ITERS_FOBJ or driver.objective is not None:
        fail(f"fobj_hilo: {trees} trees, objective {driver.objective}")
    pred = booster.predict(X[N_TRAIN:], raw_score=True)
    if not np.all(np.isfinite(pred)) or pred.shape != (N_HOLD,):
        fail("fobj_hilo: held-out scores not finite or of the wrong shape")
    hold_auc = auc(pred, y[N_TRAIN:])
    if not 0.6 < hold_auc <= 1.0:
        fail(f"fobj_hilo: held-out AUC {hold_auc}")
    return {"train_s": train_s, "iters_per_s": trees / train_s,
            "holdout_auc": hold_auc,
            "host_syncs_per_tree": driver.grower_syncs / trees,
            "launches_per_tree": {k: v / trees for k, v in launches.items()},
            "launches": launches}, booster


def goss_path(lgb, kernels, ds, X, y):
    """Phase 3, path goss_int8: the kept-row share of every tree (the row
    mask the step hands the grower, summed on the card and read after
    training): 1.0 through the warm-up, about top_rate + (1 - top_rate)
    * other_rate / (1 - top_rate) = 0.3 after it."""
    from lightgbm_tpu_torch.ops import grower

    kept = []
    grow = grower.grow

    def spy(params, bins_t, g, h, mask, *rest):
        kept.append(mask.sum())
        return grow(params, bins_t, g, h, mask, *rest)

    grower.grow = spy
    try:
        report, booster = main_path(lgb, kernels, ds, X, y, GOSS_PARAMS,
                                    ITERS_GOSS, INT_KERNELS)
    finally:
        grower.grow = grow
    driver = booster._driver
    n = driver.learner.n
    share = [float(k.item()) / n for k in kept]
    warm = driver._goss_cfg["warmup"]
    if share[:warm] != [1.0] * warm \
            or not all(0.25 < v < 0.35 for v in share[warm:]):
        fail(f"goss_int8: kept-row shares {share} (warm-up {warm})")
    report.update(kept_share=share, warmup=warm)
    return report, booster


def dart_path(lgb, kernels, ds, X, y):
    """Phase 3, path dart_hilo: the trees dropped at each iteration, and
    each f64 walk of a drop set (drop and restore, train rows) timed by
    CUDA events around it on the path."""
    import torch
    from lightgbm_tpu_torch.models import dart, gbdt

    drops, walks = [], []
    drop_fn = dart.DART._dropping_trees
    walk_fn = gbdt.GBDT._score_trees_binned

    def dropping(self):
        drop_fn(self)
        drops.append(len(self._drop_idx))

    def walk(self, bins_t, trees, scales):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = walk_fn(self, bins_t, trees, scales)
        b.record()
        walks.append((a, b, len(trees), int(bins_t.shape[1])))
        return out

    dart.DART._dropping_trees, gbdt.GBDT._score_trees_binned = dropping, walk
    try:
        report, booster = main_path(lgb, kernels, ds, X, y, DART_PARAMS,
                                    ITERS_DART, ("hist_batched",
                                                 "partition_rows"))
    finally:
        dart.DART._dropping_trees = drop_fn
        gbdt.GBDT._score_trees_binned = walk_fn
    torch.cuda.synchronize()
    if not any(drops):
        fail(f"dart_hilo: no tree was dropped ({drops})")
    report.update(dropped_per_iter=drops, drop_walks=[
        {"trees": t, "rows": r, "event_ms": a.elapsed_time(b)}
        for a, b, t, r in walks])
    return report, booster


def drop_walk_ms(booster):
    """The device time of one f64 drop walk of the dart_hilo booster's
    first two trees over its training rows, from torch.profiler: every
    device launch of the walk (pack upload, level gathers, f64 adds)."""
    driver = booster._driver
    trees = driver.models[:2]
    bins_t = driver.train_data.bins_t
    ms = device_ms(lambda: driver._score_trees_binned(bins_t, trees,
                                                      [-1.0, -1.0]), 10,
                   kernels_of=lambda names: ["all"] * len(names),
                   launches=None)
    return {"trees": len(trees), "rows": int(bins_t.shape[1]),
            "device_ms": ms}


def cv_path(lgb, kernels, ds, X, y):
    """Phase 3, path cv_int8: lgb.cv, NFOLD stratified folds of the
    training rows, ITERS_CV rounds; the mean and stdv of the first metric
    after each round, and each round's wall seconds (to the last fold's
    evaluation; the first round includes the folds' set-up)."""
    import torch

    stamps = []
    eval_fn = lgb.Booster.eval_valid

    def timed(self, feval=None):
        out = eval_fn(self, feval)
        stamps.append(time.perf_counter())
        return out

    torch.cuda.synchronize()
    kernels.reset_launches()
    lgb.Booster.eval_valid = timed
    t0 = time.perf_counter()
    try:
        res = lgb.cv(dict(CV_PARAMS), ds, num_boost_round=ITERS_CV,
                     nfold=NFOLD, return_cvbooster=True)
    finally:
        lgb.Booster.eval_valid = eval_fn
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    for name in INT_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on path cv_int8")
    mean, stdv = res["auc-mean"], res["auc-stdv"]
    if len(mean) != ITERS_CV or not all(0.6 < v <= 1.0 for v in mean):
        fail(f"cv_int8: auc-mean {mean}")
    folds = res["cvbooster"].boosters
    preds = res["cvbooster"].predict(X[N_TRAIN:])
    if len(preds) != NFOLD or not all(
            p.shape == (N_HOLD,) and np.all(np.isfinite(p)) for p in preds):
        fail("cv_int8: the fold boosters' predictions")
    ends = [t0] + stamps[NFOLD - 1::NFOLD]

    def nbytes(t):
        return t.numel() * t.element_size()

    fold_bytes = []
    for b in folds:
        d = b._driver
        rows = getattr(d.learner.bins_t, "_lgbt_rows", (None, None))[1]
        fold_bytes.append({
            "train_rows": d.train_data.num_data,
            "valid_rows": d.valid_sets[0].num_data,
            "train_bins": nbytes(d.train_data.bins_t),
            "valid_bins": nbytes(d.valid_sets[0].bins_t),
            "learner_bins": nbytes(d.learner.bins_t),
            "row_major_bins": None if rows is None else nbytes(rows)})
    trees = sum(b.num_trees() for b in folds)
    return {"wall_s": wall, "auc_mean": mean, "auc_stdv": stdv,
            "round_s": [b - a for a, b in zip(ends, ends[1:])],
            "fold_bytes": fold_bytes,
            "holdout_auc_per_fold": [auc(p, y[N_TRAIN:]) for p in preds],
            "launches_per_tree": {k: v / trees for k, v in launches.items()},
            "launches": launches}, folds[0]


def grower_operands(booster, calls=1):
    """The padded grad, hess and row mask the first tree of one more
    iteration of `booster` hands the grower (one sampled GOSS tree of
    goss_int8, class 0 of multiclass_int8, the host lambdas of
    lambdarank_int8); the iteration makes `calls` grower calls."""
    from lightgbm_tpu_torch.ops import grower

    seen = []
    grow = grower.grow

    def spy(params, bins_t, g, h, mask, *rest):
        seen.append((g, h, mask))
        return grow(params, bins_t, g, h, mask, *rest)

    grower.grow = spy
    try:
        booster.update()
        booster.num_trees()
    finally:
        grower.grow = grow
    if len(seen) != calls:
        fail(f"grower_operands: {len(seen)} grower calls, expected {calls}")
    return seen[0]


def zoo_path(lgb, kernels, base_ds, X, label, params, must_launch,
             group=None):
    """Phase 3, a path of the objective zoo: the training rows of the
    binned base dataset (a row subset: no binning again) with their own
    label (and query sizes), ITERS_ZOO iterations, predict of the held-out
    rows.  The sync step's wall seconds a call, and the host seconds a
    call of the objective's gradients and of its leaf refit, are timed
    on the path.  Returns (report, booster, held-out predictions)."""
    import torch
    from lightgbm_tpu_torch.models import gbdt

    ds = base_ds.subset(np.arange(N_TRAIN))
    ds.set_field("label", label[:N_TRAIN])
    if group is not None:
        ds.set_group(group)
    spent = {"sync_step": [], "gradients": [], "leaf_refit": []}
    wrapped = []

    def timed(owner, attr, key):
        fn = getattr(owner, attr)

        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if key == "sync_step" or not torch.is_tensor(out):
                torch.cuda.synchronize()
            spent[key].append(time.perf_counter() - t0)
            return out
        setattr(owner, attr, run)
        wrapped.append((owner, attr, fn))

    from lightgbm_tpu_torch.models.objectives import create_objective
    from lightgbm_tpu_torch.config import Config
    obj_cls = type(create_objective(Config(params)))
    timed(gbdt.GBDT, "_train_one_iter_sync", "sync_step")
    if obj_cls.host_only:
        timed(obj_cls, "get_gradients", "gradients")
    if obj_cls.needs_renew:
        timed(obj_cls, "renew_tree_output", "leaf_refit")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        booster = lgb.train(dict(params), ds, num_boost_round=ITERS_ZOO,
                            keep_training_booster=True)
        trees = booster.num_trees()
        torch.cuda.synchronize()
    finally:
        for owner, attr, fn in wrapped:
            setattr(owner, attr, fn)
    train_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    k = booster.num_model_per_iteration()
    if trees != ITERS_ZOO * k:
        fail(f"trained {trees} trees, expected {ITERS_ZOO * k}")
    for name in must_launch:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on this path")
    t0 = time.perf_counter()
    pred = booster.predict(X[N_TRAIN:], raw_score=True)
    predict_s = time.perf_counter() - t0
    if not np.all(np.isfinite(pred)) or pred.shape != (
            (N_HOLD,) if k == 1 else (N_HOLD, k)):
        fail(f"held-out predictions: shape {pred.shape}, finite "
             f"{bool(np.all(np.isfinite(pred)))}")
    learner = booster._driver.learner
    sync_s = sum(spent["sync_step"])
    report = {
        "train_s": train_s, "iters_per_s": ITERS_ZOO / train_s,
        "predict_s": predict_s, "predict_rows_per_s": N_HOLD / predict_s,
        "trees": trees, "fused_step": booster._driver._step is not None,
        "train_metrics": {n: v for _, n, v, _ in booster.eval_train()},
        "sync_step_s_per_iter": sync_s / ITERS_ZOO,
        "host_gradients_s_per_iter": sum(spent["gradients"]) / ITERS_ZOO,
        "host_leaf_refit_s_per_iter": sum(spent["leaf_refit"]) / ITERS_ZOO,
        "host_share_of_sync_step": (
            (sum(spent["gradients"]) + sum(spent["leaf_refit"])) / sync_s
            if sync_s else None),
        "host_syncs_per_tree": booster._driver.grower_syncs / trees,
        "launches_per_iter": {n: v / ITERS_ZOO for n, v in launches.items()},
        "launches_per_tree": {n: v / trees for n, v in launches.items()},
        "launches": launches, "n_pad": learner.n_pad,
        "hist_impl": learner.params.hist_impl,
        "precision": learner.params.precision,
        "score_bytes": booster._driver.train_scores.scores.numel() * 4}
    return report, booster, pred


def multiclass_path(lgb, kernels, ds, X, latent):
    """Phase 3, path multiclass_int8: 5 classes a fused int8 step each
    an iteration; B1-int and the leaf sums launch once a tree, 5 times
    an iteration (int8: once)."""
    label = quintiles(latent)
    report, booster, raw = zoo_path(lgb, kernels, ds, X, label,
                                    MULTICLASS_PARAMS, INT_KERNELS)
    launches = report["launches"]
    for name in ("hist_batched_int", "leaf_group", "leaf_sums"):
        if launches[name] != report["trees"]:
            fail(f"multiclass_int8: {name} launched {launches[name]} times "
                 f"for {report['trees']} trees")
    if not report["fused_step"]:
        fail("multiclass_int8 took the sync step")
    obj = booster._driver.objective
    prob = booster.predict(X[N_TRAIN:])
    if not np.allclose(prob.sum(axis=1), 1.0, atol=1e-6):
        fail("multiclass_int8: class probabilities do not sum to 1")
    yho = label[N_TRAIN:]
    ll = metric_value("multi_logloss", raw.T, yho, obj,
                      objective="multiclass", num_class=5)
    err = metric_value("multi_error", raw.T, yho, obj,
                       objective="multiclass", num_class=5)
    if not ll < np.log(5.0) or not err < 0.8:
        fail(f"multiclass_int8: held-out multi_logloss {ll}, "
             f"multi_error {err}")
    report.update(holdout_multi_logloss=ll, holdout_multi_error=err)
    return report, booster


def lambdarank_path(lgb, kernels, ds, X, latent):
    """Phase 3, path lambdarank_int8: queries of QUERY_ROWS consecutive
    rows, relevance 0-4, the sync step with the lambdas on the host."""
    label = quintiles(latent)
    group = [QUERY_ROWS] * (N_TRAIN // QUERY_ROWS)
    report, booster, raw = zoo_path(lgb, kernels, ds, X, label, RANK_PARAMS,
                                    INT_KERNELS, group=group)
    if report["fused_step"]:
        fail("lambdarank_int8 took the fused step")
    ho_group = np.full(N_HOLD // QUERY_ROWS, QUERY_ROWS)
    yho = label[N_TRAIN:]
    ndcg = metric_value("ndcg", raw[None], yho, group=ho_group,
                        eval_at=[1, 3, 5])
    rand = metric_value("ndcg", np.random.default_rng(1).normal(
        size=(1, N_HOLD)), yho, group=ho_group, eval_at=[1, 3, 5])
    if not ndcg["ndcg@5"] > rand["ndcg@5"] + 0.05:
        fail(f"lambdarank_int8: held-out {ndcg} against random {rand}")
    report.update(queries=len(group), holdout_ndcg=ndcg,
                  holdout_ndcg_random_scores=rand,
                  query_table_bytes=int(
                      booster._driver.objective.query_boundaries.nbytes
                      + booster._driver.objective.inverse_max_dcgs.nbytes))
    return report, booster


def l1_path(lgb, kernels, ds, X, latent):
    """Phase 3, path l1_hilo: MAE regression on the latent, hilo, the
    sync step with every leaf refit to its residuals' median on the
    host."""
    report, booster, raw = zoo_path(lgb, kernels, ds, X, latent, L1_PARAMS,
                                    ("hist_batched", "partition_rows"))
    if report["fused_step"]:
        fail("l1_hilo took the fused step")
    yho = latent[N_TRAIN:]
    l1 = float(np.abs(yho - raw).mean())
    base = float(np.abs(yho - np.median(latent[:N_TRAIN])).mean())
    if not l1 < base:
        fail(f"l1_hilo: held-out l1 {l1} against the median's {base}")
    report.update(holdout_l1=l1, holdout_l1_of_median=base)
    return report, booster


_VIEW_OPS = {"aten::view", "aten::select", "aten::slice", "aten::as_strided",
             "aten::unbind", "aten::permute", "aten::expand",
             "aten::reshape", "aten::squeeze", "aten::unsqueeze", "aten::t",
             "aten::transpose", "aten::alias", "aten::detach",
             "aten::lift_fresh", "aten::_unsafe_view"}


# device kernel name -> the port kernel (launch counter) it belongs to.
# B1, B4 and B2 are instances of the grouped body: its stats type, its
# tail (B4: Flat, B2: ScanTail) and its bin layout (U8Bins, PackedBins,
# WideBins; before the wide layout, a bool: true for packed bins)
_GROUPED = re.compile(r"grouped_hist_kernel<(float|int), ([^<>]*?), "
                      r"(?:lgbt::(U8|Packed|Wide)Bins|(true|false))>")
_LAYOUT_SUFFIX = {"U8": "", "Packed": "_packed", "Wide": "_wide",
                  "false": "", "true": "_packed"}
_OTHER_KERNELS = ((r"partition_rows_kernel<int>", "partition_rows_wide"),
                  (r"partition_rows_kernel", "partition_rows"),
                  (r"leaf_group_kernel", "leaf_group"),
                  (r"leaf_sums_kernel<double>", "leaf_sums_f64"),
                  (r"leaf_sums_kernel", "leaf_sums"))


def port_kernel(device_name):
    m = _GROUPED.search(device_name)
    if m:
        acc, tail, layout, flag = m.groups()
        suffix = _LAYOUT_SUFFIX[layout or flag]
        if "ScanTail" in tail:
            return "fused_hist_scan" + suffix
        base = "hist_flat" if "Flat" in tail else "hist_batched"
        return base + suffix + ("_int" if acc == "int" else "")
    for part, name in _OTHER_KERNELS:
        if re.search(part, device_name):
            return name
    return None


def port_kernels(device_names):
    """The port kernel of each device launch (None: not the port's)."""
    return [port_kernel(name) for name in device_names]


def _device_events(prof):
    """The device events of a torch.profiler run, in launch order."""
    import torch

    return sorted((ev for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda ev: ev.time_range.start)


def profile(booster, iters=2, kernels_of=None, fobj=None, evaluate=False):
    """`--profile`: where the time of `iters` more iterations goes, from
    torch.profiler's device trace.  kernels_of maps the device launches'
    names, in launch order, to the port kernels they belong to (default
    port_kernels; a caller timing another version of the package gives
    one that knows that version's kernels).  fobj: the path's custom
    gradients; evaluate: each iteration also evaluates the validation
    sets, as lgb.train does."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from lightgbm_tpu_torch.ops import kernels

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with tprofile(activities=acts):
        pass          # takes device events late from a profile before
    kernels.reset_launches()
    syncs = booster._driver.grower_syncs
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            booster.update(fobj=fobj)
            if evaluate:
                booster.eval_valid()
        booster.num_trees()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    calls = dict(kernels.launches)
    syncs = booster._driver.grower_syncs - syncs
    # device busy time: the kernel, copy and set events themselves (the
    # torch ops that launched them carry the same time as self device
    # time, so summing both would count it twice)
    rows = []
    busy_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = float(ev.self_device_time_total)
        busy_us += dev_us
        rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    # host work: the torch ops the Python code issued (top level, views
    # excluded); each is at least one launch or host-side step
    ops = sum(1 for ev in prof.events()
              if ev.cpu_parent is None and ev.name.startswith("aten::")
              and ev.name not in _VIEW_OPS)
    # each port kernel's device launches summed under its name, so that
    # its time per call on the path reads directly (calls: its wrapper's
    # count over the profiled iterations)
    per_kernel = {}
    events = _device_events(prof)
    labels = (kernels_of or port_kernels)([ev.name for ev in events])
    for ev, name in zip(events, labels):
        if name is None:
            continue
        row = per_kernel.setdefault(name, {"calls": calls[name],
                                           "device_launches": 0,
                                           "device_ms": 0.0})
        row["device_launches"] += 1
        row["device_ms"] += float(ev.self_device_time_total) / 1e3
    for row in per_kernel.values():
        # the mean over the launches the profile delivered: a late profile
        # can miss some (device_ms)
        row["ms_per_call"] = row["device_ms"] / row["device_launches"]
    return {"iters": iters, "wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "host_torch_ops_per_iter": ops / iters,
            "host_syncs_per_tree": syncs / iters,
            "kernels": per_kernel,
            "top": [{"kernel": k[:70], "calls": c, "device_ms": d / 1e3}
                    for d, k, c in rows[:12]]}


def _b1_operands(learner):
    """(bins_t, the bins unpacked, packed block, name suffix, bytes of one
    row's bins of a feature in the kernel's row-major copy) of kernel B1
    or B4 on the learner's matrix: packed 4-bit [F, n/2] bins (the packed
    variant), int32 [F, n] (the wide variant, a 16-bit copy) or uint8
    [F, n]."""
    from lightgbm_tpu_torch.ops import histogram as H

    pb = learner.packed_block
    bins_t = learner.bins_t
    full = H.unpack2d(bins_t, pb) if pb else bins_t
    suffix = H.bins_layout(bins_t, pb)[1]
    return bins_t, full, pb, suffix, {"_packed": 0.5, "_wide": 2}.get(
        suffix, 1)


def _wide_plan(learner, S, floats, scan=False, flat=False):
    """The cluster plan of the learner's histogram calls on this card
    (wide bins only, else {}): blocks a cluster, bins a block's tile, and
    the walks of each grouped-list entry per (segment, chunk), 1
    wherever the cluster holds all of B."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    if learner.bins_t.dtype != torch.int32:
        return {}
    plan = H.call_plan(learner.bins_t, S, learner.n_pad,
                       learner.params.split_batch, learner.num_bins, floats,
                       scan=scan, flat=flat)
    return {"cluster": plan.cluster, "bin_tile": plan.bin_tile,
            "grid": plan.grid, "threads": plan.threads,
            "walks": H.plan_walks(plan, learner.num_bins)}


def _bins_shape(learner, F, n, pb):
    dt = {1: "u8", 4: "i32"}[learner.bins_t.element_size()]
    return f"bins [{F}, {n}] {dt}{' packed 4-bit' if pb else ''}"


def _hist_route(learner):
    """(wrapper, name, the TPU kernel it replaces) of the learner's
    histogram: B4 on the flat paths (tpu_hist_impl=pallas), else B1."""
    from lightgbm_tpu_torch.ops import histogram as H

    if learner.params.hist_impl == "pallas":
        return H.hist_flat_kernel, "hist_flat", \
            "lightgbm_tpu/ops/histogram.py:541"
    return H.hist_batched_kernel, "hist_batched", \
        "lightgbm_tpu/ops/histogram.py:584"


def check_hist(learner, gen, operands):
    """Phase 4, kernel B1, or B4 on a flat path (each the packed variant
    on a learner whose bins are packed) at the path's shapes.  operands
    "random": leaf ids over the L leaves, K random slots, one dead (about
    9.4% of the rows live), held to the twin; "root": every row in slot
    0 and the other K-1 slots dead (the root call), held to an f64 sum,
    since the f32 twin's own rounding over a million rows in one slot is
    of the tolerance's order."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    bins_t, full, pb, suffix, bin_bytes = _b1_operands(learner)
    wrapper, route, replaces = _hist_route(learner)
    F, n = full.shape
    B = learner.num_bins
    K = learner.params.split_batch
    stats, g, h = _hilo_stats(learner, gen)
    leaf, slots = _slots_of(learner, gen, operands)

    def kernel():
        return wrapper(bins_t, stats, leaf, slots, B, packed_block=pb)

    def plain():
        return H.hist_batched_plain(bins_t, stats, leaf, slots, B, pb)

    hk = H._unpack_hist(kernel().permute(3, 2, 0, 1), "hilo")
    hp = H._unpack_hist(plain().permute(3, 2, 0, 1), "hilo")
    torch.cuda.synchronize()
    extra = {}
    if operands == "root":
        h64 = _hist_f64(full, stats, leaf, slots, B)
        err, rel = _hist_rel_err(hk.double(), h64, g, h, leaf, slots)
        extra["twin_max_abs_err_vs_f64"] = float(
            (hp.double() - h64).abs().max().item())
        extra["reference"] = "f64 sum of the same stats"
    else:
        err, rel = _hist_rel_err(hk, hp, g, h, leaf, slots)
    lib_ms, m = _index_add_ms(full, stats, leaf, slots, B)
    ms = device_ms(kernel, 20)
    event_ms = cuda_ms(kernel, 20)
    plain_ms = cuda_ms(plain, 5)
    S = stats.shape[0]
    wide = _wide_plan(learner, S, True, flat=route == "hist_flat")
    return {"name": route + suffix, "operands": operands,
            "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/histogram.cu",
            "replaces": replaces,
            "max_abs_err": err, "max_rel_err": rel,
            "tolerance": f"counts exact, g/h rel {HIST_RTOL:g}", "ms": ms,
            "event_ms": event_ms, "plain_ms": plain_ms, **wide,
            **_hist_bound(n, m, F, S, 2, K, F * B * K * S, PEAK_F32_S,
                          bin_bytes, wide.get("walks", 1)),
            "library_ms": lib_ms, **extra,
            "shape": f"{_bins_shape(learner, F, n, pb)}, "
                     f"stats [{S}, {n}] bf16, K={K}, B={B}, live rows {m}"}


def check_partition(learner, gen):
    """Phase 4, kernel B3 at the main path's shapes."""
    import torch
    from lightgbm_tpu_torch.ops import fused

    dev = learner.bins_t.device
    bins_t = learner.bins_t
    F, n = bins_t.shape
    K = learner.params.split_batch
    L = learner.params.num_leaves
    nf = learner.num_features
    meta = learner.meta
    leaf = torch.randint(0, L - K, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    sel = torch.randperm(L - K, generator=gen, device=dev)[:K].to(torch.int32)
    new_ids = (L - K + torch.arange(K, device=dev)).to(torch.int32)
    feat = torch.randint(0, nf, (K,), generator=gen, device=dev,
                         dtype=torch.int32)
    nbf = meta["num_bin"][feat.long()]
    thr = (torch.rand(K, generator=gen, device=dev) * (nbf - 1).float()
           ).to(torch.int32)
    dleft = torch.rand(K, generator=gen, device=dev) < 0.5
    mt = meta["missing_type"][feat.long()]
    db = meta["default_bin"][feat.long()]
    do_k = torch.arange(K, device=dev) < K - 2
    args = (bins_t, feat, leaf, sel, new_ids, thr, dleft, mt, nbf, db, do_k)
    # and two slots holding one leaf id: its rows take the max of the
    # moving slots' new ids
    sel_dup = sel.clone()
    sel_dup[1] = sel_dup[0]
    err = 0
    for a in (args, args[:3] + (sel_dup,) + args[4:]):
        out_k = fused.partition_rows_kernel(*a)
        out_p = fused.partition_rows_plain(*a)
        torch.cuda.synchronize()
        err = max(err, (out_k - out_p).abs().max().item())
    if err != 0:
        fail(f"partition_rows differs from its twin (max err {err})")
    ms = device_ms(lambda: fused.partition_rows_kernel(*args), 20)
    event_ms = cuda_ms(lambda: fused.partition_rows_kernel(*args), 20)
    plain_ms = cuda_ms(lambda: fused.partition_rows_plain(*args), 5)
    m = int(((leaf[None, :] == sel[:, None]) & do_k[:, None]).sum().item())
    # every leaf id read and written, the bin (1 byte, 4 wide) of each
    # row of a splitting slot, the K slots' seven int32 and two bool
    # parameters; a table lookup and a select a row, the decision for
    # those rows
    bin_bytes = bins_t.element_size()
    nbytes = n * 4 + n * 4 + m * bin_bytes + K * (7 * 4 + 2)
    name = "partition_rows" + ("_wide" if bin_bytes == 4 else "")
    return {"name": name, "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/partition.cu",
            "replaces": "lightgbm_tpu/ops/fused.py:296",
            "max_abs_err": float(err), "max_rel_err": float(err),
            "tolerance": "bitwise (and with a duplicated slot)", "ms": ms,
            "event_ms": event_ms, "plain_ms": plain_ms,
            **_bound(nbytes, n * 2 + m * 4, PEAK_ALU_S), "library_ms": None,
            "shape": f"{_bins_shape(learner, F, n, 0)}, leaf [{n}] i32, "
                     f"K={K}, rows of splitting leaves {m}"}


def _hilo_stats(learner, gen):
    """hilo [5, n] stats of random grad/hess on the learner's rows, and
    the grad and hess."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    dev = learner.bins_t.device
    n = learner.n_pad
    mask = learner._ones_mask
    g = torch.randn(n, generator=gen, device=dev) * 0.5 * mask
    h = torch.rand(n, generator=gen, device=dev) * 0.25 * mask
    return H.pack_stats(g, h, mask, "hilo").contiguous(), g, h


def _bag_masks(learner, gen):
    """Bagged operands: a row mask with about BAG_OUT of the live rows
    out, and the feature mask with round(BAG_OUT * F) of the F features
    out, drawn at random."""
    import torch

    dev = learner.bins_t.device
    rows = learner._ones_mask * (torch.rand(
        learner.n_pad, generator=gen, device=dev) >= BAG_OUT).float()
    nf = learner.num_features
    out = torch.randperm(nf, generator=gen, device=dev)[
        :round(BAG_OUT * nf)]
    fmask = learner.feature_mask.clone()
    fmask[out] = 0.0
    return rows, fmask


def _int8_stats(learner, gen, mask=None, gh=None):
    """int8 [3, n] stats of random grad/hess (or the given pair) on the
    learner's rows (or the rows of `mask`), rounded as the quantized
    grower rounds them (nearest)."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    dev = learner.bins_t.device
    n = learner.n_pad
    mask = learner._ones_mask if mask is None else mask
    q = H.quant_limit("int8", n)
    if gh is None:
        gh = (torch.randn(n, generator=gen, device=dev),
              torch.rand(n, generator=gen, device=dev))
    g, h = gh[0] * mask, gh[1] * mask
    gq = H.quantize_values(g, g.abs().max() / q, q, "nearest")
    hq = H.quantize_values(h, h.abs().max() / q, q, "nearest")
    return H.pack_stats(gq, hq, mask, "int8").contiguous()


def _hist_rel_err(hk, hp, g, h, leaf, slots):
    """A float histogram kernel against its twin: counts exact, and g, h
    within HIST_RTOL of each slot's sum of |stat| (each row lands in one
    bin of every feature).  Returns (max abs err, max relative err)."""
    import torch

    err = (hk - hp).abs()
    match = (slots[:, None] == leaf[None, :]).float()
    scale = torch.stack([match @ g.abs(), match @ h.abs()], 1)
    ok_cnt = bool(torch.equal(hk[..., 2], hp[..., 2]))
    rel = (err[..., :2] / scale[:, None, None, :].clamp(min=1e-30)).max()
    if not ok_cnt or rel.item() > HIST_RTOL:
        fail(f"a histogram kernel disagrees with its twin: counts equal "
             f"{ok_cnt}, max relative g/h err {rel.item()}")
    return float(err.max().item()), float(rel.item())


def _bound(nbytes, ops, peak_ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / peak_ops
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _index_add_ms(bins_t, stats, leaf, slots, B):
    """The yardstick: one index_add_ over a precomputed flat
    (feature, bin, slot) index; unmatched rows add into a spare row."""
    import torch

    dev = bins_t.device
    F, n = bins_t.shape
    K = slots.shape[0]
    S = stats.shape[0]
    flat, m = _flat_index(bins_t, leaf, slots, B)
    acc = torch.float32 if stats.is_floating_point() else torch.int32
    vals = stats.to(acc).T[None].expand(F, -1, -1).reshape(-1, S)
    out = torch.zeros(F * B * K + 1, S, device=dev, dtype=acc)
    return cuda_ms(lambda: out.index_add_(0, flat, vals), 5), m


def _slots_of(learner, gen, operands):
    if operands != "root":
        return _random_slots(learner, gen)
    import torch

    dev = learner.bins_t.device
    K = learner.params.split_batch
    leaf = torch.zeros(learner.n_pad, dtype=torch.int32, device=dev)
    slots = torch.full((K,), -1, dtype=torch.int32, device=dev)
    slots[0] = 0
    return leaf, slots


def _hist_bound(n, m, F, S, stat_bytes, K, out_words, peak_ops,
                bin_bytes=1, walks=1):
    """The bound of a K-slot histogram call, from what its inputs need:
    every leaf id, the bins (bin_bytes a feature: 0.5 packed, 2 wide) and
    stats of the m live rows only, the slot ids, and the output written
    once; m * F * S adds.  Beside it the bound that counts every row's
    bins and stats, as earlier versions of this script did, and, where
    the kernel walks each entry walks > 1 times (wide bins past a
    cluster's 8 tiles), the one that counts the live rows' bins and
    stats once a walk, as the kernel reads them."""
    row = F * bin_bytes + S * stat_bytes
    fixed = n * 4 + K * 4 + out_words * 4
    out = {**_bound(fixed + m * row, m * F * S, peak_ops),
           "bound_ms_all_rows": _bound(fixed + n * row, m * F * S,
                                       peak_ops)["bound_ms"]}
    if walks > 1:
        out["bound_ms_walked"] = _bound(fixed + walks * m * row, m * F * S,
                                        peak_ops)["bound_ms"]
    return out


def _flat_index(bins_t, leaf, slots, B):
    """[F * n] flat (feature, bin, slot) index of each row's adds (one
    past the end for rows in no slot) and the live-row count."""
    import torch

    dev = bins_t.device
    F, n = bins_t.shape
    K = slots.shape[0]
    k_of = torch.full((n,), K * F * B, device=dev, dtype=torch.int64)
    for k in reversed(range(K)):
        k_of = torch.where(leaf == slots[k], k, k_of)
    live = k_of < K * F * B
    f_iota = torch.arange(F, device=dev)[:, None]
    flat = torch.where(live[None, :],
                       (f_iota * B + bins_t.long()) * K + k_of[None, :],
                       F * B * K).reshape(-1)
    return flat, int(live.sum().item())


def _hist_f64(bins_t, stats, leaf, slots, B):
    """[K, F, B, 3] f64 histogram of float stats (the reference of the
    root operands; distinct live slot ids)."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    F, n = bins_t.shape
    K = slots.shape[0]
    S = stats.shape[0]
    flat, _ = _flat_index(bins_t, leaf, slots, B)
    vals = stats.double().T[None].expand(F, -1, -1).reshape(-1, S)
    out = torch.zeros(F * B * K + 1, S, device=bins_t.device,
                      dtype=torch.float64).index_add_(0, flat, vals)
    return H._unpack_hist(out[:-1].view(F, B, K, S).permute(3, 2, 0, 1),
                          "hilo")


def _random_slots(learner, gen):
    """Leaf ids over the learner's L leaves and K distinct slot leaves,
    one of them dead."""
    import torch

    dev = learner.bins_t.device
    n = learner.n_pad
    K = learner.params.split_batch
    L = learner.params.num_leaves
    leaf = torch.randint(0, L, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    slots = torch.randperm(L, generator=gen, device=dev)[:K].to(torch.int32)
    slots[K // 2] = -1
    return leaf, slots.contiguous()


def check_hist_int(learner, gen, operands, goss=None):
    """Phase 4, the integer variant of kernel B1, or of B4 on a flat path
    (each packed on a learner whose bins are packed) at the path's shapes
    (operands as check_hist's, or "bagged": random slots over rows of
    which about BAG_OUT have zero stats, or "goss": random slots over
    the grad, hess and row mask `goss` of a sampled GOSS tree, or of a
    tree of another path, "multiclass" and "lambdarank"), bitwise."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    bins_t, full, pb, suffix, bin_bytes = _b1_operands(learner)
    wrapper, route, replaces = _hist_route(learner)
    F, n = full.shape
    B = learner.num_bins
    K = learner.params.split_batch
    rows = _bag_masks(learner, gen)[0] if operands == "bagged" else None
    if goss is not None:
        rows = goss[2]
    stats = _int8_stats(learner, gen, rows, None if goss is None
                        else goss[:2])
    leaf, slots = _slots_of(learner, gen, operands)

    def kernel():
        return wrapper(bins_t, stats, leaf, slots, B, packed_block=pb)

    def plain():
        return H.hist_batched_plain(bins_t, stats, leaf, slots, B, pb)

    raw_k, raw_p = kernel(), plain()
    torch.cuda.synchronize()
    if not torch.equal(raw_k, raw_p):
        fail(f"{route}{suffix} (int8, {operands}) differs from its "
             f"twin: max err {(raw_k - raw_p).abs().max().item()}")
    lib_ms, m = _index_add_ms(full, stats, leaf, slots, B)
    ms = device_ms(kernel, 20)
    event_ms = cuda_ms(kernel, 20)
    plain_ms = cuda_ms(plain, 5)
    S = 3
    extra = _wide_plan(learner, S, False, flat=route == "hist_flat")
    if rows is not None:
        extra["rows_out"] = float(1.0 - rows.sum().item()
                                  / learner._ones_mask.sum().item())
    return {"name": f"{route}{suffix}_int", "operands": operands,
            "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/histogram.cu",
            "replaces": replaces, **extra,
            "max_abs_err": 0.0, "max_rel_err": 0.0, "tolerance": "bitwise",
            "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
            **_hist_bound(n, m, F, S, 1, K, F * B * K * S, PEAK_ALU_S,
                          bin_bytes, extra.get("walks", 1)),
            "library_ms": lib_ms,
            "shape": f"{_bins_shape(learner, F, n, pb)}, "
                     f"stats [3, {n}] int8, K={K}, B={B}, live rows {m}"}


def _leaf_operands(learner, gen, operands):
    """The leaf sums' operands at the int8 path's shapes: leaf ids over
    the L - 1 leaves of the n_pad rows ("uniform"), or with
    SKEW_LEAF_ROWS rows at random in leaf 5 ("skewed"); f32 grad/hess."""
    import torch

    dev = learner.bins_t.device
    n = learner.n_pad
    L = learner.params.num_leaves + 1
    leaf = torch.randint(0, L - 1, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    if operands == "skewed":
        leaf[torch.randperm(n, generator=gen, device=dev)[
            :SKEW_LEAF_ROWS]] = 5
    vals = torch.stack([torch.randn(n, generator=gen, device=dev),
                        torch.rand(n, generator=gen, device=dev) * 0.25])
    return leaf, vals, L


def check_leaf_sums(learner, gen, operands):
    """Phase 4, the leaf refit's kernels at the int8 path's shapes
    (_leaf_operands): leaf_group bitwise against its twin on the card
    (the counting sort leaf_group_plain), the sums bitwise against
    index_add_ on the CPU (the order XLA:CPU's scatter adds in).  Rows
    of both kernels; the leaf_sums row's ms is the whole call's device
    time (both kernels), kernel_ms the sums kernel's, group_ms the
    grouping's, beside the floor its largest leaf sets (chain_ms: the
    chain alone)."""
    import torch
    from lightgbm_tpu_torch.ops import leafsum

    leaf, vals, L = _leaf_operands(learner, gen, operands)
    n = leaf.numel()
    grouped, offsets = leafsum.leaf_group_kernel(leaf, vals, L)
    twin_grouped, twin_offsets = leafsum.leaf_group_plain(leaf, vals, L)
    if not (torch.equal(offsets, twin_offsets)
            and torch.equal(grouped, twin_grouped)):
        fail(f"leaf_group differs from its twin at {operands} operands")
    got = leafsum.leaf_sums_kernel(leaf, vals, L).cpu()
    ids_c, vals_c = leaf.cpu(), vals.cpu()
    ref = leafsum.leaf_sums_plain(ids_c, vals_c, L)
    if not torch.equal(got, ref):
        fail(f"leaf_sums differs from index_add_ on the CPU at {operands} "
             f"operands: max err {(got - ref).abs().max().item()}")

    def call():
        return leafsum.leaf_sums_kernel(leaf, vals, L)

    def only(name):
        return lambda names: [k if k == name else None
                              for k in port_kernels(names)]

    # a call is these two launches and no other (the card tests hold it
    # to that), so its device time is theirs
    kernel_ms = device_ms(call, 20, kernels_of=only("leaf_sums"))
    group_ms = device_ms(call, 20, kernels_of=only("leaf_group"))
    ms = group_ms + kernel_ms
    event_ms = cuda_ms(call, 20)
    t0 = time.perf_counter()
    for _ in range(5):
        leafsum.leaf_sums_plain(ids_c, vals_c, L)
    plain_ms = (time.perf_counter() - t0) / 5 * 1e3
    group_plain_ms = cuda_ms(lambda: leafsum.leaf_group_plain(leaf, vals, L),
                             3)
    ids = leaf.long()
    out = torch.zeros(L, device=leaf.device)
    lib_ms = cuda_ms(lambda: (out.index_add_(0, ids, vals[0]),
                              out.index_add_(0, ids, vals[1])), 5)
    sort_ms = cuda_ms(lambda: torch.sort(leaf, stable=True), 5)
    # the row-order contract's floor: the largest leaf's dependent adds
    longest = int(torch.bincount(ids, minlength=L).max().item())
    floor, chain = leaf_sums_floor(n, L, longest, sm_clock_mhz())
    common = {"route": "cuda", "operands": operands,
              "source": "lightgbm_tpu_torch/csrc/leafsum.cu",
              "replaces": "lightgbm_tpu/ops/grower.py:1745",
              "max_abs_err": 0.0, "max_rel_err": 0.0,
              "largest_leaf_rows": longest,
              "shape": f"leaf ids [{n}] i32, values [2, {n}] f32, L={L}"}
    # the grouping: ids and values read once, the pairs and offsets
    # written once; a compare and an add a row
    group = {"name": "leaf_group", **common,
             "tolerance": "bitwise to leaf_group_plain on the card",
             "ms": group_ms, "plain_ms": group_plain_ms, "plain_on": "cuda",
             **_bound(n * 4 + 2 * n * 4 + 2 * n * 4 + (L + 1) * 4, 2 * n,
                      PEAK_ALU_S),
             "library_ms": sort_ms,
             "library": "torch.sort(stable=True) of the ids (the order "
                        "alone)"}
    # the sums: ids and values read once, sums written once; 2n adds
    sums = {"name": "leaf_sums", **common,
            "tolerance": "bitwise to index_add_ on the CPU",
            "ms": ms, "kernel_ms": kernel_ms, "group_ms": group_ms,
            "event_ms": event_ms, "chain_ms": chain, "floor_ms": floor,
            "plain_ms": plain_ms, "plain_on": "cpu",
            **_bound(n * 4 + 2 * n * 4 + 2 * L * 4, 2 * n, PEAK_F32_S),
            "library_ms": lib_ms,
            "library": "2 x index_add_ on the card (f32 atomics, not "
                       "deterministic)"}
    return [group, sums]


def check_leaf_sums_f64(learner, gen, operands):
    """Phase 4, Booster.refit's sums at the int8 path's shapes
    (_leaf_operands): leaf_group, then the sums kernel's f64 instance,
    the whole call bitwise against index_add_ in f64 on the CPU (the
    order of np.bincount).  ms: the whole call's device time (kernel_ms
    the sums kernel's, group_ms the grouping's), beside the floor its
    largest leaf sets at DADD_CYCLES an add, and the cycles an add the
    sums kernel took on that leaf (kernel_ms over its rows)."""
    import torch
    from lightgbm_tpu_torch.ops import leafsum

    f64 = torch.float64
    leaf, vals, L = _leaf_operands(learner, gen, operands)
    n = leaf.numel()
    got = leafsum.leaf_sums_kernel(leaf, vals, L, f64).cpu()
    ids_c, vals_c = leaf.cpu(), vals.cpu()
    ref = leafsum.leaf_sums_plain(ids_c, vals_c, L, f64)
    if not torch.equal(got, ref):
        fail(f"leaf_sums_f64 differs from index_add_ in f64 on the CPU at "
             f"{operands} operands: max err "
             f"{(got - ref).abs().max().item()}")

    def call():
        return leafsum.leaf_sums_kernel(leaf, vals, L, f64)

    def only(name):
        return lambda names: [k if k == name else None
                              for k in port_kernels(names)]

    kernel_ms = device_ms(call, 20, kernels_of=only("leaf_sums_f64"))
    group_ms = device_ms(call, 20, kernels_of=only("leaf_group"))
    event_ms = cuda_ms(call, 20)
    t0 = time.perf_counter()
    for _ in range(5):
        leafsum.leaf_sums_plain(ids_c, vals_c, L, f64)
    plain_ms = (time.perf_counter() - t0) / 5 * 1e3
    ids = leaf.long()
    out = torch.zeros(L, dtype=f64, device=leaf.device)
    vd = vals.to(f64)
    lib_ms = cuda_ms(lambda: (out.index_add_(0, ids, vd[0]),
                              out.index_add_(0, ids, vd[1])), 5)
    longest = int(torch.bincount(ids, minlength=L).max().item())
    mhz = sm_clock_mhz()
    floor, chain = leaf_sums_floor(n, L, longest, mhz, DADD_CYCLES, 8)
    return {"name": "leaf_sums_f64", "route": "cuda", "operands": operands,
            "source": "lightgbm_tpu_torch/csrc/leafsum.cu",
            "replaces": "lightgbm_tpu/models/gbdt.py:2039",
            "max_abs_err": 0.0, "max_rel_err": 0.0,
            "tolerance": "bitwise to index_add_ in f64 on the CPU",
            "largest_leaf_rows": longest,
            "shape": f"leaf ids [{n}] i32, values [2, {n}] f32, L={L}, "
                     "sums f64",
            "ms": group_ms + kernel_ms, "kernel_ms": kernel_ms,
            "group_ms": group_ms, "event_ms": event_ms, "chain_ms": chain,
            "floor_ms": floor,
            "cycles_per_add": kernel_ms * mhz * 1e3 / max(longest, 1),
            "plain_ms": plain_ms, "plain_on": "cpu",
            **_bound(n * 4 + 2 * n * 4 + 2 * L * 8, 2 * n, PEAK_F64_S),
            "library_ms": lib_ms,
            "library": "2 x index_add_ in f64 on the card (atomics, not "
                       "deterministic)"}


def _fused_operands(learner, gen, bagged=False, goss=None, root=False,
                    mono=False):
    """Kernel B2's operands at the int8 path's shapes: K parent leaves
    k and K + k, each split in two, the smaller child histogrammed;
    bagged: about BAG_OUT of the rows with zero stats and of the
    features masked; goss: the grad, hess and row mask of a tree of a
    path (a sampled GOSS tree, a multiclass class, host lambdas); root:
    every row in leaf 0, histogrammed in slot 0 (the other slots find
    no rows); mono: monotone constraints on half of the features (+1 on
    every fourth from 0, -1 on every fourth from 2) and finite output
    bounds on two thirds of the children, a tenth of the child's own
    output either side of it (they bind on most splits) or from its
    output up (one-sided); the last third keeps +-1e30.  Returns
    (positional args, split_kw)."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    dev = learner.bins_t.device
    bins_t = learner.bins_t
    F, n = bins_t.shape
    B = learner.num_bins
    K = learner.params.split_batch
    p = learner.params
    rows, fmask = (_bag_masks(learner, gen) if bagged
                   else (None, learner.feature_mask))
    if goss is not None:
        rows = goss[2]
    stats = _int8_stats(learner, gen, rows, None if goss is None
                        else goss[:2])
    leaf = torch.randint(0, 2 * K, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    if root:
        leaf.zero_()
    pairs = torch.arange(2 * K, device=dev, dtype=torch.int32)

    def hist_of(ids):
        return H._unpack_hist(H.hist_batched_plain(
            bins_t, stats, leaf, ids.contiguous(), B).permute(3, 2, 0, 1),
            "int8")

    left, right = hist_of(pairs[:K]), hist_of(pairs[K:])
    parent = (left + right).contiguous()
    small_left = torch.rand(K, generator=gen, device=dev) < 0.5
    if root:
        small_left[0] = True
    slots = torch.where(small_left, pairs[:K], pairs[K:]).to(torch.int32)
    slots[K // 3] = -1                                   # a dead slot
    scales = torch.tensor([0.01, 0.004, 1.0], device=dev)
    tot = torch.cat([left, right])[:, 0].sum(1).float() * scales  # [2K, 3]
    ctx = torch.zeros((2 * K + 1, 8), device=dev)
    ctx[:2 * K, :3] = tot
    ctx[:2 * K, 3] = -1e30
    ctx[:2 * K, 4] = 1e30
    ctx[:2 * K, 5] = torch.cat([small_left, ~small_left]).float()
    ctx[2 * K, :3] = scales
    meta = learner.meta
    monotone = meta["monotone"]
    if mono:
        fi = torch.arange(F, device=dev)
        monotone = torch.where(fi % 4 == 0, 1,
                               torch.where(fi % 4 == 2, -1, 0))
        out = -tot[:, 0] / tot[:, 1].clamp(min=1e-3)
        j = torch.arange(2 * K, device=dev)
        band = (0.1 * out.abs()).clamp(min=1e-6)
        ctx[:2 * K, 3] = torch.where(j % 3 == 2, -1e30, torch.where(
            j % 3 == 0, out - band, out))
        ctx[:2 * K, 4] = torch.where(j % 3 == 0, out + band, 1e30)
    zi = torch.zeros(F, dtype=torch.int32, device=dev)
    meta_i = torch.stack([meta["num_bin"], meta["missing_type"],
                          meta["default_bin"], monotone, zi, zi, zi,
                          zi], 1).to(torch.int32).contiguous()
    zf = torch.zeros(F, device=dev)
    meta_f = torch.stack([meta["penalty"], fmask, zf, zf, zf, zf, zf, zf],
                         1).contiguous()
    kw = dict(l1=p.l1, l2=p.l2, max_delta_step=p.max_delta_step,
              min_data_in_leaf=p.min_data_in_leaf,
              min_sum_hessian=p.min_sum_hessian,
              min_gain_to_split=p.min_gain_to_split)
    return (bins_t, stats, leaf, slots, parent, ctx, meta_i, meta_f, B,
            "int8"), kw


def check_fused(learner, gen, operands="random", goss=None):
    """Phase 4, kernel B2 at `_fused_operands`' operands ("random",
    "bagged", "root", or "goss", "multiclass" or "lambdarank" with the
    grower operands `goss` of a tree of that path)."""
    import torch
    from lightgbm_tpu_torch.ops import fused

    bins_t = learner.bins_t
    F, n = bins_t.shape
    B = learner.num_bins
    K = learner.params.split_batch
    args, kw = _fused_operands(learner, gen, operands == "bagged", goss,
                               root=operands == "root",
                               mono=operands == "mono")
    leaf, slots = args[2], args[3]
    got = fused.fused_hist_scan_kernel(*args, split_kw=kw)
    ref = fused.fused_hist_scan_plain(*args, split_kw=kw)
    torch.cuda.synchronize()
    try:
        fused.assert_fused_equal(got, ref)
    except RuntimeError as exc:
        fail(str(exc))
    extra = {}
    if operands == "mono":
        # the constraints must bite: some child's best split differs from
        # the one the same operands give without them
        free = list(args)
        free[5] = args[5].clone()
        free[5][:-1, 3], free[5][:-1, 4] = -1e30, 1e30
        free[6] = args[6].clone()
        free[6][:, 3] = 0
        unbound = fused.fused_hist_scan_plain(*free, split_kw=kw)[1]
        moved = (unbound[..., 0] != ref[1][..., 0]).sum().item()
        if moved == 0:
            fail("fused_hist_scan mono check: the constraints and bounds "
                 "change no record")
        extra = {"records_changed_by_constraints": int(moved),
                 "features_constrained": int((args[6][:, 3] != 0).sum()),
                 "children_bounded": int((args[5][:-1, 3] > -1e30).sum())}
    if not bool((ref[1][..., 0] > 0).any()):
        fail("fused_hist_scan check found no split: its operands are "
             "degenerate")
    ms = device_ms(lambda: fused.fused_hist_scan_kernel(*args, split_kw=kw),
                   20)
    event_ms = cuda_ms(
        lambda: fused.fused_hist_scan_kernel(*args, split_kw=kw), 20)
    plain_ms = cuda_ms(
        lambda: fused.fused_hist_scan_plain(*args, split_kw=kw), 3)
    m = int((slots[:, None] == leaf[None, :]).any(0).sum().item())
    C = 2 * K
    # each input read once, each output written once: every leaf id, the
    # bins and stats of the live rows, slots, parents, ctx, meta;
    # histograms and records (earlier versions: every row's bins and
    # stats)
    rest = 4 * K + 2 * K * F * B * 12 + (C + 1) * 32 + F * 64 + C * F * 32
    # a row's bins in the kernel's row-major copy (16-bit when wide) and
    # its three int8 stats
    row = F * (2 if bins_t.dtype == torch.int32 else 1) + 3
    wide = _wide_plan(learner, 3, False, scan=True)
    walks = wide.get("walks", 1)
    nbytes = 4 * n + m * row + rest
    nbytes_all = 4 * n + n * row + rest
    # histogram adds, then about 100 f32 operations per (child, feature,
    # bin) in the scan (prefix sums, dequantization, both directions'
    # leaf outputs, clips and gains)
    ops = m * F * 3 + C * F * B * 100
    extra.update(wide)
    if walks > 1:
        extra["bound_ms_walked"] = _bound(4 * n + walks * m * row + rest,
                                          ops, PEAK_F32_S)["bound_ms"]
    if goss is not None:
        extra["rows_out"] = float(1.0 - goss[2].sum().item()
                                  / learner._ones_mask.sum().item())
    return {"name": "fused_hist_scan" + ("_wide" if bins_t.dtype
                                         == torch.int32 else ""),
            "operands": operands, **extra,
            "features_masked": int((args[7][:learner.num_features, 1] == 0)
                                   .sum().item()),
            "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/fused.cu",
            "replaces": "lightgbm_tpu/ops/fused.py:221",
            "max_abs_err": 0.0, "max_rel_err": 0.0, "tolerance": "bitwise",
            "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
            **_bound(nbytes, ops, PEAK_F32_S), "library_ms": None,
            "bound_ms_all_rows": _bound(nbytes_all, ops,
                                        PEAK_F32_S)["bound_ms"],
            "shape": f"{_bins_shape(learner, F, n, 0)}, stats [3, {n}] "
                     f"int8, K={K}, B={B}, 2K children, live rows {m}"}


def _norm_param(text, name):
    """Model text with the parameter line `name` normalized."""
    return re.sub(rf"^\[{name}: [^\]]*\]$", f"[{name}: -]", text,
                  flags=re.M)


def cross_check(lgb, X, y, latent):
    """Phase 5: the card against the CPU path at a reduced size."""
    Xs, ys = X[:N_SMALL], y[:N_SMALL]
    rng = np.random.default_rng(43)
    y_reg = Xs[:, 0] + 0.5 * Xs[:, 1] * Xs[:, 2] + 0.3 * rng.normal(
        size=N_SMALL)
    reg = dict(objective="regression", metric="l2",
               tpu_hist_precision="int8", tpu_quant_refit_leaves=False)
    # (params, label, compared by: "auc" or the whole model text)
    runs = {"hilo": (PARAMS, ys, "auc"),
            "int8_binary": (PATHS[1][1], ys, "auc"),
            "packed_hilo": (PACKED_PARAMS, ys, "auc"),
            "int8_regression": (dict(PARAMS, **reg), y_reg, "text"),
            "packed_int8_regression": (
                dict(PACKED_PARAMS, tpu_hist_impl="pallas2", **reg), y_reg,
                "text"),
            "packed_flat_int8_regression": (
                dict(PACKED_PARAMS, tpu_hist_impl="pallas", **reg), y_reg,
                "text"),
            "wide_hilo": (WIDE_PARAMS, ys, "auc"),
            "wide_int8_regression": (dict(WIDE_PARAMS, **reg), y_reg,
                                     "text"),
            "wide_flat_int8_regression": (
                dict(WIDE_PARAMS, tpu_hist_impl="pallas", **reg), y_reg,
                "text")}
    out = {}
    for name, (params, label, by) in runs.items():
        texts = {}
        for dev in ("cuda", "cpu"):
            p = dict(params, device_type=dev)
            t0 = time.perf_counter()
            b = lgb.train(p, lgb.Dataset(Xs, label=label, params=p),
                          num_boost_round=ITERS_SMALL,
                          keep_training_booster=True)
            learner = b._driver.learner
            if learner.packed_bins != name.startswith("packed"):
                fail(f"{name}: packed bins {learner.packed_bins}")
            if (learner.bins_t.element_size() == 4) \
                    != name.startswith("wide"):
                fail(f"{name}: bins {learner.bins_t.dtype}")
            if by == "text":
                texts[dev] = _norm_param(b.model_to_string(), "device_type")
            else:
                out[f"{name}_{dev}_auc"] = auc(b.predict(Xs, raw_score=True),
                                               ys)
            out[f"{name}_{dev}_s"] = time.perf_counter() - t0
        if by == "auc":
            diff = abs(out[f"{name}_cuda_auc"] - out[f"{name}_cpu_auc"])
            out[f"{name}_auc_diff"] = diff
            if diff > AUC_TOL:
                fail(f"{name}: card and CPU AUC differ by {diff} > {AUC_TOL}")
            continue
        out[f"{name}_text_identical"] = texts["cuda"] == texts["cpu"]
        if not out[f"{name}_text_identical"]:
            fail(f"{name}: the card's model text differs from the CPU's")
        if name.startswith("packed"):
            # packing is a layout, not a result
            p = dict(params, tpu_pack_bins=False)
            b = lgb.train(p, lgb.Dataset(Xs, label=label, params=p),
                          num_boost_round=ITERS_SMALL)
            same = (_norm_param(_norm_param(b.model_to_string(),
                                            "device_type"), "tpu_pack_bins")
                    == _norm_param(texts["cuda"], "tpu_pack_bins"))
            out[f"{name}_text_identical_to_unpacked"] = same
            if not same:
                fail(f"{name}: the packed run's model text differs from the "
                     "unpacked run's")
    # a validation set, bagging, feature_fraction and an early stop that
    # fires (learning_rate 0.5 turns the valid l2 within 30 iterations),
    # built in and as fobj: the same text, curve and best iteration
    n_fit = N_SMALL * 4 // 5
    sampled = dict(PARAMS, **reg, bagging_fraction=0.8, bagging_freq=1,
                   feature_fraction=0.8, learning_rate=0.5)
    for name, fobj in (("valid_bag_int8_regression", None),
                       ("valid_bag_int8_fobj", l2_fobj)):
        got = {}
        for dev in ("cuda", "cpu"):
            p = dict(sampled, device_type=dev)
            t0 = time.perf_counter()
            train = lgb.Dataset(Xs[:n_fit], label=y_reg[:n_fit], params=p)
            valid = train.create_valid(Xs[n_fit:], label=y_reg[n_fit:])
            evals = {}
            b = lgb.train(p, train, num_boost_round=30, valid_sets=[valid],
                          fobj=fobj, evals_result=evals,
                          early_stopping_rounds=3, verbose_eval=False,
                          keep_training_booster=True)
            got[dev] = (_norm_param(b.model_to_string(), "device_type"),
                        evals, b.best_iteration, b.current_iteration())
            out[f"{name}_{dev}_s"] = time.perf_counter() - t0
        (text, evals, best, done), cpu = got["cuda"], got["cpu"]
        out[f"{name}_best_iteration"] = best
        out[f"{name}_iterations"] = done
        out[f"{name}_text_identical"] = text == cpu[0]
        out[f"{name}_evals_equal"] = evals == cpu[1]
        if not best < done < 30:
            fail(f"{name}: the early stop did not fire (best {best}, "
                 f"{done} iterations)")
        if text != cpu[0] or evals != cpu[1] or (best, done) != cpu[2:]:
            fail(f"{name}: the card and the CPU differ (text "
                 f"{text == cpu[0]}, evals_result {evals == cpu[1]}, best "
                 f"iteration {best}/{cpu[2]}, iterations {done}/{cpu[3]})")
    # the boosting modes and per-node feature sampling, int8 regression
    # with the refit off: the card writes the CPU's text (GOSS at
    # learning_rate 0.25: 4 full iterations, then 4 sampled; DART drops
    # at every iteration from the third)
    modes = {
        "goss_int8_regression": (dict(PARAMS, **reg, boosting="goss",
                                      learning_rate=0.25), 8),
        "dart_int8_regression": (dict(PARAMS, **reg, boosting="dart",
                                      drop_rate=0.5, skip_drop=0.0), 8),
        "rf_int8_regression": (dict(PARAMS, **reg, boosting="rf",
                                    bagging_fraction=0.8, bagging_freq=1,
                                    feature_fraction=0.8), ITERS_SMALL),
        "bynode_int8_regression": (dict(PARAMS, **reg,
                                        feature_fraction_bynode=0.5),
                                   ITERS_SMALL)}
    for name, (params, iters) in modes.items():
        texts = {}
        for dev in ("cuda", "cpu"):
            p = dict(params, device_type=dev)
            t0 = time.perf_counter()
            b = lgb.train(p, lgb.Dataset(Xs, label=y_reg, params=p),
                          num_boost_round=iters)
            texts[dev] = _norm_param(b.model_to_string(), "device_type")
            out[f"{name}_{dev}_s"] = time.perf_counter() - t0
        out[f"{name}_text_identical"] = texts["cuda"] == texts["cpu"]
        if not out[f"{name}_text_identical"]:
            fail(f"{name}: the card's model text differs from the CPU's")
    # lgb.cv: the result dicts equal
    got = {}
    for dev in ("cuda", "cpu"):
        p = dict(PARAMS, **reg, device_type=dev)
        t0 = time.perf_counter()
        got[dev] = lgb.cv(p, lgb.Dataset(Xs, label=y_reg, params=p),
                          num_boost_round=ITERS_SMALL, nfold=NFOLD)
        out[f"cv_int8_regression_{dev}_s"] = time.perf_counter() - t0
    out["cv_int8_regression_results_equal"] = got["cuda"] == got["cpu"]
    out["cv_int8_regression_l2_mean"] = got["cuda"]["l2-mean"]
    if got["cuda"] != got["cpu"]:
        fail(f"cv_int8_regression: the card's results {got['cuda']} differ "
             f"from the CPU's {got['cpu']}")
    # hilo DART by AUC
    for dev in ("cuda", "cpu"):
        p = dict(PARAMS, boosting="dart", drop_rate=0.5, skip_drop=0.0,
                 device_type=dev)
        t0 = time.perf_counter()
        b = lgb.train(p, lgb.Dataset(Xs, label=ys, params=p),
                      num_boost_round=8)
        out[f"dart_hilo_{dev}_auc"] = auc(b.predict(Xs, raw_score=True), ys)
        out[f"dart_hilo_{dev}_s"] = time.perf_counter() - t0
    diff = abs(out["dart_hilo_cuda_auc"] - out["dart_hilo_cpu_auc"])
    out["dart_hilo_auc_diff"] = diff
    if diff > AUC_TOL:
        fail(f"dart_hilo: card and CPU AUC differ by {diff} > {AUC_TOL}")
    # the leaf refit sums each leaf in row order on the card too: two
    # trainings write the same text
    p = dict(PARAMS, objective="regression", metric="l2",
             tpu_hist_precision="int8")
    refit = [lgb.train(p, lgb.Dataset(Xs, label=y_reg, params=p),
                       num_boost_round=ITERS_SMALL).model_to_string()
             for _ in range(2)]
    out["int8_refit_two_runs_identical"] = refit[0] == refit[1]
    if not out["int8_refit_two_runs_identical"]:
        fail("int8 with the leaf refit: two trainings on the card wrote "
             "different model text")
    out.update(cross_check_zoo(lgb, Xs, y_reg, latent[:N_SMALL]))
    out.update(cross_check_cat(lgb, cat_data(Xs, n_fit=N_SMALL), ys, y_reg))
    return out


def cross_check_utilities(lgb, X):
    """Phase 5 of the model utilities, card against CPU on the first
    N_SMALL rows: an int8 regression continuation (3 iterations, saved,
    then 2 more with a validation set) by its whole model text; its refit
    on the validation rows by the refit text (leaf values bit for bit);
    its contributions of 500 rows bit for bit."""
    Xs = X[:N_SMALL]
    rng = np.random.default_rng(43)
    y_reg = Xs[:, 0] + 0.5 * Xs[:, 1] * Xs[:, 2] + 0.3 * rng.normal(
        size=N_SMALL)
    n_tr = N_SMALL * 4 // 5
    reg = dict(PARAMS, objective="regression", metric="l2",
               tpu_hist_precision="int8", tpu_quant_refit_leaves=False)
    got = {}
    for dev in ("cuda", "cpu"):
        p = dict(reg, device_type=dev)
        t0 = time.perf_counter()
        init = lgb.train(p, lgb.Dataset(Xs[:n_tr], label=y_reg[:n_tr],
                                        params=p), 3)
        ds = lgb.Dataset(Xs[:n_tr], label=y_reg[:n_tr], params=p)
        b = lgb.train(p, ds, 2, init_model=init,
                      valid_sets=[ds.create_valid(Xs[n_tr:],
                                                  label=y_reg[n_tr:])],
                      verbose_eval=False, keep_training_booster=True)
        refit = b.refit(Xs[n_tr:], y_reg[n_tr:][::-1], decay_rate=0.9)
        got[dev] = (_norm_param(b.model_to_string(), "device_type"),
                    refit.model_to_string(),
                    b.predict(Xs[:500], pred_contrib=True),
                    time.perf_counter() - t0)
    out = {"utilities_cuda_s": got["cuda"][3],
           "utilities_cpu_s": got["cpu"][3]}
    for i, what in enumerate(("continuation_text", "refit_text",
                              "contribs")):
        a, b = got["cuda"][i], got["cpu"][i]
        same = np.array_equal(a, b) if i == 2 else a == b
        out[f"utilities_{what}_identical"] = bool(same)
        if not same:
            fail(f"utilities: the card's {what} differs from the CPU's")
    return out


def cross_check_cat(lgb, Xs, ys, y_reg):
    """Phase 5 for categorical features, card against CPU at N_SMALL rows
    (Xs: the rows with columns 22-27 as categories): int8 regression on
    a label with an effect of every category, the refit off, by its whole
    model text, with splits of both modes (one-hot and sorted-CTR) on the
    card and the CPU, at max_bin=255, at max_bin=511
    with column 27 as 300 categories (wide bins) and at max_bin=15 with
    the three columns of 12 categories or fewer categorical (packed bins);
    hilo binary by AUC; the hilo model saved and loaded back on the card,
    its raw scores on rows with NaN and unseen categories; and
    LGBMClassifier's model text against lgb.train's with its params."""
    reg = dict(objective="regression", metric="l2",
               tpu_hist_precision="int8", tpu_quant_refit_leaves=False)
    Xw = cat_data(Xs, [27], [CAT_WIDE_CARD], N_SMALL)

    def cat_label(X):
        """y_reg plus a seeded effect of each category of each column."""
        rng = np.random.default_rng(44)
        codes = X[:, CAT_COLS].astype(np.int64)
        return y_reg + sum(0.5 * rng.normal(size=codes[:, j].max() + 1)[
            codes[:, j]] for j in range(len(CAT_COLS)))

    # (params, rows, label, categorical columns, compared by)
    runs = {"cat_int8_regression": (dict(CAT_PARAMS, **reg), Xs,
                                    cat_label(Xs), CAT_COLS, "text"),
            "cat_wide_int8_regression": (dict(CAT_PARAMS, **reg,
                                              max_bin=511), Xw,
                                         cat_label(Xw), CAT_COLS, "text"),
            "cat_packed_int8_regression": (
                dict(PACKED_PARAMS, tpu_hist_impl="pallas2", **reg), Xs,
                cat_label(Xs), CAT_COLS[:3], "text"),
            "cat_hilo": (CAT_PARAMS, Xs, ys, CAT_COLS, "auc")}
    out = {}
    for name, (params, X, label, cat, by) in runs.items():
        texts = {}
        for dev in ("cuda", "cpu"):
            p = dict(params, device_type=dev)
            t0 = time.perf_counter()
            b = lgb.train(p, lgb.Dataset(X, label=label,
                                         categorical_feature=cat, params=p),
                          num_boost_round=ITERS_SMALL,
                          keep_training_booster=True)
            learner = b._driver.learner
            if learner.packed_bins != ("packed" in name) or (
                    learner.bins_t.element_size() == 4) != ("wide" in name):
                fail(f"{name}: packed bins {learner.packed_bins}, bins "
                     f"{learner.bins_t.dtype}")
            modes = cat_splits(b)
            out[f"{name}_{dev}_cat_splits"] = modes
            # the label with category effects splits in both modes
            if sum(modes) == 0 or (by == "text" and min(modes) == 0):
                fail(f"{name}: categorical splits {modes} (one-hot, "
                     f"sorted-CTR) on the {dev}")
            if by == "text":
                texts[dev] = _norm_param(b.model_to_string(), "device_type")
            else:
                out[f"{name}_{dev}_auc"] = auc(b.predict(X, raw_score=True),
                                               label)
            if dev == "cuda":
                card = b
            out[f"{name}_{dev}_s"] = time.perf_counter() - t0
        if by == "auc":
            diff = abs(out[f"{name}_cuda_auc"] - out[f"{name}_cpu_auc"])
            out[f"{name}_auc_diff"] = diff
            if diff > AUC_TOL:
                fail(f"{name}: card and CPU AUC differ by {diff} > {AUC_TOL}")
            continue
        out[f"{name}_text_identical"] = texts["cuda"] == texts["cpu"]
        if not out[f"{name}_text_identical"]:
            fail(f"{name}: the card's model text differs from the CPU's")
    # the categorical hilo model of the card saved and loaded back on
    # the card: the same raw scores, rows with NaN and unseen categories
    # among them
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_cat_model.txt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    card.save_model(path)
    loaded = lgb.Booster(model_file=path)
    os.remove(path)
    rows = Xs[:3000].copy()
    rows[0::3, CAT_COLS] = np.nan
    rows[1::3, CAT_COLS] = 1e6
    same = np.array_equal(loaded.predict(rows, raw_score=True),
                          card.predict(rows, raw_score=True))
    out["cat_saved_model_loads_and_predicts_equal"] = same
    if loaded._driver.device.type != "cuda" or not same:
        fail("a saved categorical model loaded on the card predicts other "
             "raw scores than the booster that saved it")
    # the sklearn wrapper on the card: lgb.train's text with its params
    t0 = time.perf_counter()
    clf = lgb.LGBMClassifier(n_estimators=ITERS_SMALL,
                             tpu_hist_precision="int8",
                             tpu_quant_refit_leaves=False, verbosity=-1)
    clf.fit(Xs, ys, categorical_feature=CAT_COLS)
    params = dict(clf.booster_.params)
    b = lgb.train(params, lgb.Dataset(Xs, label=ys,
                                      categorical_feature=CAT_COLS,
                                      params=params),
                  num_boost_round=ITERS_SMALL)
    same = b.model_to_string() == clf.booster_.model_to_string()
    out["cat_lgbm_classifier_text_identical_to_train"] = same
    out["cat_lgbm_classifier_s"] = time.perf_counter() - t0
    if not same or clf.booster_._driver.device.type != "cuda":
        fail("LGBMClassifier on the card wrote another model text than "
             "lgb.train with its params")
    return out


def cross_check_efb(lgb, X, y, latent):
    """Phase 5 for the sparse data, card against CPU on the first
    N_EFB_SMALL rows of the same CSR matrix, EFB_SMALL_LEAVES leaves:
    int8 regression on the latent with the refit off, by its whole model
    text; hilo binary by AUC; and predict of the CSR rows against
    predict of their dense copy on the card, which must be equal."""
    Xs, ys, yr = X[:N_EFB_SMALL], y[:N_EFB_SMALL], latent[:N_EFB_SMALL]
    base = dict(EFB_PARAMS, num_leaves=EFB_SMALL_LEAVES)
    reg = dict(base, objective="regression", metric="l2",
               tpu_hist_precision="int8", tpu_quant_refit_leaves=False)
    out = {}
    for name, params, label, by in (("efb_int8_regression", reg, yr, "text"),
                                    ("efb_hilo", base, ys, "auc")):
        got = {}
        for dev in ("cuda", "cpu"):
            p = dict(params, device_type=dev)
            t0 = time.perf_counter()
            b = lgb.train(p, lgb.Dataset(Xs, label=label, params=p),
                          num_boost_round=ITERS_SMALL,
                          keep_training_booster=True)
            plan = b._driver.learner.bundle_plan
            if plan is None:
                fail(f"{name}: no EFB plan on the {dev}")
            out[f"{name}_{dev}_columns"] = plan.num_columns
            got[dev] = (_norm_param(b.model_to_string(), "device_type")
                        if by == "text"
                        else auc(b.predict(Xs, raw_score=True), label))
            out[f"{name}_{dev}_s"] = time.perf_counter() - t0
            if dev == "cuda":
                card = b
        if by == "text":
            out[f"{name}_text_identical"] = got["cuda"] == got["cpu"]
            if not out[f"{name}_text_identical"]:
                fail(f"{name}: the card's model text differs from the CPU's")
        else:
            diff = abs(got["cuda"] - got["cpu"])
            out.update({f"{name}_cuda_auc": got["cuda"],
                        f"{name}_cpu_auc": got["cpu"],
                        f"{name}_auc_diff": diff})
            if diff > AUC_TOL:
                fail(f"{name}: card and CPU AUC differ by {diff} > {AUC_TOL}")
    # predict of sparse rows densifies them in chunks: the same scores
    same = np.array_equal(card.predict(Xs, raw_score=True),
                          card.predict(Xs.toarray(), raw_score=True))
    out["efb_predict_csr_equals_dense"] = same
    if not same:
        fail("predict of CSR rows differs from predict of their dense copy")
    return out


def _trees_close(a, b, rtol, what, float_ties=False):
    """Two boosters' trees: the same structure, thresholds and leaf
    counts, leaf values within rtol of the tree's largest |value|
    (tests/test_torch_util.py:assert_trees_match).  The default-left
    flag is compared only where a node's missing type reads it.
    float_ties: a node's threshold bin may differ where both split gains
    are equal within rtol; with the structure and every leaf count
    equal, both thresholds then cut the node's training rows the same
    way (the bins between them hold none of its rows), a tie that the
    float sums' last bits break.  Returns {"leaf_rel_diff": the largest
    relative leaf difference, "tied_thresholds": such nodes}; fails on
    any other difference, and on boosters without trees, naming `what`
    and the first differing node."""
    worst = 0.0
    ties = 0
    for booster in (a, b):
        booster.num_trees()              # the lazy trees materialized
    ta, tb = a._driver.models, b._driver.models
    if len(ta) != len(tb) or not ta:
        fail(f"{what}: {len(ta)} trees against {len(tb)}")
    for i, (x, z) in enumerate(zip(ta, tb)):
        ni, nl = x.num_leaves - 1, x.num_leaves
        if z.num_leaves != x.num_leaves:
            fail(f"{what}: tree {i}: {z.num_leaves} leaves against "
                 f"{x.num_leaves}")
        dts = []
        for t in (x, z):
            dt = t.decision_type[:ni].copy()
            dt[((dt >> 2) & 3) == 0] &= ~np.int8(2)
            dts.append(dt)
        for name in ("split_feature", "threshold_in_bin", "left_child",
                     "right_child"):
            u, v = getattr(x, name)[:ni], getattr(z, name)[:ni]
            differ = u != v
            if float_ties and name == "threshold_in_bin":
                gx = x.split_gain[:ni].astype(np.float64)
                gz = z.split_gain[:ni].astype(np.float64)
                tied = differ & (np.abs(gx - gz)
                                 <= rtol * np.maximum(np.abs(gx), 1e-300))
                ties += int(tied.sum())
                differ &= ~tied
            if differ.any():
                j = int(np.flatnonzero(differ)[0])
                fail(f"{what}: tree {i}: {name} differs first at node {j} "
                     f"({u[j]} against {v[j]}; feature "
                     f"{x.split_feature[j]} against {z.split_feature[j]}, "
                     f"gain {x.split_gain[j]} against {z.split_gain[j]})")
        if not np.array_equal(dts[0], dts[1]) or not np.array_equal(
                x.leaf_count[:nl], z.leaf_count[:nl]):
            fail(f"{what}: tree {i}: decision types or leaf counts differ")
        ref = np.asarray(x.leaf_value[:nl], np.float64)
        err = float(np.abs(np.asarray(z.leaf_value[:nl]) - ref).max()
                    / max(np.abs(ref).max(), 1e-300))
        worst = max(worst, err)
        if err > rtol:
            fail(f"{what}: tree {i}: leaf values differ by {err} of the "
                 f"largest > {rtol}")
    return {"leaf_rel_diff": worst, "tied_thresholds": ties}


def cross_check_constraints(lgb, X, w, forced_path):
    """Phase 5 of mono_int8, cegb_int8, forced_hilo and det_f64, card
    against CPU on the first N_CONSTRAINT_SMALL rows with
    CONSTRAINT_SMALL_LEAVES leaves, regression on cross_check's label
    form: int8 with the refit off under the path's monotone constraints,
    and under CEGB (penalties for this size), by their whole model text;
    hilo with the forced splits by their trees within FLOAT_RTOL (a
    threshold may differ at a gain tie, `_trees_close`);
    deterministic=true by its trees within F64_RTOL; and on the card,
    int8 with deterministic=true against the same without it, by the
    model text (the deterministic line normalized)."""
    Xs = X[:N_CONSTRAINT_SMALL]
    rng = np.random.default_rng(43)
    y_reg = Xs[:, 0] + 0.5 * Xs[:, 1] * Xs[:, 2] + Xs[:, 8:] @ w[8:] \
        * 0.3 + 0.3 * rng.normal(size=N_CONSTRAINT_SMALL)
    base = dict(PARAMS, objective="regression", metric="l2",
                num_leaves=CONSTRAINT_SMALL_LEAVES)
    int8 = dict(base, tpu_hist_precision="int8", tpu_quant_refit_leaves=False)
    runs = {
        "mono_int8": (dict(int8, monotone_constraints=mono_constraints(w)),
                      "text"),
        "cegb_int8": (dict(int8, cegb_penalty_feature_coupled=[20.0] * 14,
                           cegb_penalty_feature_lazy=[0.0] * 14
                           + [0.01] * 4, cegb_penalty_split=0.001), "text"),
        "forced_hilo": (dict(base, forcedsplits_filename=forced_path),
                        FLOAT_RTOL),
        "det_f64": (dict(base, deterministic=True, tpu_hist_impl="xla"),
                    F64_RTOL)}
    out = {}
    for name, (params, by) in runs.items():
        got = {}
        for dev in ("cuda", "cpu"):
            p = dict(params, device_type=dev)
            t0 = time.perf_counter()
            b = lgb.train(p, lgb.Dataset(Xs, label=y_reg, params=p),
                          num_boost_round=ITERS_CONSTRAINT_SMALL,
                          keep_training_booster=True)
            got[dev] = (_norm_param(b.model_to_string(), "device_type")
                        if by == "text" else b)
            out[f"{name}_{dev}_s"] = time.perf_counter() - t0
        if by == "text":
            out[f"{name}_text_identical"] = got["cuda"] == got["cpu"]
            if not out[f"{name}_text_identical"]:
                fail(f"{name}: the card's model text differs from the CPU's")
        else:
            close = _trees_close(got["cpu"], got["cuda"], by, name,
                                 float_ties=by == FLOAT_RTOL)
            out.update({f"{name}_{k}": v for k, v in close.items()})
    # deterministic=true leaves int8 as it is
    texts = []
    for det in (True, False):
        p = dict(int8, deterministic=det)
        b = lgb.train(p, lgb.Dataset(Xs, label=y_reg, params=p),
                      num_boost_round=ITERS_CONSTRAINT_SMALL)
        texts.append(_norm_param(b.model_to_string(), "deterministic"))
    out["int8_deterministic_text_identical"] = texts[0] == texts[1]
    if texts[0] != texts[1]:
        fail("int8 with deterministic=true wrote another text than without")
    return out


def cross_check_storage(lgb, X, w, Xe, latent_e, tmp):
    """Phase 5 of the file and sparse paths, card against CPU: the first
    N_EFB_SMALL dense rows as CSV, loaded with two_round (bins from a
    sample of TWO_ROUND_SMALL_SAMPLE rows), int8 regression with the
    refit off, by the whole model text; and the first N_EFB_SMALL rows
    of the sparse table with SPARSE_PARAMS, SPARSE_SMALL_MAX_BIN and
    deterministic=true, f64 regression trees within F64_RTOL.  On the
    card that sparse run is made twice, and both texts must equal each
    other and the card's all-dense f64 text (deterministic=true gives
    the same model on every run, and sparse storage the dense one's)."""
    Xs = X[:N_EFB_SMALL]
    rng = np.random.default_rng(44)
    y_reg = Xs[:, 0] + 0.5 * Xs[:, 1] * Xs[:, 2] + Xs[:, 8:] @ w[8:] \
        * 0.3 + 0.3 * rng.normal(size=N_EFB_SMALL)
    path = os.path.join(tmp, "small.csv")
    write_csv(path, Xs, y_reg)
    two = dict(PARAMS, objective="regression", metric="l2",
               num_leaves=EFB_SMALL_LEAVES, tpu_hist_precision="int8",
               tpu_quant_refit_leaves=False, two_round=True,
               bin_construct_sample_cnt=TWO_ROUND_SMALL_SAMPLE)
    det = dict(SPARSE_PARAMS, objective="regression", metric="l2",
               num_leaves=EFB_SMALL_LEAVES, deterministic=True,
               tpu_hist_impl="xla", max_bin=SPARSE_SMALL_MAX_BIN)
    out = {}
    texts, boosters = {}, {}
    for dev in ("cuda", "cpu"):
        p = dict(two, device_type=dev)
        t0 = time.perf_counter()
        ds = lgb.Dataset(path, params=p).construct()
        if ds._inner.ingest_s.get("two_round") != 1.0:
            fail(f"two_round_int8: the {dev} load did not take the "
                 "two-round loader")
        b = lgb.train(p, ds, ITERS_SMALL)
        texts[dev] = _norm_param(b.model_to_string(), "device_type")
        out[f"two_round_int8_{dev}_s"] = time.perf_counter() - t0
        p = dict(det, device_type=dev)
        t0 = time.perf_counter()
        b = lgb.train(p, lgb.Dataset(Xe[:N_EFB_SMALL],
                                     label=latent_e[:N_EFB_SMALL],
                                     params=p), ITERS_SPARSE_SMALL,
                      keep_training_booster=True)
        if b._driver.learner.sparse is None:
            fail(f"sparse_f64: no sparse storage on the {dev}")
        out[f"sparse_f64_{dev}_coo_features"] = len(
            b._driver.learner.sparse["sparse_idx"])
        out[f"sparse_f64_{dev}_s"] = time.perf_counter() - t0
        boosters[dev] = b
    # the texts but for the threshold's parameter line
    card = {"sparse": boosters["cuda"].model_to_string()}
    for tag, sth in (("again", det["tpu_sparse_threshold"]), ("dense", 0.0)):
        p = dict(det, device_type="cuda", tpu_sparse_threshold=sth)
        card[tag] = lgb.train(p, lgb.Dataset(
            Xe[:N_EFB_SMALL], label=latent_e[:N_EFB_SMALL], params=p),
            ITERS_SPARSE_SMALL).model_to_string()
    card = {k: _norm_param(v, "tpu_sparse_threshold")
            for k, v in card.items()}
    for tag in ("again", "dense"):
        same = card[tag] == card["sparse"]
        out[f"sparse_f64_card_text_equals_{tag}"] = same
        if not same:
            fail(f"sparse_f64: the card's text differs from its {tag} run's")
    out["two_round_int8_text_identical"] = texts["cuda"] == texts["cpu"]
    if texts["cuda"] != texts["cpu"]:
        fail("two_round_int8: the card's model text differs from the CPU's")
    close = _trees_close(boosters["cpu"], boosters["cuda"], F64_RTOL,
                         "sparse_f64")
    out.update({f"sparse_f64_{k}": v for k, v in close.items()})
    return out


def cross_check_zoo(lgb, Xs, y_reg, lat):
    """Phase 5 for the objective zoo, card against CPU at N_SMALL rows:
    int8 regression_l1, huber, quantile, lambdarank (queries of 50) and
    GOSS with regression_l1, the refit off, by their whole model text;
    multiclass hilo and int8 by the held-out multi_logloss of their last
    fifth of the rows; and one saved model file loaded on the card."""
    reg = dict(metric="l2", tpu_hist_precision="int8",
               tpu_quant_refit_leaves=False)
    rel = quintiles(lat)
    group = [50] * (N_SMALL // 50)
    runs = {
        "regression_l1_int8": (dict(PARAMS, **reg,
                                    objective="regression_l1"),
                               y_reg, None, ITERS_SMALL),
        "huber_int8": (dict(PARAMS, **reg, objective="huber"), y_reg, None,
                       ITERS_SMALL),
        "quantile_int8": (dict(PARAMS, **reg, objective="quantile",
                               alpha=0.3), y_reg, None, ITERS_SMALL),
        "lambdarank_int8": (dict(PARAMS, **dict(reg, metric="ndcg"),
                                 objective="lambdarank"), rel, group,
                            ITERS_SMALL),
        "goss_regression_l1_int8": (dict(PARAMS, **reg,
                                         objective="regression_l1",
                                         boosting="goss",
                                         learning_rate=0.25), y_reg, None,
                                    8)}
    out = {}
    for name, (params, label, grp, iters) in runs.items():
        texts = {}
        for dev in ("cuda", "cpu"):
            p = dict(params, device_type=dev)
            t0 = time.perf_counter()
            b = lgb.train(p, lgb.Dataset(Xs, label=label, group=grp,
                                         params=p), num_boost_round=iters)
            texts[dev] = _norm_param(b.model_to_string(), "device_type")
            out[f"{name}_{dev}_s"] = time.perf_counter() - t0
        out[f"{name}_text_identical"] = texts["cuda"] == texts["cpu"]
        if not out[f"{name}_text_identical"]:
            fail(f"{name}: the card's model text differs from the CPU's")
    # multiclass by the held-out multi_logloss of the last fifth
    n_fit = N_SMALL * 4 // 5
    cls = quintiles(lat)
    for prec in ("hilo", "int8"):
        for dev in ("cuda", "cpu"):
            p = dict(MULTICLASS_PARAMS, tpu_hist_precision=prec,
                     device_type=dev)
            t0 = time.perf_counter()
            b = lgb.train(p, lgb.Dataset(Xs[:n_fit], label=cls[:n_fit],
                                         params=p),
                          num_boost_round=ITERS_SMALL)
            raw = b.predict(Xs[n_fit:], raw_score=True)
            out[f"multiclass_{prec}_{dev}_multi_logloss"] = metric_value(
                "multi_logloss", raw.T, cls[n_fit:], b._driver.objective,
                objective="multiclass", num_class=5)
            out[f"multiclass_{prec}_{dev}_s"] = time.perf_counter() - t0
        diff = abs(out[f"multiclass_{prec}_cuda_multi_logloss"]
                   - out[f"multiclass_{prec}_cpu_multi_logloss"])
        out[f"multiclass_{prec}_multi_logloss_diff"] = diff
        if diff > AUC_TOL:
            fail(f"multiclass_{prec}: card and CPU held-out multi_logloss "
                 f"differ by {diff} > {AUC_TOL}")
    # a model file saved and loaded back on the card predicts as the
    # booster that saved it (the last multiclass one, trained on the CPU)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_model.txt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    b.save_model(path)
    loaded = lgb.Booster(model_file=path)
    os.remove(path)
    if loaded._driver.device.type != "cuda":
        fail("a loaded model does not predict on the card")
    same = np.array_equal(loaded.predict(Xs, raw_score=True),
                          b.predict(Xs, raw_score=True))
    out["saved_model_loads_and_predicts_equal"] = same
    if not same:
        fail("a saved model loaded on the card predicts other raw scores "
             "than the booster that saved it")
    return out


# ---- fault tolerance and device memory ------------------------------------
# resume_int8: valid_bag_int8's parameters, a checkpoint every 2 rounds,
# 3 kept, early stopping armed, ITERS iterations; the cut run raises at
# its 7th iteration (1-based), so 6 are complete
CKPT_INTERVAL = 2
CKPT_KEEP = 3
CUT_AT = 7
# guard_int8: the same parameters under tpu_guard_numerics, the 4th
# iteration (1-based) poisoned
POISON_AT = 4
# oom_int8: int8 with the grow megakernel pinned, chunks one halving above
# the ladder's floor (4096), 2 injected OOMs at the 3rd iteration (1-based)
OOM_PARAMS = dict(PARAMS, tpu_hist_precision="int8", tpu_hist_impl="fused",
                  tpu_ingest_chunk_rows=8192, tpu_predict_chunk_rows=8192)
ITERS_OOM = 6
OOM_AT = 3
# the genuine OOM: after the first iteration the caching allocator is
# capped this far above what it holds, and its free blocks are filled
# with 2 MiB tensors, the last OOM_MARGIN of them given back for the
# final checkpoint's small copies: the next iteration cannot fit
OOM_MARGIN = 8 << 20
FILL_BLOCK = 2 << 20
# timings of the snapshot and the guard's check: calls of each
FT_REPS = 20


def model_text(booster):
    """A model text without its parameters block (it names the run's
    checkpoint directory and device); the trees and trailers stay."""
    text = booster.model_to_string(num_iteration=-1)
    head, rest = text.split("\nparameters:", 1)
    return head + rest.split("end of parameters", 1)[1]


class _Grab:
    """A callback keeping the booster of an lgb.train that raises."""

    order = 0
    before_iteration = True

    def __init__(self):
        self.booster = None

    def __call__(self, env):
        self.booster = env.model


def _sync_s(fn):
    """fn()'s wall seconds, the card synchronized on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _save_parts(booster, path):
    """Seconds of each part of one checkpoint save of `booster` into
    `path`: the captured state (the lazy trees materialized, the scores
    copied to the host), the model text, the npz of the arrays and the
    CRC32s, each alone; then the whole save, with the time spent in
    os.fsync (four files and two directories) summed apart."""
    import io
    import zlib

    drv = booster._driver
    out = {}
    out["capture_s"], (state, arrays) = _sync_s(drv.capture_train_state)
    out["model_text_s"], text = _sync_s(
        lambda: booster.model_to_string(num_iteration=-1))
    buf = io.BytesIO()
    out["npz_s"], _ = _sync_s(lambda: np.savez(buf, **arrays))
    payloads = [text.encode("utf-8"),
                json.dumps(state, sort_keys=True).encode(), buf.getvalue()]
    out["crc_s"], _ = _sync_s(lambda: [zlib.crc32(p) for p in payloads])
    fsync, spent = os.fsync, []

    def timed_fsync(fd):
        t0 = time.perf_counter()
        fsync(fd)
        spent.append(time.perf_counter() - t0)

    os.fsync = timed_fsync
    try:
        out["save_s"], _ = _sync_s(lambda: booster.save_checkpoint(path))
    finally:
        os.fsync = fsync
    out["fsync_s"] = sum(spent)
    out["fsyncs"] = len(spent)
    return out


def _bundle_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def resume_path(lgb, kernels, ds, X, y, tmp):
    """resume_int8: lgb.train of VALID_PARAMS with the held-out rows as a
    validation set and early stopping, without and with checkpoints
    (tpu_checkpoint_dir, interval CKPT_INTERVAL, keep CKPT_KEEP): the
    texts must be byte-identical, and the checkpointing run must launch
    B1-int, B2, B3 and the leaf sums.  A run whose grow_step raises at
    iteration CUT_AT leaves its last interval bundle (ckpt-6, flushed),
    CKPT_KEEP of them, and a booster that predicts; resume=True then
    gives the uninterrupted text.  Returns the report."""
    import torch
    from lightgbm_tpu_torch.utils import faultline
    from lightgbm_tpu_torch.utils.checkpoint import CheckpointManager

    Xho, yho = X[N_TRAIN:], y[N_TRAIN:]
    valid = ds.create_valid(Xho, label=yho)
    d = os.path.join(tmp, "resume_ckpt")

    def run(params, **kw):
        return lgb.train(dict(params), ds, num_boost_round=ITERS,
                         valid_sets=[valid], valid_names=["valid"],
                         early_stopping_rounds=EARLY_STOP,
                         verbose_eval=False, keep_training_booster=True,
                         **kw)

    plain_s, plain = _sync_s(lambda: run(VALID_PARAMS))
    want = model_text(plain)
    ckpt = dict(VALID_PARAMS, tpu_checkpoint_dir=d,
                tpu_checkpoint_interval=CKPT_INTERVAL,
                tpu_checkpoint_keep=CKPT_KEEP)
    torch.cuda.synchronize()
    kernels.reset_launches()
    ckpt_s, booster = _sync_s(lambda: run(ckpt))
    launches = dict(kernels.launches)
    for name in INT_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on path resume_int8")
    if model_text(booster) != want:
        fail("resume_int8: checkpointing changed the model text")
    mgr = CheckpointManager(d)
    newest = mgr.checkpoints()[0][1]
    bundle = _bundle_bytes(newest)
    save = _save_parts(booster, os.path.join(tmp, "resume_save"))
    snapshot_ms = cuda_ms(booster._driver._iter_snapshot, FT_REPS)
    shutil.rmtree(d)
    grab = _Grab()
    faultline.reset()
    faultline.arm("grow_step", action="raise", at=CUT_AT)
    try:
        run(ckpt, callbacks=[grab])
        fail("resume_int8: the armed grow_step did not raise")
    except faultline.FaultInjected:
        pass
    finally:
        faultline.reset()
    kept = [it for it, _ in mgr.checkpoints()]
    if kept != [CUT_AT - 1 - CKPT_INTERVAL * i for i in range(CKPT_KEEP)]:
        fail(f"resume_int8: bundles {kept} after the cut at iteration "
             f"{CUT_AT}")
    cut = grab.booster
    if cut.current_iteration() != CUT_AT - 1:
        fail(f"resume_int8: the cut booster is at iteration "
             f"{cut.current_iteration()}")
    pred = cut.predict(Xho)
    if not np.all(np.isfinite(pred)):
        fail("resume_int8: the cut booster's predictions are not finite")
    fresh = lgb.Booster(params=dict(ckpt), train_set=ds)
    restore_s, it = _sync_s(lambda: fresh.resume_from_checkpoint(d))
    if it != CUT_AT - 1:
        fail(f"resume_int8: resume_from_checkpoint gave iteration {it}")
    resumed_s, resumed = _sync_s(lambda: run(ckpt, resume=True))
    if model_text(resumed) != want:
        fail("resume_int8: the resumed text is not the uninterrupted one")
    return {"iters_per_s_without_ckpt": plain.num_trees() / plain_s,
            "iters_per_s_with_ckpt": booster.num_trees() / ckpt_s,
            "trees": booster.num_trees(),
            "best_iteration": booster.best_iteration,
            "bundle_bytes": bundle, "save_s": save["save_s"],
            "save_parts": save,
            "snapshot_ms_per_iter": snapshot_ms,
            "restore_s": restore_s, "resumed_rounds_s": resumed_s,
            "kept_bundles": kept, "cut_holdout_auc": auc(pred, yho),
            "texts_identical": True, "launches": launches,
            "launches_per_tree": {k: v / booster.num_trees()
                                  for k, v in launches.items()}}


def guard_path(lgb, kernels, ds, X, y):
    """guard_int8: VALID_PARAMS under tpu_guard_numerics=skip with the
    POISON_AT-th iteration's scores NaN-poisoned: one skip, finite
    scores, ITERS trees; under raise the poisoned iteration is rolled
    back (POISON_AT - 1 iterations) and the booster predicts.  The
    guard's ms an iteration: the skip booster's next iterations with the
    guard off and on in turns, and its one reduction alone.  Returns the
    report."""
    import torch
    from lightgbm_tpu_torch.utils import faultline
    from lightgbm_tpu_torch.utils.log import LightGBMError

    Xho = X[N_TRAIN:]
    valid = ds.create_valid(Xho, label=y[N_TRAIN:])

    def booster(mode):
        b = lgb.Booster(params=dict(VALID_PARAMS, tpu_guard_numerics=mode),
                        train_set=ds)
        b.add_valid(valid, "valid")
        return b

    torch.cuda.synchronize()
    kernels.reset_launches()
    skip = booster("skip")
    faultline.reset()
    faultline.arm("grow_step", action="poison", at=POISON_AT)
    try:
        while skip.current_iteration() < ITERS:
            skip.update()
    finally:
        faultline.reset()
    launches = dict(kernels.launches)
    drv = skip._driver
    trees = skip.num_trees()
    if drv._guard_skips_total != 1 or trees != ITERS \
            or not bool(torch.isfinite(drv.train_scores.scores).all()):
        fail(f"guard_int8: {drv._guard_skips_total} skips, "
             f"{skip.num_trees()} trees")
    for name in INT_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on path guard_int8")
    raising = booster("raise")
    faultline.arm("grow_step", action="poison", at=POISON_AT)
    try:
        for _ in range(ITERS):
            raising.update()
        fail("guard_int8: tpu_guard_numerics=raise did not raise")
    except LightGBMError as exc:
        if "non-finite" not in str(exc):
            fail(f"guard_int8: raise mode said {exc}")
    finally:
        faultline.reset()
    if raising.current_iteration() != POISON_AT - 1 \
            or not np.all(np.isfinite(raising.predict(Xho))):
        fail(f"guard_int8: raise left {raising.current_iteration()} "
             "iterations or non-finite predictions")
    # the guard's cost: ITERS_EVAL_COST more iterations of the skip
    # booster with the guard off and on, twice in turns; beside each
    # iteration's wall time, the host's time in update() and, guarded,
    # the part of it spent in the guard's check (its wait drains the
    # queue the host built up, which the unguarded host runs ahead of)
    spent = {"off": [], "skip": []}
    host = {"off": [], "skip": []}
    waits = []
    check = drv._scores_finite

    def timed_check():
        t0 = time.perf_counter()
        ok = check()
        waits.append(time.perf_counter() - t0)
        return ok

    drv._scores_finite = timed_check

    def iterations(mode):
        in_update = 0.0
        for _ in range(ITERS_EVAL_COST):
            t0 = time.perf_counter()
            skip.update()
            in_update += time.perf_counter() - t0
        skip.num_trees()
        host[mode].append(in_update / ITERS_EVAL_COST)

    try:
        for mode in ("off", "skip", "off", "skip"):
            drv._guard = mode
            spent[mode].append(
                _sync_s(lambda: iterations(mode))[0] / ITERS_EVAL_COST)
    finally:
        drv._scores_finite = check
    mean = {m: sum(v) / len(v) for m, v in spent.items()}
    return {"skips": drv._guard_skips_total, "trees": trees,
            "raise_iterations": raising.current_iteration(),
            "iter_s_unguarded": spent["off"], "iter_s_guarded": spent["skip"],
            "guard_ms_per_iter": 1e3 * (mean["skip"] - mean["off"]),
            "host_update_s_unguarded": host["off"],
            "host_update_s_guarded": host["skip"],
            "guard_wait_ms_per_iter": 1e3 * sum(waits) / len(waits),
            "finite_check_ms": cuda_ms(drv._scores_finite, FT_REPS),
            "launches": launches,
            "launches_per_tree": {k: v / trees
                                  for k, v in launches.items()}}


def oom_path(lgb, kernels, ds, X, y, tmp):
    """oom_int8: OOM_PARAMS (B2 pinned) with two injected OOMs at the
    OOM_AT-th iteration: the ladder takes shrink_chunk_rows, then
    fused_unfuse; the later iterations launch B1-int and no B2; the text
    is the undisturbed run's; the recoveries and steps counters read 2.
    Then a genuine OOM: after one iteration the caching allocator is
    capped OOM_MARGIN above what it holds and its free blocks are filled;
    the run settles at a
    text equal to an undisturbed run at the settled configuration, or
    ends in MemoryLadderExhausted with a final checkpoint and a booster
    that predicts (never a raw torch.OutOfMemoryError).  Last,
    torch.empty past the card's capacity inside the predict_chunk guard
    is a DeviceOutOfMemory naming the site.  Returns the report."""
    import torch
    from lightgbm_tpu_torch.obs import REGISTRY
    from lightgbm_tpu_torch.utils import faultline, membudget
    from lightgbm_tpu_torch.utils.checkpoint import CheckpointManager

    Xho = X[N_TRAIN:]
    want = model_text(lgb.train(dict(OOM_PARAMS), ds, ITERS_OOM,
                                keep_training_booster=True))

    def counters():
        return (REGISTRY.value("lgbm_oom_recoveries_total",
                               site="train_step"),
                sum(REGISTRY.value("lgbm_oom_ladder_steps_total", step=s)
                    for s in membudget.LADDER_STEPS))

    b = lgb.Booster(params=dict(OOM_PARAMS), train_set=ds)
    before = counters()
    faultline.reset()
    try:
        for it in range(ITERS_OOM):
            if it == OOM_AT - 1:
                faultline.arm("device_alloc", action="oom", times=2)
            if it == OOM_AT:
                torch.cuda.synchronize()
                kernels.reset_launches()
            b.update()
    finally:
        faultline.reset()
    b.num_trees()
    torch.cuda.synchronize()
    after_launches = dict(kernels.launches)
    after = counters()
    steps = b._driver._mem_ladder.describe()
    if steps != ["shrink_chunk_rows", "fused_unfuse"]:
        fail(f"oom_int8: the ladder took {steps}")
    if after_launches["hist_batched_int"] <= 0 \
            or after_launches["fused_hist_scan"] != 0:
        fail(f"oom_int8: after fused_unfuse the launches were "
             f"{after_launches}")
    if model_text(b) != want:
        fail("oom_int8: the recovered text is not the undisturbed one")
    moved = (after[0] - before[0], after[1] - before[1])
    if moved != (2, 2):
        fail(f"oom_int8: recoveries and ladder steps moved by {moved}")
    del b
    # the genuine OOM
    d = os.path.join(tmp, "oom_ckpt")
    params = dict(PARAMS, tpu_hist_precision="int8", tpu_checkpoint_dir=d)
    total = torch.cuda.get_device_properties(0).total_memory
    grab = _Grab()

    class Cap:
        order = 50
        before_iteration = False
        filler = []

        def __call__(self, env):
            if env.iteration != 0:
                return
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.set_per_process_memory_fraction(
                min((torch.cuda.memory_reserved() + OOM_MARGIN) / total,
                    1.0))
            try:
                while True:
                    self.filler.append(torch.empty(
                        FILL_BLOCK, dtype=torch.uint8, device="cuda"))
            except torch.OutOfMemoryError:
                pass
            del self.filler[-(OOM_MARGIN // FILL_BLOCK):]
            genuine["filled_bytes"] = len(self.filler) * FILL_BLOCK

    outcome, genuine, cap = None, {}, Cap()
    try:
        b = lgb.train(dict(params), ds, ITERS_OOM, callbacks=[grab, cap],
                      keep_training_booster=True)
        outcome = "settled"
    except membudget.MemoryLadderExhausted as exc:
        outcome = "exhausted"
        genuine["error"] = str(exc)[:300]
        b = grab.booster
    except torch.OutOfMemoryError as exc:
        fail(f"oom_int8: an unclassified torch.OutOfMemoryError ({exc})")
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        cap.filler.clear()
    genuine["steps"] = b._driver._mem_ladder.describe()
    if outcome == "settled" and "stream_layout" in genuine["steps"]:
        # the last rung rebuilt the learner streamed: its first
        # iteration took the fused step, the later ones the sync step
        # (another key stream), so no undisturbed run writes its text
        outcome = "settled_streamed"
        learner = b._driver.learner
        if not learner.stream_layout or learner.bins_t is not None:
            fail("oom_int8: the stream_layout rung left a resident learner")
        genuine["slot_bytes"] = learner._stream.slot_bytes()
        if not np.all(np.isfinite(b.predict(Xho))):
            fail("oom_int8: the streamed booster does not predict")
    genuine["outcome"] = outcome
    print(f"oom_int8 genuine OOM outcome: {outcome} after "
          f"{genuine['steps']}", flush=True)
    if outcome == "settled":
        settled = dict(params)
        for _, overrides in b._driver._mem_ladder.steps_taken:
            settled.update(overrides)
        settled.pop("tpu_checkpoint_dir")
        if model_text(b) != model_text(lgb.train(settled, ds, ITERS_OOM)):
            fail("oom_int8: the settled text is not an undisturbed run's "
                 "at the settled configuration")
    else:
        found = CheckpointManager(d).load_latest()
        if found is None or found[0] != b.current_iteration():
            fail(f"oom_int8: no final checkpoint of iteration "
                 f"{b.current_iteration()} after the exhaustion")
        genuine["final_checkpoint"] = found[0]
        if not np.all(np.isfinite(b.predict(Xho))):
            fail("oom_int8: the exhausted booster does not predict")
    del b, grab
    torch.cuda.empty_cache()
    try:
        with membudget.oom_guard("predict_chunk"):
            torch.empty(2 * total, dtype=torch.uint8, device="cuda")
        fail("oom_int8: an allocation past capacity did not fail")
    except membudget.DeviceOutOfMemory as exc:
        if exc.site != "predict_chunk":
            fail(f"oom_int8: the past-capacity OOM names {exc.site!r}")
    return {"ladder_steps": steps, "counters_moved": list(moved),
            "launches_after_unfuse": after_launches,
            "texts_identical": True, "genuine": genuine}


def preflight_path(lgb, kernels, ds, X):
    """preflight: plan_training on a fresh hilo and int8 learner, after
    one iteration each: every component the live tensors give
    (membudget.live_bytes: the bins, their row-major copy, the pool, the
    stat planes, the row state, the kernel scratch, the score buffers
    and the ingest chunk's tensors) must equal the plan's, and the
    forest's device tables after a predict must equal the closed form
    at their shape; the plan's total against the card's peak over one
    steady iteration (the iteration's rise of
    torch.cuda.max_memory_allocated over what was allocated before it,
    plus the learner's resident bins, row-major copy, scores and row
    mask).  The allocator's peak over one binning chunk and over one
    predict chunk are printed beside the plan's two closed forms.  Then
    tpu_hbm_preflight=raise with a budget of the int8 plan less one byte
    must refuse before iteration 0, launching no kernel.  Returns the
    report."""
    import torch
    from lightgbm_tpu_torch.ops.binning import bin_matrix_t
    from lightgbm_tpu_torch.ops.histogram import reset_call_bytes
    from lightgbm_tpu_torch.utils import membudget
    from lightgbm_tpu_torch.utils.log import LightGBMError

    out = {}
    for name, params in (("hilo", PARAMS),
                         ("int8", dict(PARAMS, tpu_hist_precision="int8"))):
        b = lgb.Booster(params=dict(params), train_set=ds)
        drv = b._driver
        plan = membudget.plan_training(drv.config, drv.learner, 1)
        b.update()
        b.num_trees()
        torch.cuda.synchronize()
        reset_call_bytes()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        b.update()
        b.num_trees()
        torch.cuda.synchronize()
        transient = torch.cuda.max_memory_allocated() - base
        live = membudget.live_bytes(drv)
        missing = set(plan.components) - set(live) - {"packed_forest",
                                                      "predict_scratch"}
        if missing:
            fail(f"preflight {name}: no live reading of {sorted(missing)}")
        bad = {k: (plan.components[k], v) for k, v in live.items()
               if plan.components[k] != v}
        if bad:
            fail(f"preflight {name}: plan against live bytes {bad}")
        resident = (live["binned_matrix"] + live["row_major_bins"]
                    + drv.train_scores.scores.nbytes
                    + drv.learner._ones_mask.nbytes)
        measured = transient + resident
        # one predict chunk: the forest's tables stay, the rest is the
        # chunk's scratch
        chunk = int(drv.config.tpu_predict_chunk_rows)
        rows = min(int(drv.config.tpu_ingest_chunk_rows), N_TRAIN)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        b.predict(X[N_TRAIN:N_TRAIN + chunk])
        torch.cuda.synchronize()
        forest, closed = membudget.forest_live_bytes(drv._tables.device())
        if forest != closed:
            fail(f"preflight {name}: the forest's tables hold {forest} "
                 f"bytes, the closed form {closed}")
        predict_peak = torch.cuda.max_memory_allocated() - base - forest
        out[name] = {"plan": plan.components, "plan_total": plan.total,
                     "iteration_peak_bytes": measured,
                     "transient_bytes": transient,
                     "plan_over_peak": plan.total / measured,
                     "forest_bytes": forest,
                     "forest_trees": drv._tables.device()[
                         "leaf_value"].shape[0],
                     "predict_chunk_rows": chunk,
                     "predict_chunk_peak_bytes": predict_peak,
                     "predict_plan_over_peak": (
                         plan.components["predict_scratch"] / predict_peak)}
        del b, drv
    # one binning chunk of the training rows: the tensors the binning
    # names against the allocator's peak, less the output
    td = ds._inner
    scratch = {"chunk_bytes": 0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    bins = bin_matrix_t(X[:rows], td.mappers, td.used_feature_idx, "cuda",
                        rows, scratch)
    torch.cuda.synchronize()
    ingest_peak = torch.cuda.max_memory_allocated() - base - bins.nbytes
    del bins
    if scratch["chunk_bytes"] != out["int8"]["plan"]["ingest_scratch"]:
        fail(f"preflight: a binning chunk's tensors hold "
             f"{scratch['chunk_bytes']} bytes, the plan "
             f"{out['int8']['plan']['ingest_scratch']}")
    out["ingest_chunk"] = {"rows": rows, "tensor_bytes":
                           scratch["chunk_bytes"],
                           "allocator_peak_bytes": ingest_peak,
                           "plan_over_peak": scratch["chunk_bytes"]
                           / ingest_peak}
    torch.cuda.empty_cache()
    int8 = dict(PARAMS, tpu_hist_precision="int8",
                tpu_hbm_budget_bytes=out["int8"]["plan_total"] - 1,
                tpu_hbm_preflight="raise", tpu_stream_mode="resident")
    torch.cuda.synchronize()
    kernels.reset_launches()
    try:
        lgb.train(int8, ds, 1)
        fail("preflight: a budget of the plan less one byte trained")
    except LightGBMError as exc:
        table = str(exc)
    if sum(kernels.launches.values()) != 0:
        fail(f"preflight: the refused run launched {kernels.launches}")
    if "histogram_pool" not in table or "headroom" not in table:
        fail(f"preflight: the refusal has no itemized table: {table}")
    print("preflight refusal:\n" + table, flush=True)
    out["refused_launches"] = 0
    return out


def cross_check_fault(lgb, X):
    """Phase 5 of the checkpoints, card against CPU on the first N_SMALL
    rows: an int8 regression bundle written on the card at iteration 3
    resumes on the CPU to 6, and one written on the CPU resumes on the
    card; both texts byte-identical to the uninterrupted card run
    (`params_diff` names device_type, and warns)."""
    Xs = X[:N_SMALL]
    rng = np.random.default_rng(44)
    y_reg = Xs[:, 0] - 0.5 * Xs[:, 1] * Xs[:, 2] + 0.3 * rng.normal(
        size=N_SMALL)
    reg = dict(PARAMS, objective="regression", metric="l2",
               tpu_hist_precision="int8", tpu_quant_refit_leaves=False,
               bagging_fraction=0.8, bagging_freq=1)
    tmp = tempfile.mkdtemp()
    try:
        def run(dev, rounds, d=None, resume=False):
            p = dict(reg, device_type=dev)
            if d is not None:
                p["tpu_checkpoint_dir"] = d
            return lgb.train(p, lgb.Dataset(Xs, label=y_reg, params=p),
                             rounds, keep_training_booster=True,
                             resume=resume)

        t0 = time.perf_counter()
        want = model_text(run("cuda", 6))
        out = {}
        for src, dst in (("cuda", "cpu"), ("cpu", "cuda")):
            d = os.path.join(tmp, f"{src}_to_{dst}")
            run(src, 3, d)
            got = model_text(run(dst, 6, d, resume=True))
            same = got == want
            out[f"checkpoint_{src}_to_{dst}_identical"] = same
            if not same:
                fail(f"checkpoint: a {src} bundle resumed on the {dst} "
                     "differs from the uninterrupted card run")
        out["checkpoint_cross_s"] = time.perf_counter() - t0
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def fault_paths(lgb, kernels, ds, X, y, tmp, reports):
    """Phase 3's fault-tolerance and device-memory paths: checkpoints
    and resume, the numeric guard, the OOM ladder and the preflight; the
    blackboxes of their interrupted runs go to tmp."""
    from lightgbm_tpu_torch.obs import flightrecorder

    flightrecorder.configure(dump_dir=tmp)
    for name, run in (
            ("resume_int8", lambda: resume_path(lgb, kernels, ds, X, y,
                                                tmp)),
            ("guard_int8", lambda: guard_path(lgb, kernels, ds, X, y)),
            ("oom_int8", lambda: oom_path(lgb, kernels, ds, X, y, tmp)),
            ("preflight", lambda: preflight_path(lgb, kernels, ds, X))):
        t0 = time.perf_counter()
        reports[name] = run()
        print(f"main path {name} " + json.dumps(reports[name]), flush=True)
        print(f"path_s {name} {time.perf_counter() - t0:.1f}", flush=True)


# the streamed layout (ops/stream.py): blocks of 131,072 rows of the
# Higgs-1M shape (7 of them and a tail of 90,112 rows), and the
# out-of-core scale, 10,000,000 rows streamed under tpu_stream_mode=auto
# in blocks of 1,048,576 rows (9 and a tail of 565,248)
STREAM_ROWS = 131072
STREAM_PARAMS = dict(PARAMS, tpu_hist_precision="int8",
                     tpu_stream_mode="streamed",
                     tpu_stream_block_rows=STREAM_ROWS)
STREAM_GOSS = dict(tpu_stream_goss_top=0.2, tpu_stream_goss_other=0.1)
N_LARGE = 10_000_000
LARGE_STREAM_ROWS = 1_048_576
ITERS_LARGE = 3
# a budget whose half the 280 MB binned matrix passes: auto streams
LARGE_BUDGET = 400 << 20
LARGE_SETUP_LIMIT_S = 60.0
# phase 5: the streamed int8 regression, card against CPU, and resumed
# across devices at its midpoint
STREAM_SMALL_ROWS = 16384
ITERS_STREAM_SMALL = 4


class _StreamStats:
    """A callback keeping each tree's `stream_stats` (none on the resident
    layout), and resetting the allocator's peak after the first
    iteration, so the peak read after training is the steady
    iterations'."""

    order = 40
    before_iteration = False

    def __init__(self):
        self.trees = []

    def __call__(self, env):
        import torch

        learner = env.model._driver.learner
        if learner.stream_layout:
            self.trees.append(learner.stream_stats)
        if env.iteration == 0:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()


def _sync_step(lgb):
    """A context in which every GBDT takes the sync step (the streamed
    layout's), as tests/test_torch_stream.py pins its resident reference:
    the fused step draws its tree keys from another stream."""
    import contextlib

    from lightgbm_tpu_torch.models.gbdt import GBDT as gbdt

    @contextlib.contextmanager
    def ctx():
        saved = gbdt._make_train_step
        gbdt._make_train_step = lambda self: setattr(self, "_step", None)
        try:
            yield
        finally:
            gbdt._make_train_step = saved
    return ctx()


def stream_train(lgb, kernels, ds, params, iters):
    """lgb.train with the launches counted from 0 and the per-tree stream
    stats.  Returns (booster, seconds, launches, memory, tree stats);
    memory: the allocator's peak over the steady iterations (after the
    first) and the bytes the run holds after training, each above what
    was allocated before it (the dataset's bins on the card
    included)."""
    import torch

    stats = _StreamStats()
    torch.cuda.synchronize()
    kernels.reset_launches()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    b = lgb.train(dict(params), ds, iters, keep_training_booster=True,
                  callbacks=[stats])
    b.num_trees()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    memory = {"steady_peak_bytes": torch.cuda.max_memory_allocated() - base,
              "held_bytes": torch.cuda.memory_allocated() - base}
    return b, secs, dict(kernels.launches), memory, stats.trees


def stream_summary(name, booster, launches, trees, hist):
    """The streamed report of a path: H2D GB/s over every copy, the
    overlap share of each tree and in all, the blocks a tree streamed
    and skipped, and the launches of the histogram kernel `hist` a tree,
    which must be the blocks streamed times the passes (rounds + 1) of
    each tree; B2 must not launch."""
    learner = booster._driver.learner
    if not learner.stream_layout or learner.bins_t is not None:
        fail(f"{name}: the learner is not on the streamed layout")
    if len(trees) != booster.num_trees():
        fail(f"{name}: {len(trees)} tree stats for "
             f"{booster.num_trees()} trees")
    want = sum(int(t["blocks_streamed"]) * (int(t["rounds"]) + 1)
               for t in trees)
    if launches[hist] != want:
        fail(f"{name}: {launches[hist]} launches of {hist}, the blocks "
             f"and passes give {want}")
    if launches["fused_hist_scan"] or launches["partition_rows"]:
        fail(f"{name}: B2 or B3 launched on the streamed layout: "
             f"{launches}")
    h2d_b = sum(t["h2d_bytes"] for t in trees)
    h2d_s = sum(t["h2d_wall_s"] for t in trees)
    copy_s = sum(t["copy_est_s"] for t in trees)
    hidden = sum(t["copy_est_s"] * t["overlap_pct"] / 100 for t in trees)
    return {"blocks": len(learner._host_blocks),
            "stream_rows": learner._stream_R,
            "block_bytes": [int(b.nbytes) for b in learner._host_blocks[:1]]
            + [int(learner._host_blocks[-1].nbytes)],
            "slot_bytes": learner._stream.slot_bytes(),
            "h2d_bytes": h2d_b, "h2d_s": h2d_s,
            "h2d_gb_per_s": h2d_b / max(h2d_s, 1e-12) / 1e9,
            "h2d_stall_s": sum(t["h2d_stall_s"] for t in trees),
            "overlap_pct": 100.0 * hidden / max(copy_s, 1e-12),
            "overlap_pct_by_tree": [t["overlap_pct"] for t in trees],
            "rounds_by_tree": [t["rounds"] for t in trees],
            "blocks_streamed_by_tree": [t["blocks_streamed"] for t in trees],
            "blocks_skipped_by_tree": [t["blocks_skipped"] for t in trees],
            "tree_wall_s": [t["tree_wall_s"] for t in trees],
            f"{hist}_per_tree": launches[hist] / max(len(trees), 1),
            "launches": launches}


def check_block_hist(learner, precision):
    """B1 (or B1-int) on one streamed block as the path gives it (its
    pinned host block copied to the card, K = 25 slots over random leaf
    ids, random stats) against its twin: int bitwise, float within 1e-6
    of the sum of |stat|."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    gen = torch.Generator(device="cuda").manual_seed(11)
    blk = learner._host_blocks[0].to("cuda")
    R, G = blk.shape[0], learner.g_pad
    leaf = torch.randint(0, 60, (R,), generator=gen, device="cuda",
                         dtype=torch.int32)
    slots = torch.tensor(list(range(0, 48, 2)) + [-1], dtype=torch.int32,
                         device="cuda")
    ones = torch.ones(R, device="cuda")
    g = torch.randn(R, generator=gen, device="cuda")
    h = torch.rand(R, generator=gen, device="cuda")
    if precision == "int8":
        g = H.quantize_values(g, g.abs().max() / 127, 127, "nearest")
        h = H.quantize_values(h, h.abs().max() / 127, 127, "nearest")
    stats = H.pack_stats(g, h, ones, precision).contiguous()
    got = H.build_histogram_rows(blk, G, stats, leaf, slots,
                                 learner.num_bins, precision)
    ref = H._unpack_hist(H.hist_batched_plain(
        H.columns_of_rows(blk, G), stats, leaf, slots, learner.num_bins)
        .permute(3, 2, 0, 1), precision)
    err = float((got.double() - ref.double()).abs().max())
    tol = 0.0 if precision == "int8" else 1e-6 * float(
        stats.float().abs().sum())
    if err > tol:
        fail(f"B1 on a streamed block ({precision}): max error {err} "
             f"over {tol}")
    return {"rows": R, "max_abs_err": err, "tolerance": tol}


def stream_paths(lgb, kernels, X, y, reports):
    """Phase 3's streamed paths (run after the fault paths): stream_int8,
    stream_hilo, stream_goss_int8 on the Higgs-1M rows, then
    stream_large_int8 at 10,000,000 rows.  Returns the plan check of
    stream_int8 against the build ledger."""
    import torch
    from lightgbm_tpu_torch.utils import membudget
    from lightgbm_tpu_torch.utils.compile_ledger import LEDGER

    Xho, yho = X[N_TRAIN:], y[N_TRAIN:]
    t0 = time.perf_counter()
    ds = lgb.Dataset(X[:N_TRAIN], label=y[:N_TRAIN],
                     params=dict(PARAMS)).construct()
    int8 = dict(PARAMS, tpu_hist_precision="int8")
    # the references, resident (their bins on the card): int8 on the sync
    # path and on the fused step, hilo
    with _sync_step(lgb):
        ref, ref_s, _, ref_peak, _ = stream_train(lgb, kernels, ds, int8,
                                                  ITERS)
    ref_text = model_text(ref)
    del ref
    fused_text = model_text(lgb.train(dict(int8), ds, ITERS))
    # stream_int8
    LEDGER.reset()
    b, secs, launches, peak, trees = stream_train(lgb, kernels, ds,
                                                  STREAM_PARAMS, ITERS)
    rep = stream_summary("stream_int8", b, launches, trees,
                         "hist_batched_int")
    if model_text(b) != ref_text:
        fail("stream_int8: the text is not the resident int8 sync run's")
    drv = b._driver
    plan = membudget.plan_training(drv.config, drv.learner, 1)
    cross = membudget.ledger_cross_check(plan, "hist")
    if cross is None or not cross["covered"]:
        fail(f"stream_int8: the plan's kernel scratch does not cover the "
             f"build ledger's largest: {cross}")
    live = membudget.live_bytes(drv)
    if live["stream_slots"] != plan.components["stream_slots"]:
        fail(f"stream_int8: slots {live['stream_slots']} against the "
             f"plan's {plan.components['stream_slots']}")
    pred = b.predict(Xho)
    rep.update({"train_s": secs, "iters_per_s": ITERS / secs,
                "resident_sync_iters_per_s": ITERS / ref_s,
                "resident_fused_iters_per_s": reports["int8"]["iters_per_s"],
                "text_equals_resident_sync": True,
                "text_equals_resident_fused": model_text(b) == fused_text,
                "memory": peak, "resident_sync_memory": ref_peak,
                "holdout_auc": auc(pred, yho),
                "block_check": check_block_hist(drv.learner, "int8"),
                "plan_stream_slots": plan.components["stream_slots"]})
    reports["stream_int8"] = rep
    print("main path stream_int8 " + json.dumps(rep), flush=True)
    del b, drv
    # stream_hilo
    b, secs, launches, peak, trees = stream_train(
        lgb, kernels, ds, dict(STREAM_PARAMS, tpu_hist_precision="hilo"),
        ITERS)
    rep = stream_summary("stream_hilo", b, launches, trees, "hist_batched")
    hold = auc(b.predict(Xho), yho)
    if abs(hold - reports["hilo"]["holdout_auc"]) > AUC_TOL:
        fail(f"stream_hilo: held-out AUC {hold} against resident hilo's "
             f"{reports['hilo']['holdout_auc']}")
    rep.update({"train_s": secs, "iters_per_s": ITERS / secs,
                "resident_iters_per_s": reports["hilo"]["iters_per_s"],
                "holdout_auc": hold,
                "resident_holdout_auc": reports["hilo"]["holdout_auc"],
                "memory": peak,
                "block_check": check_block_hist(b._driver.learner, "hilo")})
    reports["stream_hilo"] = rep
    print("main path stream_hilo " + json.dumps(rep), flush=True)
    del b
    # stream_goss_int8: twice, and without double buffering
    goss = dict(STREAM_PARAMS, **STREAM_GOSS)
    texts = []
    for run, params in (("a", goss), ("b", goss),
                        ("single", dict(goss,
                                        tpu_stream_double_buffer=False))):
        b, secs, launches, peak, trees = stream_train(lgb, kernels, ds,
                                                      params, ITERS)
        texts.append(model_text(b))
        if run == "a":
            rep = stream_summary("stream_goss_int8", b, launches, trees,
                                 "hist_batched_int")
            skipped = sum(t["blocks_skipped"] for t in trees)
            if skipped <= 0:
                fail("stream_goss_int8: no block was skipped")
            rep.update({"train_s": secs, "iters_per_s": ITERS / secs,
                        "blocks_replayed": skipped, "memory": peak,
                        "holdout_auc": auc(b.predict(Xho), yho)})
        elif run == "single":
            rep["single_buffer_iters_per_s"] = ITERS / secs
            rep["single_buffer_overlap_pct"] = stream_summary(
                "stream_goss_int8", b, launches, trees,
                "hist_batched_int")["overlap_pct"]
        del b
    if len(set(texts)) != 1:
        fail("stream_goss_int8: the two runs and the single-buffered run "
             "wrote different texts")
    rep["texts_identical"] = True
    reports["stream_goss_int8"] = rep
    print("main path stream_goss_int8 " + json.dumps(rep), flush=True)
    del ds
    print(f"path_s stream_int8+stream_hilo+stream_goss_int8 "
          f"{time.perf_counter() - t0:.1f}", flush=True)
    reports["stream_large_int8"] = stream_large_path(lgb, kernels)
    print("main path stream_large_int8 "
          + json.dumps(reports["stream_large_int8"]), flush=True)
    return cross


def stream_large_path(lgb, kernels):
    """stream_large_int8: 10,000,000 x 28 rows of the generator (seed
    43), int8, 3 iterations under tpu_stream_mode=auto and a budget that
    makes `select_layout` stream, in blocks of 1,048,576 rows.  No 2-D
    integer tensor with the rows as an axis (a [F, n] bins matrix, a
    [n, FR] row-major copy) may stay on the card, the slots are two of
    the largest block.  Set-up past 60 s fails."""
    import gc

    import torch

    t0 = time.perf_counter()
    Xl, yl = make_data(N_LARGE, N_FEAT, seed=43)
    made_s = time.perf_counter() - t0
    params = dict(PARAMS, tpu_hist_precision="int8",
                  tpu_stream_block_rows=LARGE_STREAM_ROWS,
                  tpu_hbm_budget_bytes=LARGE_BUDGET)
    t1 = time.perf_counter()
    ds = lgb.Dataset(Xl, label=yl, params=dict(params)).construct()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t1
    setup_s = time.perf_counter() - t0
    if setup_s > LARGE_SETUP_LIMIT_S:
        fail(f"stream_large_int8: set-up took {setup_s:.1f} s")
    b, secs, launches, peak, trees = stream_train(lgb, kernels, ds, params,
                                                  ITERS_LARGE)
    rep = stream_summary("stream_large_int8", b, launches, trees,
                         "hist_batched_int")
    learner = b._driver.learner
    # no [F, n] bins matrix nor [n, FR] row-major copy of these rows
    gc.collect()
    rows = (N_LARGE, learner.n_pad)
    big = [tuple(t.shape) for t in gc.get_objects()
           if torch.is_tensor(t) and t.is_cuda
           and t.dtype in (torch.uint8, torch.int16, torch.int32)
           and t.dim() == 2 and (t.shape[0] in rows or t.shape[1] in rows)]
    if big:
        fail(f"stream_large_int8: bins tensors on the card: {big}")
    largest = max(int(blk.nbytes) for blk in learner._host_blocks)
    if learner._stream.slot_bytes() != 2 * largest:
        fail(f"stream_large_int8: slots {learner._stream.slot_bytes()} "
             f"bytes, the largest block {largest}")
    if ds._inner.bins_t.device.type != "cpu":
        fail("stream_large_int8: the dataset's bins stayed on the card")
    pred = b.predict(Xl[:N_HOLD])
    if not np.all(np.isfinite(pred)):
        fail("stream_large_int8: predictions are not finite")
    rep.update({"rows": N_LARGE, "n_pad": learner.n_pad, "made_s": made_s,
                "ingest_s": ingest_s, "setup_s": setup_s, "train_s": secs,
                "iters_per_s": ITERS_LARGE / secs, "memory": peak,
                "bins_host_bytes": sum(int(blk.nbytes)
                                       for blk in learner._host_blocks),
                "big_cuda_tensors": big,
                "memory_allocated_after": torch.cuda.memory_allocated()})
    del b, ds, learner, Xl, yl
    gc.collect()
    torch.cuda.empty_cache()
    return rep


def cross_check_stream(lgb, X):
    """Phase 5 of the streamed layout on the first N_SMALL rows: int8
    regression (refit off) streamed in blocks of 16,384 rows, card
    against CPU by the whole text; and a streamed bundle written at its
    midpoint on the card resumed on the CPU, and one written on the CPU
    resumed on the card, each the uninterrupted card run's text."""
    Xs = X[:N_SMALL]
    rng = np.random.default_rng(45)
    y_reg = Xs[:, 0] - 0.5 * Xs[:, 1] * Xs[:, 2] + 0.3 * rng.normal(
        size=N_SMALL)
    reg = dict(PARAMS, objective="regression", metric="l2",
               tpu_hist_precision="int8", tpu_quant_refit_leaves=False,
               tpu_stream_mode="streamed",
               tpu_stream_block_rows=STREAM_SMALL_ROWS)
    tmp = tempfile.mkdtemp()
    try:
        def run(dev, rounds, d=None, resume=False):
            p = dict(reg, device_type=dev)
            if d is not None:
                p["tpu_checkpoint_dir"] = d
            return lgb.train(p, lgb.Dataset(Xs, label=y_reg, params=p),
                             rounds, keep_training_booster=True,
                             resume=resume)

        t0 = time.perf_counter()
        want = model_text(run("cuda", ITERS_STREAM_SMALL))
        if model_text(run("cpu", ITERS_STREAM_SMALL)) != want:
            fail("stream: the streamed int8 text differs card to CPU")
        out = {"stream_int8_card_cpu_identical": True}
        half = ITERS_STREAM_SMALL // 2
        for src, dst in (("cuda", "cpu"), ("cpu", "cuda")):
            d = os.path.join(tmp, f"stream_{src}_to_{dst}")
            run(src, half, d)
            if model_text(run(dst, ITERS_STREAM_SMALL, d,
                              resume=True)) != want:
                fail(f"stream: a streamed {src} bundle resumed on the "
                     f"{dst} differs from the uninterrupted card run")
            out[f"stream_resume_{src}_to_{dst}_identical"] = True
        out["stream_cross_s"] = time.perf_counter() - t0
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- the sharded tree learners (ROADMAP A9a) --------------------------------
ITERS_SHARDED = 5
SHARD_INT_KERNELS = ("hist_batched_int", "partition_rows", "leaf_group",
                     "leaf_sums")
SHARD_INT8 = dict(PARAMS, tpu_hist_precision="int8")
# (name, params, kernels the path must launch, the serial path it is
# compared with); every shard of a path shares the one card: a simulated
# grid
SHARDED_PATHS = [
    ("data_int8", dict(SHARD_INT8, tree_learner="data", num_machines=2),
     SHARD_INT_KERNELS, "int8"),
    ("data_psum_hilo", dict(PARAMS, tree_learner="data", num_machines=2,
                            tpu_hist_agg="psum"),
     ("hist_batched", "partition_rows"), "hilo"),
    ("voting_int8", dict(SHARD_INT8, tree_learner="voting", num_machines=2,
                         top_k=20), SHARD_INT_KERNELS, "int8"),
    ("feature_int8", dict(SHARD_INT8, tree_learner="feature",
                          num_machines=2), SHARD_INT_KERNELS, "int8"),
    ("data_feature_int8", dict(SHARD_INT8, tree_learner="data_feature",
                               num_machines=4, tpu_feature_shards=2,
                               tpu_topology_hosts=2),
     SHARD_INT_KERNELS, "int8"),
]


def sharded_path(lgb, kernels, ds, X, y, params, must_launch, serial,
                 iters=ITERS_SHARDED, per_shard=False, must_not=()):
    """Phase 3, one sharded path: train `iters` iterations at full width
    and predict the held-out rows; B2 must not launch (the JAX grower
    never runs it sharded), nor the kernels `must_not`.  per_shard: each
    kernel of `must_launch` launched at least once a tree a shard.  Its
    held-out AUC beside the serial booster's at as many iterations.
    Returns (report, booster)."""
    import torch

    Xho, yho = X[N_TRAIN:], y[N_TRAIN:]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    booster = lgb.train(dict(params), ds, num_boost_round=iters,
                        keep_training_booster=True)
    trees = booster.num_trees()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    if trees != iters:
        fail(f"trained {trees} trees, expected {iters}")
    driver = booster._driver
    learner = driver.learner
    t = learner.topology
    least = trees * t.size if per_shard else 1
    for name in must_launch:
        if launches[name] < least:
            fail(f"kernel {name} was launched {launches[name]} times on "
                 f"this sharded path, under {least}")
    for name in must_not + ("fused_hist_scan",):
        if launches[name] != 0:
            fail(f"{name} launched {launches[name]} times on this sharded "
                 "path")
    pred = booster.predict(Xho)
    if not np.all(np.isfinite(pred)) or pred.shape != (N_HOLD,):
        fail(f"held-out predictions: shape {pred.shape}")
    hold_auc = auc(pred, yho)
    serial_auc = auc(serial.predict(Xho, num_iteration=iters), yho)
    if not 0.6 < hold_auc <= 1.0 or abs(hold_auc - serial_auc) > AUC_TOL:
        fail(f"held-out AUC {hold_auc} against the serial path's "
             f"{serial_auc}")
    per = {k: launches[k] / trees / t.size
           for k in SHARD_INT_KERNELS + ("hist_batched", "fused_hist_scan")}
    return {"train_s": train_s, "iters_per_s": iters / train_s,
            "holdout_auc": hold_auc,
            "serial_holdout_auc_at_same_iters": serial_auc,
            "auc_minus_serial": hold_auc - serial_auc,
            "strategy": learner.strategy, "hist_agg": learner.hist_agg,
            "shards": t.size, "hosts": t.hosts,
            "feature_shards": t.feature_shards,
            "row_shards": t.data_shards,
            "cards_used": len(set(t.devices)),
            "b2_launched": launches["fused_hist_scan"] > 0,
            "launches": launches,
            "launches_per_tree": {k: v / trees for k, v in launches.items()},
            "launches_per_tree_per_shard": per,
            "host_syncs_per_tree": driver.grower_syncs / trees,
            # the last tree: its host seconds, collectives, and each
            # shard's seconds at the group's barrier
            "last_tree": learner._strategy_grow.last_stats,
            "n_pad": learner.n_pad, "g_pad": learner.g_pad}, booster


def shard_operands(booster, rank=1):
    """A view of shard `rank` of a sharded booster for phase 4's checks
    (the learner attributes they read), and the grad, hess and row mask
    the shard's grower got in one more iteration: its row shard's rows,
    from row0 = rank x its rows on."""
    import types

    from lightgbm_tpu_torch.ops import grower
    from lightgbm_tpu_torch.parallel import topology

    learner = booster._driver.learner
    t = learner.topology
    seen = {}
    grow = grower.grow

    def spy(params, bins_t, g, h, mask, *rest, **kw):
        if topology.current().rank == rank:
            seen["ops"] = (g, h, mask)
        return grow(params, bins_t, g, h, mask, *rest, **kw)

    grower.grow = spy
    try:
        booster.update()
        booster.num_trees()
    finally:
        grower.grow = grow
    n_local = learner.n_pad // t.data_shards
    row0 = t.row_shard(rank) * n_local
    hist = learner.shard_hist_bins[rank]
    view = types.SimpleNamespace(
        bins_t=learner.shard_bins[rank] if hist is None else hist,
        packed_block=learner.packed_block, num_bins=learner.num_bins,
        params=learner.params, n_pad=n_local,
        _ones_mask=learner._ones_mask[row0:row0 + n_local],
        num_features=learner.num_features, meta=learner.shard_metas[rank],
        feature_mask=learner.feature_mask)
    return view, seen["ops"], row0


def check_shards(boosters, gen):
    """Phase 4 on one shard's operands (shard 1 of data_int8 and of
    data_psum_hilo: n_pad/2 rows from row0 = n_pad/2): B1 (hilo, random
    slots), B1-int (the shard's own grad, hess and row mask), B3 and
    the leaf sums, each held to its twin.  Returns (row, path) pairs."""
    out = []
    view, ops, row0 = shard_operands(boosters["data_int8"])
    where = (f"shard 1 of 2, rows {row0} to {row0 + view.n_pad - 1} "
             f"(row0 {row0})")
    rows = [(check_hist_int(view, gen, "shard", ops), "data_int8"),
            (check_partition(view, gen), "data_int8")]
    rows += [(r, "data_int8") for r in check_leaf_sums(view, gen,
                                                       "uniform")]
    hview, _, _ = shard_operands(boosters["data_psum_hilo"])
    rows.append((check_hist(hview, gen, "random"), "data_psum_hilo"))
    for row, path in rows:
        row["operands"] = f"{row.get('operands', 'random')}, {where}"
        out.append((row, path))
    return out


def cross_check_sharded(lgb, X, y, serial_params):
    """Phase 5 of the sharded learners: a data_int8 regression run on the
    first N_SMALL rows (the refit on) gives the same text on the card
    and on the CPU, and so does the two-process test's small int8 run
    with the features once refused (a categorical column, monotone
    constraints, per-node sampling, coupled CEGB); its deterministic=true
    data run gives the CPU's text, or where a last bit of the f64
    matmuls parts, its trees within F64_RTOL (as det_f64's phase 5); and
    at full width data_int8 with the refit off gives the serial int8
    path's text on the card (ITERS_SHARDED iterations)."""
    Xs = X[:N_SMALL]
    rng = np.random.default_rng(46)
    y_reg = Xs[:, 0] + 0.5 * Xs[:, 1] * Xs[:, 2] + 0.3 * rng.normal(
        size=N_SMALL)
    p = dict(SHARDED_PATHS[0][1], objective="regression", metric="l2")
    t0 = time.perf_counter()
    texts = {}
    for dev in ("cuda", "cpu"):
        q = dict(p, device_type=dev)
        b = lgb.train(q, lgb.Dataset(Xs, label=y_reg, params=q),
                      ITERS_SMALL, keep_training_booster=True)
        texts[dev] = model_text(b)
    if texts["cuda"] != texts["cpu"]:
        fail("sharded: the data_int8 regression text differs card to CPU")
    out = {"sharded_data_int8_card_cpu_identical": True,
           "sharded_card_cpu_s": time.perf_counter() - t0}
    # the two-process test's small runs (tests/test_torch_multiprocess.py
    # and tests/torch_mp_worker.py: 4,096 x 10 regression, 15 leaves,
    # max_bin 63): the features once refused, together (monotone
    # constraints, per-node sampling, coupled CEGB, column 3 as twelve
    # categories; data over 4 shards on 2 simulated hosts), and
    # deterministic=true under data
    t0 = time.perf_counter()
    gen = np.random.default_rng(7)
    Xm = gen.normal(size=(MP_SMALL_ROWS, 10))
    ym = Xm[:, 0] + 0.5 * Xm[:, 1] * Xm[:, 2] + 0.1 * gen.normal(
        size=MP_SMALL_ROWS)
    Xc = Xm.copy()
    gen = np.random.default_rng(23)
    Xc[:, 3] = gen.integers(0, 12, MP_SMALL_ROWS)
    yc = ym + gen.normal(size=12)[Xc[:, 3].astype(int)]
    small = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
             "min_data_in_leaf": 5, "tpu_block_rows": 512,
             "tpu_hist_impl": "xla", "tpu_shape_buckets": 0,
             "tpu_quant_refit_leaves": False, "verbosity": -1}
    combined = dict(small, tpu_hist_precision="int8", tree_learner="data",
                    num_machines=4, tpu_topology_hosts=2,
                    tpu_partition_impl="select",
                    monotone_constraints=[1, 1, -1] + [0] * 7,
                    feature_fraction_bynode=0.5,
                    cegb_penalty_feature_coupled=[5.0] * 10)
    det = dict(small, tpu_hist_precision="f32", deterministic=True,
               tree_learner="data", num_machines=4, tpu_topology_hosts=2)
    for what, q0, Xq, yq, cat in (
            ("features_int8", combined, Xc, yc, [3]),
            ("data_f64", det, Xm, ym, "auto")):
        texts, got = {}, {}
        for dev in ("cuda", "cpu"):
            q = dict(q0, device_type=dev)
            got[dev] = lgb.train(q, lgb.Dataset(Xq, label=yq, params=q,
                                                categorical_feature=cat),
                                 MP_SMALL_ITERS, keep_training_booster=True)
            texts[dev] = model_text(got[dev])
            if got[dev].num_trees() != MP_SMALL_ITERS:
                fail(f"sharded: the {what} run stopped at "
                     f"{got[dev].num_trees()} trees")
        same = texts["cuda"] == texts["cpu"]
        out[f"sharded_{what}_card_cpu_identical"] = same
        if not same and what == "data_f64":
            # the serial f64 paths' card-CPU contract: cuBLAS and the
            # CPU's f64 matmuls may part in a sum's last bit
            out.update({f"sharded_{what}_{k}": v for k, v in _trees_close(
                got["cpu"], got["cuda"], F64_RTOL, what).items()})
        elif not same:
            fail(f"sharded: the {what} regression text differs card to CPU")
    out["sharded_features_card_cpu_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = lgb.Dataset(X[:N_TRAIN], label=y[:N_TRAIN],
                     params=dict(PARAMS)).construct()
    off = {"tpu_quant_refit_leaves": False}
    sharded = lgb.train(dict(SHARDED_PATHS[0][1], **off), ds, ITERS_SHARDED,
                        keep_training_booster=True)
    serial = lgb.train(dict(serial_params, **off), ds, ITERS_SHARDED,
                       keep_training_booster=True)
    if model_text(sharded) != model_text(serial):
        fail("sharded: data_int8 with the refit off differs from the "
             "serial int8 text on the card")
    out["sharded_data_int8_equals_serial"] = True
    out["sharded_serial_s"] = time.perf_counter() - t0
    return out


# ---- the sharded learners with the features they once refused (A9c) --------
# the iterations of the paths whose serial paths are slow (det_f64,
# cat_int8, sparse_hilo)
ITERS_SHARDED_SLOW = 3
# phase 5's runs at the two-process test's small shape
MP_SMALL_ROWS = 4096
MP_SMALL_ITERS = 2
# CEGB under voting: CEGB_PARAMS without its lazy penalties, which a
# sharded learner refuses as the JAX learner does
VOTING_CEGB_PARAMS = dict(CEGB_PARAMS,
                          cegb_penalty_feature_lazy=[0.0] * N_FEAT)
# name -> (params, kernels each shard launches every tree, kernels that
# must not launch, the serial path it is compared with, iterations); the
# monotone path's constraints and the forced path's file are added where
# they run.  Every shard shares the one card.  The serial path of
# voting_cegb_int8 (cegb_int8 without its lazy penalties) is trained
# where it runs
FEATURE_PATHS = {
    "data_mono_int8": (dict(MONO_PARAMS, tree_learner="data",
                            num_machines=2), SHARD_INT_KERNELS, (),
                       "mono_int8", ITERS_SHARDED),
    "feature_bynode_int8": (dict(BYNODE_PARAMS, tree_learner="feature",
                                 num_machines=2), SHARD_INT_KERNELS, (),
                            "bynode_int8", ITERS_SHARDED),
    "voting_cegb_int8": (dict(VOTING_CEGB_PARAMS, tree_learner="voting",
                              num_machines=2, top_k=20), SHARD_INT_KERNELS,
                         (), "cegb_coupled_int8", ITERS_SHARDED),
    "data_forced_hilo": (dict(PARAMS, tree_learner="data", num_machines=2),
                         ("hist_batched", "partition_rows"), (),
                         "forced_hilo", ITERS_SHARDED),
    "data_det_f64": (dict(DET_PARAMS, tree_learner="data", num_machines=2),
                     ("partition_rows",), ("hist_batched",
                                           "hist_batched_int"),
                     "det_f64", ITERS_SHARDED_SLOW),
    "data_cat_int8": (dict(CAT_PARAMS, tpu_hist_precision="int8",
                           tree_learner="data", num_machines=2),
                      ("hist_batched_int", "leaf_group", "leaf_sums"),
                      ("partition_rows",), "cat_int8", ITERS_SHARDED_SLOW),
    "data_sparse_hilo": (dict(SPARSE_PARAMS, tree_learner="data",
                              num_machines=2), ("hist_batched",),
                         ("partition_rows", "hist_batched_int"),
                         "sparse_hilo", ITERS_SHARDED_SLOW),
}


def feature_path(lgb, kernels, name, ds, X, y, boosters, extra=None):
    """Phase 3, one path of FEATURE_PATHS through `sharded_path` (its
    kernels launched on each shard every tree, no B2), then the check its
    serial path runs: the monotone grid, the forced heads, the features
    CEGB lets split (fewer than the int8 path's in as many trees, and
    every shard's CEGB state those features), the categorical splits by
    mode, the f64 text equal to the serial path's first trees, the COO
    entries of each row shard.  Returns (report, booster)."""
    params, must, must_not, serial, iters = FEATURE_PATHS[name]
    params = dict(params, **(extra or {}))
    if serial not in boosters:
        boosters[serial] = lgb.train(
            dict(params, tree_learner="serial", num_machines=1), ds, iters,
            keep_training_booster=True)
    report, booster = sharded_path(lgb, kernels, ds, X, y, params, must,
                                   boosters[serial], iters=iters,
                                   per_shard=True, must_not=must_not)
    report["serial_path"] = serial
    learner = booster._driver.learner
    if name == "data_mono_int8":
        report.update(check_monotone(booster, X,
                                     params["monotone_constraints"], name))
    elif name == "data_forced_hilo":
        report["forced_bins"] = check_forced(booster, ds, name)
    elif name == "feature_bynode_int8":
        report.update(draw_width=learner.draw_width, f_pad=learner.f_pad)
    elif name == "voting_cegb_int8":
        used = sorted({int(f) for f in split_features(booster)})
        boosters["int8"].num_trees()     # the lazy trees materialized
        plain = sorted({int(f) for t in boosters["int8"]._driver.models[
            :iters] for f in t.split_feature[:t.num_leaves - 1]})
        state = [m["cegb_used"].cpu().numpy() for m in learner.shard_metas]
        if any(not np.array_equal(state[0], s) for s in state[1:]):
            fail(f"{name}: the shards' CEGB states differ")
        marked = sorted(int(learner.td.used_feature_idx[j]) for j in
                        np.flatnonzero(state[0][:learner.num_features]))
        if marked != used:
            fail(f"{name}: the CEGB state marks {marked}, the trees split "
                 f"on {used}")
        if len(used) >= len(plain):
            fail(f"{name} split on {len(used)} features, the int8 path on "
                 f"{len(plain)} in as many trees")
        report.update(features_used=used, int8_features_used=plain)
    elif name == "data_cat_int8":
        onehot, ctr = cat_splits(booster)
        if onehot + ctr == 0:
            fail(f"{name}: no categorical split")
        report.update(cat_splits_onehot=onehot, cat_splits_ctr=ctr,
                      cat_splits_per_tree=(onehot + ctr) / iters)
    elif name == "data_det_f64":
        if learner.params.precision != "f64":
            fail(f"{name}: the learner does not run f64 histograms")
        want = boosters[serial].model_to_string(num_iteration=iters)
        if _tree_blocks(booster.model_to_string()) != _tree_blocks(want):
            fail(f"{name}: the trees differ from the serial det_f64 path's "
                 f"first {iters}")
        report["trees_equal_serial"] = True
    elif name == "data_sparse_hilo":
        entries = [int(m["sp_rows"].numel()) for m in learner.shard_metas]
        want = None if learner.sparse is None else learner.sparse["entries"]
        if sum(entries) != want:
            fail(f"{name}: the shards' COO tables hold {entries} entries "
                 f"of {want}")
        report.update(coo_features=len(learner.sparse["sparse_idx"]),
                      coo_entries_by_shard=entries,
                      window=learner.sparse["window"])
    return report, booster


# ---- the distributed learners across processes (ROADMAP A9b) ----------------
MP_RANKS = 2
MP_TIMEOUT_S = 420.0
# the deadline of every collective of the workers, and of their group
MP_COLLECTIVE_S = 120.0
MP_DATA = dict(SHARD_INT8, tree_learner="data", num_machines=2)
# (name, how the rows are held): every rank holds every row, or each its
# own half (pre_partition: distributed binning, a partitioned
# validation set of the held-out rows)
MP_PATHS = (("mp_data_int8", "full"), ("mp_prepart_int8", "prepart"))
MP_KERNELS = ("hist_batched_int", "partition_rows", "leaf_group",
              "leaf_sums")


def _without_profile(text: str) -> str:
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("tpu_feature_profile:"))


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _mp_train(lgb, kernels, params, ds, valid=None):
    """One path of a worker: the launch counters set to 0 just before
    lgb.train and read just after, the transport's counters around it."""
    import torch

    from lightgbm_tpu_torch.parallel import topology

    ev = {}
    kw = {} if valid is None else {"valid_sets": [valid],
                                   "valid_names": ["hold"],
                                   "evals_result": ev}
    torch.cuda.synchronize()
    # both ranks start the clock together: the skew of their ingest
    # must not count as a wait in the first collective
    topology.host_allgather(np.zeros(1), name="mp_path_start")
    before = dict(topology.TRANSPORT)
    kernels.reset_launches()
    t0 = time.perf_counter()
    b = lgb.train(dict(params), ds, ITERS_SHARDED,
                  keep_training_booster=True, **kw)
    trees = b.num_trees()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    moved = {k: topology.TRANSPORT[k] - before[k] for k in before}
    driver = b._driver
    learner = driver.learner
    st = learner._strategy_grow.last_stats
    return b, ev, {
        "train_s": train_s, "iters_per_s": ITERS_SHARDED / train_s,
        "trees": trees, "launches": launches,
        "launches_per_tree": {k: v / trees for k, v in launches.items()},
        "host_syncs_per_tree": driver.grower_syncs / trees,
        # every process-level collective of the run (the leader's device
        # exchanges, the leaf-id gathers, metric and init syncs): calls,
        # host seconds and the bytes this process sent, a tree
        "proc_calls_per_tree": moved["calls"] / trees,
        "proc_s_per_tree": moved["seconds"] / trees,
        "proc_bytes_per_tree": moved["bytes"] / trees,
        "last_tree": st, "local_shards": learner.topology.local_size,
        "partitioned": bool(learner._partitioned),
        "rows": int(driver.train_data.num_data),
        "n_pad": learner.n_pad, "row_width": learner.row_width}


def mp_worker(spec_path: str) -> None:
    """One rank of the two-process paths (started by `mp_paths` with
    LIGHTGBM_TPU_PROCESS_ID): mp_data_int8, every rank holding every row;
    mp_prepart_int8, each its half (pre_partition), the held-out rows a
    partitioned validation set; and phase 5's small int8 regression on
    the card and on the CPU.  Writes its reports and texts as JSON."""
    import torch

    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ["LIGHTGBM_TPU_PROCESS_ID"])
    sys.path.insert(0, spec["root"])
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import kernels

    from lightgbm_tpu_torch.parallel import collective, mesh

    out = {"rank": rank}
    net = {"machines": spec["machines"],
           "tpu_collective_timeout_s": MP_COLLECTIVE_S}
    # the rendezvous first, outside every timed path
    collective.configure(timeout_s=MP_COLLECTIVE_S)
    t0 = time.perf_counter()
    mesh.init_multihost(spec["machines"], 0, MP_RANKS)
    out["rendezvous_s"] = time.perf_counter() - t0
    X, y = make_data(N_TRAIN + N_HOLD, N_FEAT)
    Xho, yho = X[N_TRAIN:], y[N_TRAIN:]
    t0 = time.perf_counter()
    ds = lgb.Dataset(X[:N_TRAIN], label=y[:N_TRAIN],
                     params=dict(MP_DATA, **net)).construct()
    out["ingest_s_full"] = time.perf_counter() - t0
    b, _, rep = _mp_train(lgb, kernels, dict(MP_DATA, **net), ds)
    pred = b.predict(Xho)
    rep["holdout_auc"] = auc(pred, yho)
    rep["finite"] = bool(np.all(np.isfinite(pred))
                         and pred.shape == (N_HOLD,))
    out["mp_data_int8"] = dict(rep, text=model_text(b))
    del b, ds
    # pre_partition: rank k keeps its half of the training rows and of
    # the held-out rows; bins from distributed binning
    pp = dict(MP_DATA, pre_partition=True, metric="auc", **net)
    half, hh = N_TRAIN // MP_RANKS, N_HOLD // MP_RANKS
    rows = slice(rank * half, (rank + 1) * half)
    hrows = slice(N_TRAIN + rank * hh, N_TRAIN + (rank + 1) * hh)
    t0 = time.perf_counter()
    ds = lgb.Dataset(X[rows], label=y[rows], params=pp).construct()
    out["ingest_s_prepart"] = time.perf_counter() - t0
    valid = lgb.Dataset(X[hrows], label=y[hrows], reference=ds, params=pp)
    b, ev, rep = _mp_train(lgb, kernels, pp, ds, valid)
    rep["holdout_auc"] = ev["hold"]["auc"][-1]
    rep["holdout_auc_curve"] = ev["hold"]["auc"]
    pred = b.predict(Xho)
    rep["finite"] = bool(np.all(np.isfinite(pred)))
    rep["whole_holdout_auc"] = auc(pred, yho)
    out["mp_prepart_int8"] = dict(rep, text=model_text(b))
    del b, ds, valid
    # phase 5: the small int8 regression across the two processes, on
    # the card and on the CPU
    Xs = X[:N_SMALL]
    rng = np.random.default_rng(46)
    y_reg = Xs[:, 0] + 0.5 * Xs[:, 1] * Xs[:, 2] + 0.3 * rng.normal(
        size=N_SMALL)
    small = {}
    for dev in ("cuda", "cpu"):
        q = dict(MP_DATA, objective="regression", metric="l2",
                 device_type=dev, **net)
        small[dev] = model_text(lgb.train(
            q, lgb.Dataset(Xs, label=y_reg, params=q), ITERS_SMALL))
    out["small"] = small
    with open(spec["out"][rank], "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def mp_paths(lgb, ds, X, y, reports, cross):
    """Phase 3's two-process paths and phase 5's check: two workers of
    this script on the first card (`mp_worker`), rendezvous over a
    machine list on localhost; the parent waits (killing both and
    failing with their logs' ends past MP_TIMEOUT_S) and checks: both
    ranks' texts equal; mp_data_int8's the text of an in-process run at
    num_machines=2, tpu_topology_hosts=2; B1-int, B3 and the leaf sums
    launched on each rank; the small regression's text equal on the card
    and on the CPU, and to the CPU's in-process text."""
    tmp = tempfile.mkdtemp()
    outs = [os.path.join(tmp, f"rank{k}.json") for k in range(MP_RANKS)]
    spec = {"root": os.path.dirname(os.path.abspath(__file__)),
            "machines": ",".join(f"127.0.0.1:{_free_port()}"
                                 for _ in range(MP_RANKS)),
            "out": outs}
    spec_path = os.path.join(tmp, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    procs, logs = [], []
    for rank in range(MP_RANKS):
        log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
        logs.append(log.name)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mp-worker",
             spec_path],
            env=dict(os.environ, LIGHTGBM_TPU_PROCESS_ID=str(rank)),
            stdout=log, stderr=subprocess.STDOUT))
    def tails():
        return "\n".join(f"--- rank {k}:\n" + open(p).read()[-4000:]
                         for k, p in enumerate(logs))

    deadline = time.monotonic() + MP_TIMEOUT_S
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.wait()
            fail("a two-process worker timed out:\n" + tails())
    for k, p in enumerate(procs):
        if p.returncode != 0:
            fail(f"two-process rank {k} failed:\n" + tails())
    wall_s = time.perf_counter() - t0
    # the in-process run mp_data_int8 must equal, after the workers (it
    # would share the card and the host with them)
    inproc = model_text(lgb.train(dict(MP_DATA, tpu_topology_hosts=2), ds,
                                  ITERS_SHARDED))
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    for name, rows in MP_PATHS:
        r0, r1 = (r[name] for r in ranks)
        if _without_profile(r0["text"]) != _without_profile(r1["text"]) \
                or (rows == "full" and r0["text"] != r1["text"]):
            # under pre_partition the tpu_feature_profile: trailer is the
            # profile of each rank's own rows, as in the JAX package
            fail(f"{name}: the two ranks' model texts differ")
        for k, r in enumerate((r0, r1)):
            if r["trees"] != ITERS_SHARDED or not r["finite"]:
                fail(f"{name} rank {k}: {r['trees']} trees, finite "
                     f"predictions {r['finite']}")
            for kern in MP_KERNELS:
                if r["launches"][kern] <= 0:
                    fail(f"{name} rank {k}: kernel {kern} was not launched")
            if r["launches"]["fused_hist_scan"] != 0:
                fail(f"{name} rank {k}: B2 launched under a sharded learner")
            if not 0.6 < r["holdout_auc"] <= 1.0:
                fail(f"{name} rank {k}: held-out AUC {r['holdout_auc']}")
        shown = MP_KERNELS + ("fused_hist_scan", "hist_batched")
        reports[name] = {
            "iters_per_s": [r["iters_per_s"] for r in (r0, r1)],
            "holdout_auc": [r["holdout_auc"] for r in (r0, r1)],
            "launches": {k: sum(r["launches"][k] for r in (r0, r1))
                         for k in r0["launches"]},
            "launches_per_tree": {k: sum(r["launches_per_tree"][k]
                                         for r in (r0, r1))
                                  for k in r0["launches"]},
            "rank_launches": [r["launches"] for r in (r0, r1)],
            "ranks": [{**{k: v for k, v in r.items()
                          if k not in ("text", "launches",
                                       "launches_per_tree")},
                       "launches_per_tree": {k: r["launches_per_tree"][k]
                                             for k in shown}}
                      for r in (r0, r1)]}
        print(f"main path {name} " + json.dumps({
            k: v for k, v in reports[name].items()
            if k not in ("launches", "launches_per_tree", "rank_launches")}),
            flush=True)
    if ranks[0]["mp_data_int8"]["text"] != inproc:
        fail("mp_data_int8: the two-process text differs from the "
             "in-process run at num_machines=2, tpu_topology_hosts=2")
    small = ranks[0]["small"]
    if any(r["small"] != small for r in ranks):
        fail("phase 5: the two ranks' small regression texts differ")
    Xs = X[:N_SMALL]
    rng = np.random.default_rng(46)
    y_reg = Xs[:, 0] + 0.5 * Xs[:, 1] * Xs[:, 2] + 0.3 * rng.normal(
        size=N_SMALL)
    q = dict(MP_DATA, objective="regression", metric="l2",
             device_type="cpu", tpu_topology_hosts=2)
    cpu_inproc = model_text(lgb.train(
        q, lgb.Dataset(Xs, label=y_reg, params=q), ITERS_SMALL))
    if not small["cuda"] == small["cpu"] == cpu_inproc:
        fail("phase 5: the two-process int8 regression text differs card "
             "to CPU, or from the CPU's in-process text")
    cross["mp_small_int8_card_cpu_identical"] = True
    print(f"path_s mp_paths {wall_s:.1f} (two workers, with their "
          f"start-up, data and ingest: {[r['ingest_s_full'] for r in ranks]}"
          " s full, " f"{[r['ingest_s_prepart'] for r in ranks]} s "
          "pre_partition)", flush=True)


# ---------------------------------------------------------------------------
# the telemetry phase (ROADMAP A11): the span tracer, the registry's phase
# timer and the device-memory gauges, live on the int8 and hilo paths
# ---------------------------------------------------------------------------
TELEMETRY_ITERS = 20
TELEMETRY_HILO_ITERS = 10
TELEMETRY_SHARDED_ITERS = 3
TELEMETRY_PROFILED_ITERS = 2
OVERHEAD_ITERS = 10
# the modes of the overhead runs, interleaved
OVERHEAD_ORDER = ("off", "metrics", "trace", "trace", "metrics", "off")
# the share of the train loop's wall the round spans must cover
ROUND_COVER = 0.95
TRACE_NAMES = ("train/iteration", "train_dispatch", "tree_materialize",
               "metric_eval", "sketch", "binning")
TRACE_INT8 = PATHS[1][1]
TRACE_DATA_INT8 = SHARDED_PATHS[0][1]


def _reset_telemetry():
    from lightgbm_tpu_torch import obs

    obs.configure(mode="off", trace_dir="")
    obs.flush()
    obs.reset_events()


def _telemetry_train(lgb, kernels, X, y, params, mode, iters, trace_dir,
                     valid=False, ds=None):
    """lgb.train of `iters` iterations under tpu_telemetry=mode (its own
    Dataset, made under that mode, where `ds` is None), its host waits
    counted (`count_syncs`).  Returns (booster, host waits, train
    seconds, launches, Dataset seconds)."""
    import torch

    _reset_telemetry()
    q = dict(params, tpu_telemetry=mode)
    if mode == "trace":
        q["tpu_trace_dir"] = trace_dir
    t0 = time.perf_counter()
    if ds is None:
        ds = lgb.Dataset(X[:N_TRAIN], label=y[:N_TRAIN],
                         params=dict(q)).construct()
    vs = ([lgb.Dataset(X[N_TRAIN:], label=y[N_TRAIN:], reference=ds,
                       params=dict(q)).construct()] if valid else None)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    kernels.reset_launches()
    box = {}

    def train():
        box["b"] = lgb.train(q, ds, num_boost_round=iters, valid_sets=vs,
                             valid_names=["holdout"] if valid else None,
                             keep_training_booster=True)
        box["b"].num_trees()

    t0 = time.perf_counter()
    syncs = count_syncs(train)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    if box["b"].num_trees() != iters:
        fail(f"telemetry={mode}: {box['b'].num_trees()} trees, expected "
             f"{iters}")
    return box["b"], syncs, train_s, dict(kernels.launches), ingest_s


def _within(ev, spans):
    """Does span or launch `ev` lie inside one of `spans` (ts and dur in
    µs, as Chrome events and the tracer's buffer give them) on its own
    thread?"""
    t0, t1 = ev["ts"], ev["ts"] + ev.get("dur", 0.0)
    return any(s["tid"] == ev["tid"] and s["ts"] <= t0
               and t1 <= s["ts"] + s["dur"] for s in spans)


def check_mirror(booster, kernels, must, tmp):
    """The spans' torch.profiler mirror: a profile of
    TELEMETRY_PROFILED_ITERS traced iterations holds the user annotations
    train/iteration and train_dispatch, and every kernel launch the
    training thread made (the CUDA runtime's and driver's launch calls,
    CPU-side events) lies inside a train/iteration annotation; there are
    at least as many as the path's kernels counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    kernels.reset_launches()
    with tprofile(activities=acts) as prof:
        for _ in range(TELEMETRY_PROFILED_ITERS):
            booster.update()
        torch.cuda.synchronize()
    calls = dict(kernels.launches)
    path = os.path.join(tmp, "mirror-profile.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        evs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    notes = [e for e in evs if e.get("cat") == "user_annotation"]
    iters = [e for e in notes if e["name"] == "train/iteration"]
    names = {e["name"] for e in notes}
    if len(iters) != TELEMETRY_PROFILED_ITERS or not {
            "train/iteration", "train_dispatch"} <= names:
        fail(f"mirror: {len(iters)} train/iteration annotations, names "
             f"{sorted(names)}")
    tids = {e["tid"] for e in iters}
    launches = [e for e in evs
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "Launch" in e["name"] and e["tid"] in tids]
    outside = [e["name"] for e in launches if not _within(e, iters)]
    ours = sum(calls[k] for k in must)
    if outside:
        fail(f"mirror: {len(outside)} of {len(launches)} launches of the "
             f"training thread outside train/iteration: {outside[:5]}")
    if len(launches) < ours:
        fail(f"mirror: {len(launches)} launch calls on the training "
             f"thread, fewer than the path kernels' {ours}")
    for k in must:
        if calls[k] <= 0:
            fail(f"mirror: kernel {k} was not launched in the profile")
    kinds = {}
    for e in launches:
        kinds[e["name"]] = kinds.get(e["name"], 0) + 1
    return {"annotations": sorted(names), "launch_calls": kinds,
            "path_kernel_launches": ours}


def trace_int8_path(lgb, kernels, X, y, trace_dir, tmp):
    """trace_int8: the int8 path with the held-out rows as a validation
    set under tpu_telemetry=trace, beside the same run under off."""
    from lightgbm_tpu_torch import obs

    # one iteration first: a process's first training makes host waits
    # of its own (12 on an H100: one-time reads the process keeps),
    # which the two counted runs must not see
    _telemetry_train(lgb, kernels, X, y, TRACE_INT8, "off", 1, trace_dir)
    off, off_syncs, off_s, _, off_ingest = _telemetry_train(
        lgb, kernels, X, y, TRACE_INT8, "off", TELEMETRY_ITERS, trace_dir,
        valid=True)
    b, syncs, train_s, launches, ingest_s = _telemetry_train(
        lgb, kernels, X, y, TRACE_INT8, "trace", TELEMETRY_ITERS,
        trace_dir, valid=True)
    for k in INT_KERNELS:
        if launches[k] <= 0:
            fail(f"trace_int8: kernel {k} was not launched")
    if model_text(b) != model_text(off):
        fail("trace_int8: the model text differs from the run with "
             "telemetry off")
    if syncs != off_syncs:
        fail(f"trace_int8: {syncs} host waits traced against {off_syncs} "
             "with telemetry off")
    with open(os.path.join(trace_dir, "trace-host0.json")) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    rounds = [e for e in spans if e["name"] == "train/round"]
    if sorted(e["args"]["iteration"] for e in rounds) != list(
            range(TELEMETRY_ITERS)):
        fail(f"trace_int8: {len(rounds)} train/round spans")
    loop_wall = (max(e["ts"] + e["dur"] for e in rounds)
                 - min(e["ts"] for e in rounds))
    cover = sum(e["dur"] for e in rounds) / loop_wall
    if cover < ROUND_COVER:
        fail(f"trace_int8: the round spans cover {cover:.4f} of the loop")
    names = {e["name"] for e in spans}
    missing = [n for n in TRACE_NAMES if n not in names]
    if missing:
        fail(f"trace_int8: spans {missing} missing from {sorted(names)}")
    with open(os.path.join(trace_dir, "events-host0.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    counts = {}
    for e in spans:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    mirror = check_mirror(b, kernels, INT_KERNELS, tmp)
    return {"train_s": train_s, "iters_per_s": TELEMETRY_ITERS / train_s,
            "off_train_s": off_s,
            "off_iters_per_s": TELEMETRY_ITERS / off_s,
            "ingest_s": ingest_s, "off_ingest_s": off_ingest,
            "host_syncs_per_tree": syncs / TELEMETRY_ITERS,
            "off_host_syncs_per_tree": off_syncs / TELEMETRY_ITERS,
            "round_cover": cover, "loop_wall_ms": loop_wall / 1e3,
            "span_counts": counts, "jsonl_lines": len(lines),
            "dropped": obs.REGISTRY.value("lgbm_trace_events_dropped_total"),
            "launches": launches,
            "mirror": mirror}


def metrics_hilo_path(lgb, kernels, X, y, trace_dir):
    """metrics_hilo: the hilo path under tpu_telemetry=metrics: the phase
    timer's runs, the Prometheus text, the phase peaks against the card's
    memory and the resident bins, memory_snapshot against the
    allocator."""
    import torch
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.obs import resources
    from lightgbm_tpu_torch.utils import membudget, timer

    timer.reset()
    resources.reset_phase_peaks()
    b, syncs, train_s, launches, ingest_s = _telemetry_train(
        lgb, kernels, X, y, PARAMS, "metrics", TELEMETRY_HILO_ITERS,
        trace_dir)
    pred = b.predict(X[N_TRAIN:])
    if not np.all(np.isfinite(pred)):
        fail("metrics_hilo: held-out predictions not finite")
    for k in ("hist_batched", "partition_rows"):
        if launches[k] <= 0:
            fail(f"metrics_hilo: kernel {k} was not launched")
    runs = timer.counts()
    if runs.get("train_dispatch") != TELEMETRY_HILO_ITERS:
        fail(f"metrics_hilo: phase runs {runs}")
    text = obs.REGISTRY.to_prometheus_text()
    for family in ("lgbm_phase_seconds_total",
                   "lgbm_device_phase_peak_bytes"):
        if f"# TYPE {family} " not in text:
            fail(f"metrics_hilo: {family} missing from the Prometheus text")
    peaks = resources.phase_peaks()
    total = torch.cuda.get_device_properties(0).total_memory
    for phase in ("ingest", "hist_build", "predict"):
        if not 0 < peaks.get(phase, 0) <= total:
            fail(f"metrics_hilo: phase peak {phase} {peaks.get(phase)} "
                 f"outside (0, {total}]")
    learner = b._driver.learner
    rows = getattr(learner.bins_t, "_lgbt_rows", (None, None))[1]
    resident = (learner.bins_t.numel() * learner.bins_t.element_size()
                if rows is None else rows.numel() * rows.element_size())
    if peaks["hist_build"] < resident:
        fail(f"metrics_hilo: hist_build peak {peaks['hist_build']} under "
             f"the resident bins' {resident} bytes")
    snap = membudget.memory_snapshot()
    want = (torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated())
    if (snap["hbm_bytes_in_use"], snap["hbm_peak_bytes"]) != want:
        fail(f"metrics_hilo: memory_snapshot {snap} against the "
             f"allocator's {want}")
    return {"train_s": train_s, "iters_per_s": TELEMETRY_HILO_ITERS / train_s,
            "ingest_s": ingest_s,
            "host_syncs_per_tree": syncs / TELEMETRY_HILO_ITERS,
            "phase_runs": runs,
            "phase_seconds": timer.summary(), "phase_peaks": peaks,
            "resident_bins_bytes": resident, "total_memory": total,
            "memory_snapshot": snap, "launches": launches,
            "bench_resources": resources.bench_resource_metrics(
                memory=False)["phase_peak_hbm_bytes"]}


def trace_data_int8_path(lgb, kernels, X, y, ds, trace_dir):
    """trace_data_int8: the data learner (2 shards on the card) traced:
    each shard thread's `shard/grow` span on its own tid, inside the step
    of the training thread one level below it, and each exchange span
    inside its shard's span."""
    from lightgbm_tpu_torch import obs

    b, syncs, train_s, launches, _ = _telemetry_train(
        lgb, kernels, X, y, TRACE_DATA_INT8, "trace",
        TELEMETRY_SHARDED_ITERS, trace_dir, ds=ds)
    for k in ("hist_batched_int", "partition_rows"):
        if launches[k] <= 0:
            fail(f"trace_data_int8: kernel {k} was not launched")
    spans = [e for e in obs.events() if e["kind"] == "span"]
    steps = [e for e in spans if e["name"] == "train_dispatch"]
    shards = [e for e in spans if e["name"] == "shard/grow"]
    exchanges = [e for e in spans if e["name"].startswith("exchange/")]
    shard_count = TRACE_DATA_INT8["num_machines"]
    if len(steps) != TELEMETRY_SHARDED_ITERS or \
            len(shards) != shard_count * TELEMETRY_SHARDED_ITERS:
        fail(f"trace_data_int8: {len(steps)} steps, {len(shards)} shard "
             "spans")
    main_tids = {e["tid"] for e in steps}
    for step in steps:
        inside = [s for s in shards
                  if step["ts"] <= s["ts"]
                  and s["ts"] + s["dur"] <= step["ts"] + step["dur"]]
        tids = {s["tid"] for s in inside}
        if len(inside) != shard_count or len(tids) != shard_count \
                or tids & main_tids:
            fail(f"trace_data_int8: a step holds {len(inside)} shard spans "
                 f"on threads {sorted(tids)} (training thread "
                 f"{sorted(main_tids)})")
        if any(s["tags"]["parent"] != "train_dispatch"
               or s["tags"]["depth"] != step["tags"]["depth"] + 1
               for s in inside):
            fail("trace_data_int8: a shard span does not nest under its "
                 "step")
    for e in exchanges:
        if e["tags"].get("parent") != "shard/grow" or not _within(e, shards):
            fail(f"trace_data_int8: {e['name']} outside its shard's span")
    if not exchanges:
        fail("trace_data_int8: no exchange spans")
    return {"train_s": train_s,
            "iters_per_s": TELEMETRY_SHARDED_ITERS / train_s,
            "host_syncs_per_tree": syncs / TELEMETRY_SHARDED_ITERS,
            "shard_spans": len(shards), "exchange_spans": len(exchanges),
            "shard_tids": len({s["tid"] for s in shards}),
            "launches": launches}


def telemetry_overhead(lgb, kernels, X, y, ds, trace_dir):
    """int8 iterations a second under each telemetry mode, interleaved
    (OVERHEAD_ORDER) on one Dataset; the texts must agree."""
    runs, texts = [], set()
    for mode in OVERHEAD_ORDER:
        b, syncs, train_s, _, _ = _telemetry_train(
            lgb, kernels, X, y, TRACE_INT8, mode, OVERHEAD_ITERS, trace_dir,
            ds=ds)
        texts.add(model_text(b))
        runs.append({"mode": mode, "iters_per_s": OVERHEAD_ITERS / train_s,
                     "host_syncs_per_tree": syncs / OVERHEAD_ITERS})
        del b
    if len(texts) != 1:
        fail(f"telemetry overhead: {len(texts)} distinct model texts "
             "across the modes")
    by_mode = {}
    for r in runs:
        by_mode.setdefault(r["mode"], []).append(r["iters_per_s"])
    return {"order": runs, "iters_per_s_by_mode": by_mode}


def telemetry_paths(lgb, kernels, X, y, reports, tmp):
    """The telemetry phase: trace_int8, metrics_hilo, trace_data_int8 and
    the overhead runs; every failed check fails the smoke."""
    trace_dir = tempfile.mkdtemp(dir=tmp)
    try:
        t0 = time.perf_counter()
        reports["trace_int8"] = trace_int8_path(lgb, kernels, X, y,
                                                trace_dir, tmp)
        print("main path trace_int8 " + json.dumps(reports["trace_int8"]),
              flush=True)
        reports["metrics_hilo"] = metrics_hilo_path(lgb, kernels, X, y,
                                                    trace_dir)
        print("main path metrics_hilo "
              + json.dumps(reports["metrics_hilo"]), flush=True)
        ds = lgb.Dataset(X[:N_TRAIN], label=y[:N_TRAIN],
                         params=dict(TRACE_INT8)).construct()
        reports["trace_data_int8"] = trace_data_int8_path(
            lgb, kernels, X, y, ds, trace_dir)
        print("main path trace_data_int8 "
              + json.dumps(reports["trace_data_int8"]), flush=True)
        overhead = telemetry_overhead(lgb, kernels, X, y, ds, trace_dir)
        print(f"telemetry overhead ({smi_line()}) " + json.dumps(overhead),
              flush=True)
        print(f"path_s telemetry {time.perf_counter() - t0:.1f}",
              flush=True)
    finally:
        _reset_telemetry()


def main() -> None:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import lightgbm_tpu_torch as lgb
        from lightgbm_tpu_torch.ops import kernels
    except ImportError as exc:
        fail(f"lightgbm_tpu_torch is not importable next to this script "
             f"({exc})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)

    from lightgbm_tpu_torch.utils.compile_ledger import LEDGER

    # the build ledger: the library's build, each kernel site's plans
    LEDGER.enable()
    kernels.library()
    print(f"kernels built in {kernels.build_seconds:.2f} s", flush=True)
    print(kernels.build_log.strip(), flush=True)

    X, y, w = make_data(N_TRAIN + N_HOLD, N_FEAT, with_w=True)
    # the forced splits' JSON file of forced_hilo and phase 5
    fd, forced_file = tempfile.mkstemp(suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(FORCED_TREE, f)
    atexit.register(os.unlink, forced_file)
    # one binned dataset per max_bin (255, 15 for the packed paths, 1023
    # for the wide ones)
    datasets = {}
    for _, params, _, _ in PATHS:
        if params["max_bin"] not in datasets:
            t0 = time.perf_counter()
            ds = datasets[params["max_bin"]] = lgb.Dataset(
                X[:N_TRAIN], label=y[:N_TRAIN],
                params=dict(params)).construct()
            torch.cuda.synchronize()
            bins = ds._inner.bins_t
            print(f"ingest_s max_bin={params['max_bin']} "
                  f"{time.perf_counter() - t0:.3f} bins {bins.dtype} "
                  f"{bins.numel() * bins.element_size()} bytes, up to "
                  f"{ds._inner.max_num_bin} bins a feature", flush=True)
    reports, boosters = {}, {}
    # --profile: (path, profile's keywords), profiled after phase 4
    profiled = []
    for name, params, iters, must in PATHS:
        reports[name], boosters[name] = main_path(
            lgb, kernels, datasets[params["max_bin"]], X, y, params, iters,
            must)
        print(f"main path {name} " + json.dumps(reports[name]), flush=True)
        profiled.append((name, {}))
    for name, run, kw in (("valid_bag_int8", valid_path,
                           {"evaluate": True}),
                          ("fobj_hilo", fobj_path, {"fobj": logloss_fobj})):
        reports[name], boosters[name] = run(lgb, kernels, datasets[255], X,
                                            y)
        if name == "fobj_hilo":
            reports[name]["hilo_holdout_auc"] = reports["hilo"][
                "holdout_auc"]
        print(f"main path {name} " + json.dumps(reports[name]), flush=True)
        profiled.append((name, kw))
    # the boosting modes, per-node feature sampling and cv
    for name, run in (
            ("goss_int8", goss_path),
            ("bynode_int8", lambda *a: main_path(
                *a, BYNODE_PARAMS, ITERS_INT_VARIANT,
                ("hist_batched_int", "partition_rows", "leaf_group",
                 "leaf_sums"),
                must_not=("fused_hist_scan",))),
            ("dart_hilo", dart_path),
            ("rf_int8", lambda *a: main_path(*a, RF_PARAMS, ITERS,
                                             INT_KERNELS)),
            ("cv_int8", cv_path)):
        reports[name], boosters[name] = run(lgb, kernels, datasets[255], X,
                                            y)
        if name == "dart_hilo":
            reports[name]["drop_walk"] = drop_walk_ms(boosters[name])
        if name == "rf_int8" and not boosters[name]._driver.average_output:
            fail("rf_int8: the model does not average its trees")
        print(f"main path {name} " + json.dumps(reports[name]), flush=True)
        if name != "cv_int8":
            profiled.append((name, {}))
    # the objective zoo: multiclass, ranking and MAE regression
    latent = make_latent(N_TRAIN + N_HOLD, N_FEAT)
    for name, run in (("multiclass_int8", multiclass_path),
                      ("lambdarank_int8", lambdarank_path),
                      ("l1_hilo", l1_path)):
        reports[name], boosters[name] = run(lgb, kernels, datasets[255], X,
                                            latent)
        print(f"main path {name} " + json.dumps(reports[name]), flush=True)
        profiled.append((name, {}))
    # monotone constraints (B2 with bounds), CEGB (B1-int, no B2), forced
    # splits (B1, B3) and deterministic=true (f64 torch ops, B3)
    ds = datasets[255]
    for name, run in (
            ("mono_int8", lambda: mono_path(lgb, kernels, X, y, w)),
            ("cegb_int8", lambda: cegb_path(lgb, kernels, ds, X, y,
                                            boosters["int8"])),
            ("forced_hilo", lambda: forced_path(lgb, kernels, ds, X, y,
                                                forced_file)),
            ("det_f64", lambda: det_path(lgb, kernels, ds, X, y,
                                         reports["hilo"]))):
        reports[name], boosters[name] = run()
        print(f"main path {name} " + json.dumps(reports[name]), flush=True)
        profiled.append((name, {}))
    # file ingest: one pass and two-round with the binary cache (B1-int,
    # B2, B3, leaf sums), then predict from a binned Dataset
    tmp = tempfile.mkdtemp()
    atexit.register(shutil.rmtree, tmp, True)
    t0 = time.perf_counter()
    for name, (report, booster) in file_paths(lgb, kernels, X, y,
                                              tmp).items():
        reports[name], boosters[name] = report, booster
        print(f"main path {name} " + json.dumps(report), flush=True)
    print(f"path_s file_int8+file_two_round_int8 "
          f"{time.perf_counter() - t0:.1f}", flush=True)
    t0 = time.perf_counter()
    reports["predict_dataset"] = predict_dataset_path(
        lgb, ds, boosters["int8"], X, y)
    print("main path predict_dataset "
          + json.dumps(reports["predict_dataset"]), flush=True)
    print(f"path_s predict_dataset {time.perf_counter() - t0:.1f}",
          flush=True)
    # the model utilities: init_model continuation with a snapshot and a
    # rollback (B1-int, B2, B3, leaf sums), refit (leaf_group, the f64
    # leaf sums), the raw-value walker and SHAP (torch ops)
    for name, run in (
            ("continue_int8", lambda: continue_path(lgb, kernels, ds, X, y,
                                                    tmp)),
            ("refit_int8", lambda: (refit_path(lgb, kernels,
                                               boosters["int8"], X, y),
                                    None)),
            ("raw_walk", lambda: (raw_walk_path(lgb, kernels,
                                                boosters["hilo"], X), None)),
            ("contrib_hilo", lambda: (contrib_path(lgb, boosters["hilo"], X),
                                      None))):
        t0 = time.perf_counter()
        reports[name], booster = run()
        if booster is not None:
            boosters[name] = booster
        print(f"main path {name} " + json.dumps(reports[name]), flush=True)
        print(f"path_s {name} {time.perf_counter() - t0:.1f}", flush=True)
    # the sharded learners on the int8 and hilo paths' Dataset, all their
    # shards on this card
    for name, params, must, serial in SHARDED_PATHS:
        t0 = time.perf_counter()
        reports[name], boosters[name] = sharded_path(
            lgb, kernels, ds, X, y, params, must, boosters[serial])
        print(f"main path {name} " + json.dumps(reports[name]), flush=True)
        print(f"path_s {name} {time.perf_counter() - t0:.1f}", flush=True)
    # the sharded learners with monotone constraints (their own Dataset:
    # the constraints are a Dataset parameter), per-node sampling, CEGB,
    # forced splits and deterministic=true
    mono = mono_constraints(w)
    mono_ds = lgb.Dataset(X[:N_TRAIN], label=y[:N_TRAIN], params=dict(
        MONO_PARAMS, monotone_constraints=mono)).construct()
    for name, data, extra in (
            ("data_mono_int8", mono_ds, {"monotone_constraints": mono}),
            ("feature_bynode_int8", ds, None),
            ("voting_cegb_int8", ds, None),
            ("data_forced_hilo", ds, {"forcedsplits_filename": forced_file}),
            ("data_det_f64", ds, None)):
        t0 = time.perf_counter()
        reports[name], boosters[name] = feature_path(
            lgb, kernels, name, data, X, y, boosters, extra)
        print(f"main path {name} " + json.dumps(reports[name]), flush=True)
        print(f"path_s {name} {time.perf_counter() - t0:.1f}", flush=True)
    del mono_ds
    # the two-process paths (and phase 5's two-process check, whose
    # result joins the cross-checks)
    mp_cross = {}
    mp_paths(lgb, ds, X, y, reports, mp_cross)
    del datasets, ds
    # categorical features: columns 22-27 as categories, both modes
    Xc = cat_data(X)
    t0 = time.perf_counter()
    cat_ds = lgb.Dataset(Xc[:N_TRAIN], label=y[:N_TRAIN],
                         categorical_feature=CAT_COLS,
                         params=dict(CAT_PARAMS)).construct()
    torch.cuda.synchronize()
    print(f"ingest_s categorical {time.perf_counter() - t0:.3f}, up to "
          f"{cat_ds._inner.max_num_bin} bins a feature", flush=True)
    for name, params, must, must_not in CAT_PATHS:
        reports[name], boosters[name] = cat_path(
            lgb, kernels, cat_ds, Xc, y, params, must, must_not)
        print(f"main path {name} " + json.dumps(reports[name]), flush=True)
    t0 = time.perf_counter()
    name = "data_cat_int8"
    reports[name], boosters[name] = feature_path(lgb, kernels, name, cat_ds,
                                                 Xc, y, boosters)
    print(f"main path {name} " + json.dumps(reports[name]), flush=True)
    print(f"path_s {name} {time.perf_counter() - t0:.1f}", flush=True)
    del cat_ds, Xc
    # sparse one-hot data: EFB bundles, both precisions, one Dataset
    t0 = time.perf_counter()
    Xe, ye, latent_e = efb_data(N_TRAIN + N_HOLD)
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    efb_ds = lgb.Dataset(Xe[:N_TRAIN], label=ye[:N_TRAIN],
                         params=dict(EFB_PARAMS)).construct()
    torch.cuda.synchronize()
    inner = efb_ds._inner
    print(f"ingest_s efb {time.perf_counter() - t0:.3f} (sketch "
          f"{inner.ingest_s['sketch']:.3f}, binning "
          f"{inner.ingest_s['binning']:.3f}), CSR [{Xe.shape[0]}, "
          f"{Xe.shape[1]}] with {Xe.nnz} stored values made in "
          f"{made_s:.3f} s, {inner.num_features} features, feature bins "
          f"{inner.bins_t.numel() * inner.bins_t.element_size()} bytes "
          "on the card", flush=True)
    for name, params, must, must_not in EFB_PATHS:
        reports[name], boosters[name] = efb_path(
            lgb, kernels, efb_ds, Xe, ye, params, must, must_not)
        print(f"main path {name} " + json.dumps(reports[name]), flush=True)
    # sparse COO storage of the same features (EFB off): B1 on the dense
    # columns, the COO histograms as torch ops
    t0 = time.perf_counter()
    reports["sparse_hilo"], boosters["sparse_hilo"] = sparse_path(
        lgb, kernels, efb_ds, Xe, ye)
    print("main path sparse_hilo " + json.dumps(reports["sparse_hilo"]),
          flush=True)
    print(f"path_s sparse_hilo {time.perf_counter() - t0:.1f}", flush=True)
    t0 = time.perf_counter()
    name = "data_sparse_hilo"
    reports[name], boosters[name] = feature_path(lgb, kernels, name, efb_ds,
                                                 Xe, ye, boosters)
    print(f"main path {name} " + json.dumps(reports[name]), flush=True)
    print(f"path_s {name} {time.perf_counter() - t0:.1f}", flush=True)
    del efb_ds, inner

    gen = torch.Generator(device="cuda").manual_seed(7)
    learners = {k: b._driver.learner for k, b in boosters.items()}
    # (row, the path whose launches it reports)
    kernel_rows = []
    # B1 and B4 with their integer and packed variants, each at random
    # and root operands
    for path in ("hilo", "int8", "flat", "flat_int8", "packed",
                 "packed_int8", "packed_flat", "packed_flat_int8", "wide",
                 "wide_int8", "wide_flat", "wide_flat_int8"):
        check = check_hist_int if path.endswith("int8") else check_hist
        kernel_rows += [(check(learners[path], gen, operands), path)
                        for operands in ("random", "root")]
    kernel_rows += [(check_fused(learners["int8"], gen), "int8"),
                    (check_partition(learners["hilo"], gen), "hilo"),
                    (check_fused(learners["wide_int8"], gen), "wide_int8"),
                    (check_fused(learners["wide_int8"], gen, "root"),
                     "wide_int8"),
                    (check_partition(learners["wide"], gen), "wide"),
                    # B2 and B2-wide with monotone constraints and bounds
                    (check_fused(learners["mono_int8"], gen, "mono"),
                     "mono_int8"),
                    (check_fused(learners["wide_int8"], gen, "mono"),
                     "wide_int8")]
    # the leaf refit's grouping and sums, uniform and with one leaf
    # holding multiclass_int8's largest leaf's rows
    kernel_rows += [(row, "int8") for operands in ("uniform", "skewed")
                    for row in check_leaf_sums(learners["int8"], gen,
                                               operands)]
    # and Booster.refit's f64 instance of the sums, at the same operands
    kernel_rows += [(check_leaf_sums_f64(learners["int8"], gen, operands),
                     "refit_int8") for operands in ("uniform", "skewed")]
    # B1-int and B2 on bagged operands: rows with zero stats, features
    # masked, at the validation path's shapes
    bagged = learners["valid_bag_int8"]
    kernel_rows += [(check_hist_int(bagged, gen, "bagged"),
                     "valid_bag_int8"),
                    (check_fused(bagged, gen, "bagged"), "valid_bag_int8")]
    # and at GOSS operands: the grad, hess and row mask of a sampled tree
    # of the goss_int8 path (about 70% of the rows out, the others kept
    # at random upscaled by 8)
    goss = grower_operands(boosters["goss_int8"])
    kernel_rows += [(check_hist_int(learners["goss_int8"], gen, "goss",
                                    goss), "goss_int8"),
                    (check_fused(learners["goss_int8"], gen, "goss", goss),
                     "goss_int8")]
    # and at the zoo's int8 operands: class 0's softmax gradients of an
    # iteration of multiclass_int8, the host lambdas of lambdarank_int8
    for path, calls in (("multiclass_int8", 5), ("lambdarank_int8", 1)):
        ops = grower_operands(boosters[path], calls)
        tag = path.split("_")[0]
        kernel_rows += [(check_hist_int(learners[path], gen, tag, ops),
                         path),
                        (check_fused(learners[path], gen, tag, ops), path)]
    # B1 and B1-int on the bundle columns of the EFB learners, at random
    # and root operands
    for path, check in (("efb_hilo", check_hist),
                        ("efb_int8", check_hist_int)):
        for operands in ("random", "root"):
            row = check(learners[path], gen, operands)
            row["operands"] = f"bundle columns, {operands}"
            kernel_rows.append((row, path))
    # B1, B1-int, B3 and the leaf sums on one shard's operands
    kernel_rows += check_shards(boosters, gen)
    # the leaf sums' floor on each path that refits: its largest leaf
    mhz = sm_clock_mhz()
    floors = {}
    for path, report in reports.items():
        # (the two-process paths' learners live in their workers)
        if report.get("launches", {}).get("leaf_sums", 0) > 0 \
                and path in learners and learners[path].topology is None:
            learner = learners[path]
            floors[path] = leaf_sums_floor(
                learner.n_pad, learner.params.num_leaves + 1,
                largest_leaf(boosters[path]), mhz)[0]
    print("leaf sums floor_ms by path " + json.dumps(floors), flush=True)
    for row, path in kernel_rows:
        if row["name"] == "leaf_sums":
            row["floor_ms_by_path"] = floors
        row["launches"] = reports[path]["launches"][row["name"]]
        row["launches_per_tree"] = reports[path]["launches_per_tree"][
            row["name"]]
        # the two-process paths' launches of this kernel, each rank's
        row["worker_launches"] = {
            mp: [r[row["name"]] for r in reports[mp]["rank_launches"]]
            for mp, _ in MP_PATHS}
        # and the sharded feature paths'
        row["feature_path_launches"] = {
            fp: reports[fp]["launches"].get(row["name"], 0)
            for fp in FEATURE_PATHS}
        row["path"] = path
        print("kernel " + json.dumps(row), flush=True)
    kernel_rows = [row for row, _ in kernel_rows]
    if "--profile" in sys.argv[1:]:
        # every path is profiled after phase 4: a profile sees fewer of
        # its device events the more launches and profiles the process
        # has made before it (on an H100, phase 4 saw none of 60 launches
        # after the path profiles and the EFB paths), and phase 4's
        # timings need them
        for name, kw in profiled + [(name, {}) for name, *_ in
                                    CAT_PATHS + EFB_PATHS]:
            print(f"profile {name} "
                  + json.dumps(profile(boosters[name], **kw)), flush=True)
    del boosters, learners
    # fault tolerance and device memory (B1-int, B2, B3, leaf sums), after
    # phase 4 and the profiles, which see fewer launches the more the
    # process made before them
    ds = lgb.Dataset(X[:N_TRAIN], label=y[:N_TRAIN],
                     params=dict(PARAMS)).construct()
    fault_paths(lgb, kernels, ds, X, y, tmp, reports)
    del ds
    # the build ledger of every path so far; then the streamed paths,
    # whose plans the ledger holds apart for stream_int8's cross-check
    ledger_sites = {r["site"]: r["programs"] for r in LEDGER.report()}
    t0 = time.perf_counter()
    ledger_cross = stream_paths(lgb, kernels, X, y, reports)
    print(f"path_s stream {time.perf_counter() - t0:.1f}", flush=True)
    for r in LEDGER.report():
        ledger_sites[r["site"]] = ledger_sites.get(r["site"], 0) \
            + r["programs"]
    # the telemetry phase: traced and metered int8, hilo and data paths
    telemetry_paths(lgb, kernels, X, y, reports, tmp)

    cross = cross_check(lgb, X, y, latent)
    cross.update(cross_check_efb(lgb, Xe, ye, latent_e))
    cross.update(cross_check_constraints(lgb, X, w, forced_file))
    t0 = time.perf_counter()
    cross.update(cross_check_utilities(lgb, X))
    print(f"path_s cross_check_utilities {time.perf_counter() - t0:.1f}",
          flush=True)
    t0 = time.perf_counter()
    cross.update(cross_check_storage(lgb, X, w, Xe, latent_e, tmp))
    print(f"path_s cross_check_storage {time.perf_counter() - t0:.1f}",
          flush=True)
    cross.update(cross_check_fault(lgb, X))
    cross.update(mp_cross)
    t0 = time.perf_counter()
    cross.update(cross_check_sharded(lgb, X, y, PATHS[1][1]))
    print(f"path_s cross_check_sharded {time.perf_counter() - t0:.1f}",
          flush=True)
    t0 = time.perf_counter()
    cross.update(cross_check_stream(lgb, X))
    print(f"path_s cross_check_stream {time.perf_counter() - t0:.1f}",
          flush=True)
    print("cross-check " + json.dumps(cross), flush=True)
    print("build ledger " + json.dumps({
        "builds": LEDGER.builds(), "plans_by_site": ledger_sites,
        "cross_check": ledger_cross}), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # B1, B4 and their integer and packed variants have two rows: random
    # operands, then the root's; B1-int and B2 two more, bagged and GOSS
    # operands
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys},
         **({"operands": r["operands"]} if "operands" in r else {}),
         "worker_launches": r["worker_launches"],
         "feature_path_launches": r["feature_path_launches"]}
        for r in kernel_rows]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mp-worker"]:
        mp_worker(sys.argv[2])
    else:
        main()
