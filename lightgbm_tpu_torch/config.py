"""Typed training configuration with LightGBM-compatible parameter names/aliases.

A copy of `lightgbm_tpu/config.py` (same names, aliases and defaults, so
one params dict drives both packages), plus the port's device rule
(`resolve_device`).  The port keeps its own copy because importing
`lightgbm_tpu` pulls in JAX.

The reference keeps a ~180-field `Config` struct whose alias table and setters are
code-generated from doc comments (reference include/LightGBM/config.h:41-79 and
src/config_auto.cpp:10).  Here the registry is a plain Python table: each entry is
(canonical name, type, default, aliases).  Parameters flow as `key=value` strings
through every layer, as in the reference (`Config::Str2Map`, config.h:41).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Parameter registry: canonical -> (type, default, aliases)
# Types: "int", "float", "bool", "str", "int_list", "float_list", "str_list"
# Mirrors reference include/LightGBM/config.h fields + config_auto.cpp alias table.
# ---------------------------------------------------------------------------

_P: Dict[str, Tuple[str, Any, Tuple[str, ...]]] = {
    # --- core ---
    "config": ("str", "", ("config_file",)),
    "task": ("str", "train", ("task_type",)),
    "objective": ("str", "regression", ("objective_type", "app", "application")),
    "boosting": ("str", "gbdt", ("boosting_type", "boost")),
    "data": ("str", "", ("train", "train_data", "train_data_file", "data_filename")),
    "valid": ("str_list", [], ("test", "valid_data", "valid_data_file", "test_data",
                               "test_data_file", "valid_filenames")),
    "num_iterations": ("int", 100, ("num_iteration", "n_iter", "num_tree", "num_trees",
                                    "num_round", "num_rounds", "num_boost_round",
                                    "n_estimators")),
    "learning_rate": ("float", 0.1, ("shrinkage_rate", "eta")),
    "num_leaves": ("int", 31, ("num_leaf", "max_leaves", "max_leaf")),
    "tree_learner": ("str", "serial", ("tree", "tree_type", "tree_learner_type")),
    "num_threads": ("int", 0, ("num_thread", "nthread", "nthreads", "n_jobs")),
    "device_type": ("str", "tpu", ("device",)),
    "seed": ("int", 0, ("random_seed", "random_state")),
    # --- learning control ---
    "max_depth": ("int", -1, ()),
    "min_data_in_leaf": ("int", 20, ("min_data_per_leaf", "min_data", "min_child_samples")),
    "min_sum_hessian_in_leaf": ("float", 1e-3, ("min_sum_hessian_per_leaf", "min_sum_hessian",
                                                "min_hessian", "min_child_weight")),
    "bagging_fraction": ("float", 1.0, ("sub_row", "subsample", "bagging")),
    "pos_bagging_fraction": ("float", 1.0, ("pos_sub_row", "pos_subsample", "pos_bagging")),
    "neg_bagging_fraction": ("float", 1.0, ("neg_sub_row", "neg_subsample", "neg_bagging")),
    "bagging_freq": ("int", 0, ("subsample_freq",)),
    "bagging_seed": ("int", 3, ("bagging_fraction_seed",)),
    "feature_fraction": ("float", 1.0, ("sub_feature", "colsample_bytree")),
    "feature_fraction_bynode": ("float", 1.0, ("sub_feature_bynode", "colsample_bynode")),
    "feature_fraction_seed": ("int", 2, ()),
    "early_stopping_round": ("int", 0, ("early_stopping_rounds", "early_stopping",
                                        "n_iter_no_change")),
    "first_metric_only": ("bool", False, ()),
    "max_delta_step": ("float", 0.0, ("max_tree_output", "max_leaf_output")),
    "lambda_l1": ("float", 0.0, ("reg_alpha",)),
    "lambda_l2": ("float", 0.0, ("reg_lambda", "lambda")),
    "min_gain_to_split": ("float", 0.0, ("min_split_gain",)),
    "drop_rate": ("float", 0.1, ("rate_drop",)),
    "max_drop": ("int", 50, ()),
    "skip_drop": ("float", 0.5, ()),
    "xgboost_dart_mode": ("bool", False, ()),
    "uniform_drop": ("bool", False, ()),
    "drop_seed": ("int", 4, ()),
    "top_rate": ("float", 0.2, ()),
    "other_rate": ("float", 0.1, ()),
    "min_data_per_group": ("int", 100, ()),
    "max_cat_threshold": ("int", 32, ()),
    "cat_l2": ("float", 10.0, ()),
    "cat_smooth": ("float", 10.0, ()),
    "max_cat_to_onehot": ("int", 4, ()),
    "top_k": ("int", 20, ("topk",)),
    "monotone_constraints": ("int_list", [], ("mc", "monotone_constraint")),
    "feature_contri": ("float_list", [], ("feature_contrib", "fc", "fp", "feature_penalty")),
    "forcedsplits_filename": ("str", "", ("fs", "forced_splits_filename", "forced_splits_file",
                                          "forced_splits")),
    "forcedbins_filename": ("str", "", ()),
    "refit_decay_rate": ("float", 0.9, ()),
    "cegb_tradeoff": ("float", 1.0, ()),
    "cegb_penalty_split": ("float", 0.0, ()),
    "cegb_penalty_feature_lazy": ("float_list", [], ()),
    "cegb_penalty_feature_coupled": ("float_list", [], ()),
    "verbosity": ("int", 1, ("verbose",)),
    "snapshot_freq": ("int", -1, ("save_period",)),
    # --- IO / dataset ---
    "max_bin": ("int", 255, ()),
    "max_bin_by_feature": ("int_list", [], ()),
    "min_data_in_bin": ("int", 3, ()),
    "bin_construct_sample_cnt": ("int", 200000, ("subsample_for_bin",)),
    "histogram_pool_size": ("float", -1.0, ("hist_pool_size",)),
    "data_random_seed": ("int", 1, ("data_seed",)),
    "output_model": ("str", "LightGBM_model.txt", ("model_output", "model_out")),
    "input_model": ("str", "", ("model_input", "model_in")),
    # task=convert_model: if-else C++ codegen of input_model (codegen.py)
    "convert_model": ("str", "gbdt_prediction.cpp", ("convert_model_file",)),
    "convert_model_language": ("str", "cpp", ()),
    "output_result": ("str", "LightGBM_predict_result.txt",
                      ("predict_result", "prediction_result", "predict_name",
                       "prediction_name", "pred_name", "name_pred")),
    "initscore_filename": ("str", "", ("init_score_filename", "init_score_file",
                                       "init_score", "input_init_score")),
    "valid_data_initscores": ("str_list", [], ("valid_data_init_scores",
                                               "valid_init_score_file", "valid_init_score")),
    # compatibility alias for the topology's partitioned-rows mode: rows
    # are already split per process, so ingest skips the global scatter
    # and sum-type metrics reduce across hosts.  Internally this is the
    # partitioned_rows flag of the (hosts, data, feature) topology —
    # consumers key on topology.rows_partitioned(), never on this bool
    "pre_partition": ("bool", False, ("is_pre_partition",)),
    "enable_bundle": ("bool", True, ("is_enable_bundle", "bundle")),
    "max_conflict_rate": ("float", 0.0, ()),
    "is_enable_sparse": ("bool", True, ("is_sparse", "enable_sparse", "sparse")),
    "sparse_threshold": ("float", 0.8, ()),
    "use_missing": ("bool", True, ()),
    "zero_as_missing": ("bool", False, ()),
    "two_round": ("bool", False, ("two_round_loading", "use_two_round_loading")),
    "save_binary": ("bool", False, ("is_save_binary", "is_save_binary_file")),
    "header": ("bool", False, ("has_header",)),
    "label_column": ("str", "", ("label",)),
    "weight_column": ("str", "", ("weight",)),
    "group_column": ("str", "", ("group", "group_id", "query_column", "query", "query_id")),
    "ignore_column": ("str", "", ("ignore_feature", "blacklist")),
    "categorical_feature": ("str", "", ("cat_feature", "categorical_column", "cat_column")),
    # --- predict ---
    "predict_raw_score": ("bool", False, ("is_predict_raw_score", "predict_rawscore",
                                          "raw_score")),
    "predict_leaf_index": ("bool", False, ("is_predict_leaf_index", "leaf_index")),
    "predict_contrib": ("bool", False, ("is_predict_contrib", "contrib")),
    "num_iteration_predict": ("int", -1, ()),
    "predict_disable_shape_check": ("bool", False, ()),
    "pred_early_stop": ("bool", False, ()),
    "pred_early_stop_freq": ("int", 10, ()),
    "pred_early_stop_margin": ("float", 10.0, ()),
    # --- serving (lightgbm_tpu/serving: registry + micro-batched inference) ---
    # rows the micro-batcher coalesces into one device predict; also the
    # largest row bucket the registry warmup pre-compiles
    "serving_max_batch_rows": ("int", 4096, ()),
    # how long the batcher holds an under-filled batch open for
    # coalescing before dispatching it anyway
    "serving_max_wait_ms": ("float", 2.0, ()),
    # admission control: total rows allowed in the queue; requests past
    # it are shed immediately with ServingQueueFull (HTTP 503)
    "serving_queue_rows": ("int", 65536, ()),
    # per-request wait budget; expiry raises ServingTimeout (HTTP 504)
    "serving_timeout_ms": ("float", 10000.0, ()),
    # model registry capacity: least-recently-used non-current versions
    # are evicted past this many resident models
    "serving_max_models": ("int", 4, ()),
    # pre-compile every row-bucket shape at load time so no request size
    # ever hits a cold jit compile
    "serving_warmup": ("bool", True, ()),
    # registry name the CLI `serve` task loads input_model under
    "serving_model_name": ("str", "default", ()),
    # HTTP/JSON endpoint bind address for `python -m lightgbm_tpu serve`
    "serving_host": ("str", "127.0.0.1", ()),
    "serving_port": ("int", 18080, ()),
    # rolling latency samples kept for the p50/p95/p99 stats
    "serving_stats_window": ("int", 4096, ()),
    # circuit breaker on the device predict path: this many consecutive
    # device failures OPEN the breaker (requests go straight to the
    # native walker, no device attempts)
    "serving_breaker_failures": ("int", 3, ()),
    # how long an OPEN breaker waits before letting ONE half-open probe
    # try the device path again (success closes it, failure re-opens)
    "serving_breaker_cooldown_ms": ("float", 2000.0, ()),
    # --- serving: adaptive admission / deadlines / drain (ISSUE 11) ---
    # latency SLO target: the admission controller AIMDs its admitted-
    # rows level so the projected request latency (recent queue-wait
    # p99 + dispatch p95, from the PR-10 histograms) stays inside it,
    # and the batcher's coalescing window narrows as load approaches it
    "serving_slo_ms": ("float", 50.0, ()),
    # adaptive admission on/off; off keeps only the hard
    # serving_queue_rows wall (the pre-ISSUE-11 behavior)
    "serving_admission": ("bool", True, ()),
    # how often the controller re-reads the histograms and moves the
    # level/window (lazy, on the admit path; no timer thread)
    "serving_aimd_interval_ms": ("float", 100.0, ()),
    # additive increase per interval while latency is comfortable
    "serving_aimd_step_rows": ("int", 512, ()),
    # multiplicative decrease when the projection exceeds the SLO
    "serving_aimd_backoff": ("float", 0.5, ()),
    # floor of the ADAPTIVE batch window (serving_max_wait_ms is its
    # ceiling): under SLO pressure batches dispatch after at most this
    "serving_min_wait_ms": ("float", 0.0, ()),
    # Retry-After carried by 429/503 shed responses
    "serving_retry_after_ms": ("float", 1000.0, ()),
    # dispatch watchdog: a device runner that neither returns nor
    # raises within this wall is abandoned, the batch fails over to the
    # native walker, and the entry's breaker records the failure
    # (0 = off: a wedged device hangs the dispatch worker, pre-ISSUE-11)
    "serving_dispatch_timeout_ms": ("float", 30000.0, ()),
    # default flush budget of the drain lifecycle (POST /drain, SIGTERM)
    "serving_drain_timeout_ms": ("float", 10000.0, ()),
    # --- serving: memory pressure (ISSUE 15) ---
    # serving-registry HBM budget in bytes (packed model tables +
    # launch scratch): a load whose predicted bytes would not fit first
    # evicts cold LRU models, then REFUSES with a structured 507
    # (ServingMemoryExhausted) instead of warming into a device crash.
    # 0 = inherit the training budget resolution (tpu_hbm_budget_bytes
    # / tpu_hbm_budget_frac x device capacity; unenforced on backends
    # that report no memory stats)
    "serving_hbm_budget_bytes": ("int", 0, ()),
    # sustained-pressure eviction threshold: once resident model bytes
    # exceed this fraction of the serving budget, cold (non-current)
    # LRU models are evicted ahead of demand so a dispatch never has
    # to OOM first
    "serving_hbm_pressure_frac": ("float", 0.85, ()),
    # --- serving: fleet-scale dispatch (ISSUE 19) ---
    # devices each model's packed forest replicates across (the batcher
    # grows one dispatch worker per device, least-loaded routed).
    # 0 = auto: every local device on accelerator backends, ONE on CPU
    # hosts (forced virtual CPU devices share the same physical cores —
    # replication there multiplies warmup compiles without adding
    # throughput).  Capped at the local device count
    "serving_devices": ("int", 0, ()),
    # packed-table storage precision for serving replicas:
    #   f32   — byte-identical to the training pack (default)
    #   bf16  — leaf values stored bfloat16 (identical decision path;
    #           per-leaf value error <= 2^-8 relative)
    #   int16 — node tables AND leaf values int16; leaves dequantize
    #           per-tree with an f32 scale (exact decision-path parity:
    #           bin-space thresholds are small ints that fit int16)
    "serving_table_precision": ("str", "f32", ()),
    # AOT executable cache directory: every bucket-ladder launch shape
    # is jit-lowered, compiled and serialized here at load time, so a
    # cold replica (process restart, continual-learning promotion, LRU
    # re-load) serves its first batch with ZERO new compiled programs.
    # "" = derive `<tpu_compile_cache_dir>/serving_aot` when the
    # persistent compile cache is configured, else AOT serving is off
    "serving_aot_cache_dir": ("str", "", ()),
    # --- serving: model & data health (ISSUE 14) ---
    # rows per predict batch the drift monitor stride-samples into its
    # accumulator (models carrying a tpu_feature_profile trailer only).
    # The tap is one bounded row copy on the dispatch path; binning,
    # PSI/JS and the score histogram run lazily at scrape time
    # (GET /drift, GET /metrics).  0 disables drift monitoring
    "serving_drift_sample_rows": ("int", 256, ()),
    # per-feature PSI threshold: crossing it records a flight-recorder
    # `psi_warn` event, a Log.warning, and the drift_warnings counter
    # (conventional PSI reading: <0.1 stable, 0.1-0.25 moderate,
    # >0.25 major shift)
    "serving_drift_psi_warn": ("float", 0.25, ()),
    # --- memory pressure (utils/membudget.py, ISSUE 15) ---
    # explicit device-memory budget in bytes the preflight planner and
    # the OOM recovery ladder enforce; 0 = auto (device capacity from
    # memory_stats()['bytes_limit'] scaled by tpu_hbm_budget_frac;
    # no enforcement on backends that report no memory stats).  An
    # explicit value is honored on EVERY backend, so budget behavior is
    # testable on CPU
    "tpu_hbm_budget_bytes": ("int", 0, ()),
    # fraction of reported device capacity the auto budget claims
    "tpu_hbm_budget_frac": ("float", 0.9, ()),
    # preflight policy before iteration 0: predict peak HBM from the
    # closed-form buffer models (binned matrix, [L, G/P, B, 3]
    # histogram pool, stats planes, scores, packed forest, chunk
    # scratch) and compare against the budget.
    #   off     - no preflight
    #   warn    - log the itemized over-budget plan and proceed
    #   raise   - refuse with the named, itemized plan
    #   degrade - auto-apply bitwise-invisible degradation-ladder steps
    #             (chunk shrink -> scatter aggregation -> fine bucket
    #             policy) until the plan fits, refusing if it never does
    "tpu_hbm_preflight": ("str", "warn", ()),
    # mid-train OOM recovery: a classified RESOURCE_EXHAUSTED at a
    # guarded device site rolls the iteration back (the PR-7 atomic
    # rollback), descends ONE deterministic, logged degradation-ladder
    # step, and retries; every step is bitwise-invisible, so the
    # settled run's model file is byte-identical to an undisturbed run
    # at the settled config.  Ladder exhaustion raises a structured
    # MemoryLadderExhausted after the final checkpoint flush +
    # blackbox dump.  false = classified OOMs propagate immediately
    # (multi-host process groups always propagate: a one-sided retry
    # would desynchronize the collective streams)
    "tpu_oom_recovery": ("bool", True, ()),
    # --- out-of-core streaming (ops/stream.py, ISSUE 16) ---
    # training layout: resident keeps the binned matrix device-resident
    # (the classic path); streamed keeps it host-resident and streams
    # fixed-size row blocks through double-buffered device slots each
    # iteration, so rows x features stops being capped by HBM.  auto
    # lets membudget.plan_training pick: resident when the itemized
    # plan fits the budget, streamed when the binned matrix pushes it
    # over.  int8/int16 streamed models are BYTE-IDENTICAL to resident
    # (int32 histogram sums are associative across blocks)
    "tpu_stream_mode": ("str", "auto", ()),
    # rows per streamed block (rounded to a multiple of the device
    # histogram scan block); 0 = auto (a block sized so two device
    # slots fit comfortably under ~1/8 of the HBM budget, floored at
    # 64k rows)
    "tpu_stream_block_rows": ("int", 0, ()),
    # overlap block i+1's H2D copy with block i's histogram contraction
    # via two device slots; false = one slot, fully serial copies
    # (debugging / host-memory ceiling)
    "tpu_stream_double_buffer": ("bool", True, ()),
    # GOSS-style gradient-based block sampling for the streamed layout:
    # keep the top fraction of blocks by sum(|grad*hess|) every
    # iteration...
    "tpu_stream_goss_top": ("float", 0.0, ()),
    # ...plus this fraction of the remaining blocks, drawn by a PCG
    # hash keyed on each block's first GLOBAL row index (invariant to
    # padding and shard count) and amplified by the standard GOSS
    # (1-top)/other weight.  Both 0.0 = stream every block.  Block
    # sampling changes which rows build each tree, so it trades the
    # bitwise-vs-resident guarantee for fewer H2D copies per iteration
    "tpu_stream_goss_other": ("float", 0.0, ()),
    # --- fault tolerance (utils/checkpoint.py + numeric guardrails) ---
    # atomic training checkpoints: bundle directory (empty = off).  Each
    # checkpoint holds the model string (with its bin-mapper trailer),
    # PRNG stream states, and the f32 score buffers, written via
    # temp-file + fsync + rename with a CRC'd manifest; resume with
    # lgb.train(..., resume=True) is BIT-IDENTICAL to an uninterrupted
    # run for quantized (int8/int16) precisions at any shard count
    "tpu_checkpoint_dir": ("str", "", ()),
    # boosting iterations between checkpoints
    "tpu_checkpoint_interval": ("int", 1, ()),
    # newest valid checkpoints retained (older ones are deleted)
    "tpu_checkpoint_keep": ("int", 3, ()),
    # collective watchdog (parallel/collective.py): seconds a host-level
    # collective (metric sync, distributed bin finding, multihost
    # rendezvous, checkpoint barrier) may block before a structured
    # CollectiveTimeout rolls the iteration back and flushes a final
    # checkpoint — a hung peer degrades to a usable booster instead of
    # silently hanging the group.  The setting is PROCESS-GLOBAL (the
    # reference's Network config): -1 (default) leaves the current
    # process policy untouched, 0 explicitly disables the deadline
    # (block forever, the pre-watchdog behavior), >0 arms it.  Fault
    # injection and retry stay live either way
    "tpu_collective_timeout_s": ("float", -1.0, ()),
    # bounded retries (exponential backoff) when a collective RAISES a
    # transient transport error; timeouts and host drops never retry
    # (after a missed deadline the group's collective streams are no
    # longer aligned).  Process-global like the timeout: -1 leaves the
    # current policy, 0 disables retry
    "tpu_collective_retries": ("int", -1, ()),
    # elastic resume: allow resuming a checkpoint taken at a different
    # shard/host topology (P data shards -> P', including 1).  Scores
    # are global f32 buffers and quantized rounding keys on the GLOBAL
    # row index, so int8/int16 resumes stay bit-identical across
    # topology changes; false refuses any topology delta
    "tpu_resume_elastic": ("bool", True, ()),
    # raise (instead of warn-and-proceed) when resume params differ
    # from the checkpointed run's beyond the topology set; the
    # differing keys are named either way
    "tpu_resume_strict": ("bool", False, ()),
    # numeric guardrails: per-iteration isfinite check on the updated
    # train scores plus an int32 histogram-headroom sentinel for
    # quantized precisions.  off = no checks (default; keeps the train
    # loop fully async); warn = log and continue; raise = roll the
    # poisoned iteration back and raise; skip = roll it back, re-bag,
    # and keep training (drops the iteration)
    "tpu_guard_numerics": ("str", "off", ()),
    # --- observability (lightgbm_tpu/obs: metrics registry + span tracer) ---
    # process-global telemetry mode.  "" (the registry default) means
    # UNSET — a booster/dataset constructed without the param never
    # disturbs a policy another layer armed (same convention as
    # tpu_collective_timeout_s); the effective initial mode is "off"
    # unless LIGHTGBM_TPU_TELEMETRY is set.  off = no instrumentation
    # (the train loop pays one flag check per site); metrics = phase
    # walls, counters and fixed-bucket histograms flow into the
    # process-global registry (scraped as Prometheus text via the
    # serving GET /metrics); trace = metrics PLUS nested structured
    # spans (per-iteration train lifecycle, collectives, checkpoints,
    # serving dispatch) exported as Chrome-trace-event JSON that loads
    # in Perfetto, mirrored into jax.profiler.TraceAnnotation so the
    # same names appear inside xprof device traces
    "tpu_telemetry": ("str", "", ()),
    # span/event sink for tpu_telemetry=trace: each host streams
    # events-host<k>.jsonl incrementally (a dying run keeps everything
    # up to the death) and train() dumps trace-host<k>.json on exit;
    # merge a multihost run's streams with tools/trace_merge.py.
    # "" = unset (in-memory span buffer only)
    "tpu_trace_dir": ("str", "", ()),
    # raw samples kept per metrics-registry histogram child (the bench's
    # repeat readback and the serving admission controller's
    # recent-window SLO projection both read this ring).  Readers that
    # must not silently under-count ask
    # histogram_samples(with_truncated=True).  0 = leave the process
    # default (256) untouched
    "tpu_obs_ring_samples": ("int", 0, ()),
    # flight-recorder depth: the last N spans / events / watchdog-guard-
    # breaker transitions kept in the ALWAYS-ON process-global ring
    # (obs/flightrecorder.py) and dumped to blackbox-host<k>.json on
    # unhandled exception, CollectiveTimeout, SIGTERM, or a guard raise.
    # 0 = leave the process default (512) untouched
    "tpu_obs_blackbox_events": ("int", 0, ()),
    # where blackbox-host<k>.json dumps land.  "" = unset: the
    # LIGHTGBM_TPU_BLACKBOX_DIR env var, then tpu_trace_dir, then the
    # working directory
    "tpu_obs_blackbox_dir": ("str", "", ()),
    # capture the training reference profile (per-feature bin occupancy
    # from BinMapper.cnt_in_bin, NaN/zero fractions, label stats, raw-
    # score histogram) and write it as the tpu_feature_profile: model-
    # string trailer — the reference every serving drift monitor and
    # model_report compares against.  false = no trailer (a loaded
    # model's existing profile still round-trips)
    "tpu_profile_capture": ("bool", True, ()),
    # bins of the profile's raw-score histogram (equal-width over the
    # end-of-training score range)
    "tpu_profile_score_bins": ("int", 32, ()),
    # --- continual learning (lightgbm_tpu/continual, ISSUE 17) ---
    # bounded retention window of the incremental ingest buffer: once
    # buffered rows exceed it, the OLDEST binned blocks are evicted
    # (the buffer is a sliding window over the live stream, not an
    # unbounded accumulator)
    "tpu_continual_buffer_rows": ("int", 262144, ()),
    # row-count retrain trigger: a retrain fires once this many fresh
    # rows have accumulated since the last one (0 = off)
    "tpu_continual_min_rows": ("int", 4096, ()),
    # wall-clock retrain cadence in seconds (0 = off)
    "tpu_continual_interval_s": ("float", 0.0, ()),
    # retrain policy: auto (drift trigger -> boost-K / re-sketch
    # escalation, row-count & cadence triggers -> leaf refit), or pin
    # one of refit | boost | resketch
    "tpu_continual_policy": ("str", "auto", ()),
    # K extra boosting rounds per warm-continue (init_model) retrain
    "tpu_continual_boost_rounds": ("int", 10, ()),
    # leaf-refit blend: new leaf = decay*old + (1-decay)*refit
    "tpu_continual_refit_decay": ("float", 0.9, ()),
    # shadow gate tolerance: promote iff candidate_loss <=
    # live_loss * (1 + tolerance) on the mirrored sample
    "tpu_continual_tolerance": ("float", 0.0, ()),
    # GOSS-style freshness weighting of buffered blocks in the boost-K
    # training set: a block's weight decays by this factor per
    # RETENTION-WINDOW age step (newest block = 1.0); 1.0 = unweighted
    "tpu_continual_fresh_decay": ("float", 0.7, ()),
    # re-sketch escalation threshold: when the drift trigger fires AND
    # at least this fraction of buffered rows landed in a feature's
    # overflow/tail bin, the binning itself is stale — the policy
    # escalates to a full re-sketch retrain instead of reusing the
    # frozen mappers
    "tpu_continual_resketch_tail_frac": ("float", 0.25, ()),
    # rows of mirrored live traffic the shadow gate scores a candidate
    # on before the promote/refuse verdict
    "tpu_continual_shadow_rows": ("int", 2048, ()),
    # controller state + mid-retrain checkpoints (PR-7 manager) land
    # here so a killed controller resumes; "" = stateless (no resume)
    "tpu_continual_dir": ("str", "", ()),
    # seconds between controller trigger polls in the run_forever loop
    "tpu_continual_poll_s": ("float", 10.0, ()),
    # --- objective ---
    "num_class": ("int", 1, ("num_classes",)),
    "is_unbalance": ("bool", False, ("unbalance", "unbalanced_sets")),
    "scale_pos_weight": ("float", 1.0, ()),
    "sigmoid": ("float", 1.0, ()),
    "boost_from_average": ("bool", True, ()),
    "reg_sqrt": ("bool", False, ()),
    "alpha": ("float", 0.9, ()),
    "fair_c": ("float", 1.0, ()),
    "poisson_max_delta_step": ("float", 0.7, ()),
    "tweedie_variance_power": ("float", 1.5, ()),
    "max_position": ("int", 20, ()),
    "lambdamart_norm": ("bool", True, ()),
    "label_gain": ("float_list", [], ()),
    "objective_seed": ("int", 5, ()),
    # --- metric ---
    "metric": ("str_list", [], ("metrics", "metric_types")),
    "metric_freq": ("int", 1, ("output_freq",)),
    "is_provide_training_metric": ("bool", False, ("training_metric", "is_training_metric",
                                                   "train_metric")),
    "eval_at": ("int_list", [1, 2, 3, 4, 5], ("ndcg_eval_at", "ndcg_at", "map_eval_at",
                                              "map_at")),
    "multi_error_top_k": ("int", 1, ()),
    "auc_mu_weights": ("float_list", [], ()),
    # --- network (mesh) ---
    "num_machines": ("int", 1, ("num_machine",)),
    "local_listen_port": ("int", 12400, ("local_port", "port")),
    "time_out": ("int", 120, ()),
    "machine_list_filename": ("str", "", ("machine_list_file", "machine_list", "mlist")),
    "machines": ("str", "", ("workers", "nodes")),
    # --- device (TPU analog of the reference's GPU block) ---
    "gpu_platform_id": ("int", -1, ()),
    "gpu_device_id": ("int", -1, ()),
    "gpu_use_dp": ("bool", False, ()),
    # TPU-specific: precision of histogram matmul accumulation.
    #   "hilo"   - bf16 hi/lo split stats, f32 accumulate (default; ~f32 accurate, MXU speed)
    #   "bf16"   - single bf16 stats pass (fastest, lossy)
    #   "f32"    - full f32 dots (XLA 'highest' precision)
    #   "int16"/"int8" - QUANTIZED gradients: per-iteration stochastic
    #   rounding onto an integer grid, narrow-int MXU dots with exact
    #   int32 accumulation.  Data-parallel split decisions are bit-
    #   identical for any shard count (int32 psum is associative) and
    #   the stats operand is 2-4x narrower than hilo's
    "tpu_hist_precision": ("str", "hilo", ("hist_precision",)),
    # gradient-grid rounding under tpu_hist_precision=int16|int8:
    # "stochastic" (unbiased, deterministic given `seed`, invariant to
    # row sharding) or "nearest"
    "tpu_quant_round": ("str", "stochastic", ()),
    # quantized training only: recompute final leaf outputs from the true
    # f32 grad/hess sums over each leaf's rows (split decisions stay
    # integer-exact; leaf values regain float precision — LightGBM
    # quantized training's renew-leaf).  Turn off for strictly bitwise
    # cross-shard model files
    "tpu_quant_refit_leaves": ("bool", True, ()),
    # persistent XLA compilation cache directory (empty = off): repeat
    # runs of same-shaped programs skip the cold compile tail.  Applied
    # at first device use (jax_compilation_cache_dir); CPU-destined
    # processes get a host-fingerprinted subdir (utils/backend.py)
    "tpu_compile_cache_dir": ("str", "", ()),
    # persisted perf autotuning (utils/autotune.py): off | load | tune.
    #   off  - every "auto" resolves from the built-in heuristics
    #   load - resolve "auto" (hist impl x block, hist_agg) from the
    #          measured profile file when a matching (backend, topology,
    #          shape-bucket) entry exists; a profile recorded on a
    #          DIFFERENT platform or device count is refused loudly
    #          (AutotuneStaleProfile), never silently applied
    #   tune - run the measurement sweep for this dataset's shape bucket
    #          first (tools/perf_probe.py's hist sweep), persist the
    #          winners, then resolve like load.  `perf_probe tune` runs
    #          the same sweep standalone
    "tpu_autotune": ("str", "off", ()),
    # autotune profile path; empty = autotune_profile.json beside the
    # persistent XLA compile cache (tpu_compile_cache_dir), or the
    # in-repo .lgbtpu_autotune.json when no cache dir is set
    "tpu_autotune_profile": ("str", "", ()),
    # rows per histogram scan block (device-side); 0 = auto (256 for the
    # pallas backend — its VMEM-resident accumulator wants short blocks —
    # 16384 for the xla scan, tuned for HBM streaming)
    "tpu_block_rows": ("int", 0, ()),
    # leaves split per grower round: >1 batches histogram work onto the MXU
    # (K*5 stat lanes -> 128-lane systolic tiles); 1 = strict reference
    # best-first split order for parity runs; 0 = auto (1 below 32 leaves,
    # num_leaves/16 up to 192, then 25 so K*5 fills one 128-lane tile):
    # batching stays a small fraction of the frontier, so the split order
    # tracks strict best-first closely even while histogramming K leaves
    # per pass
    "tpu_split_batch": ("int", 0, ()),
    # batched-histogram backend: auto | xla | pallas | pallas2 | fused.
    # auto picks the hardware-validated pallas kernel on TPU when its VMEM
    # working set fits (measured 1.9x over the xla scan on Higgs-1M: the
    # one-hot never round-trips to HBM), else xla.  pallas2 = per-feature
    # one-hot variant running 2-8k-row blocks.  fused = the grow
    # megakernel (ops/fused.py): pallas2's accumulator PLUS in-VMEM
    # sibling subtraction and the split gain scan, emitting per-feature
    # best-split records so split search never leaves the device.  The
    # in-kernel scan engages on serial quantized (int8/int16) plain dense
    # training — bit-identical models to the unfused path — and degrades
    # to pallas2 + device select() everywhere else.  auto promotes
    # int8/int16 to fused on TPU only after the runtime validation probe
    # (fused.fused_scan_ok) passes; a Mosaic failure falls back LOUDLY
    "tpu_hist_impl": ("str", "auto", ()),
    # data-axis histogram aggregation (tree_learner=data / voting /
    # data_feature): psum | scatter | auto.
    #   psum    - every shard receives the full aggregated [K, F, B, 3]
    #             histograms (XLA lowers to reduce-scatter + all-gather)
    #             and repeats the whole split search P times
    #   scatter - stop after the reduce-scatter (lax.psum_scatter): each
    #             shard keeps only its F/P feature slice of the
    #             aggregated histograms and pool, searches just that
    #             slice, and the global winner is ONE tiny best-split
    #             record (all_gather + shared deterministic tie-break) —
    #             the reference's Network::ReduceScatter +
    #             SyncUpGlobalBestSplit (data_parallel_tree_learner.cpp:
    #             149-163).  ~2× less ICI receive volume, ~P× less
    #             per-shard histogram-pool HBM, and the search runs once
    #             instead of P times; int8/int16 decisions stay
    #             bit-identical to psum at every shard count.  In voting
    #             mode the voted [k, B, 3] aggregation scatters instead.
    #   auto    - scatter whenever the data axis spans >1 device
    "tpu_hist_agg": ("str", "auto", ()),
    # f64 histogram accumulation everywhere (requires x64): serial and
    # data-parallel split decisions become reduction-order independent,
    # like the reference f64 HistogramBinEntry (bin.h:33-40)
    "deterministic": ("bool", False, ()),
    # only batch leaves whose gain >= alpha * the round's best gain (near
    # ties); keeps batched split order close to strict best-first
    "tpu_split_batch_alpha": ("float", 0.0, ()),
    # row-partition lowering: select | vselect | gather | kernel
    # (ops/grower.py GrowerParams.partition_impl; honored by every tree
    # learner).  vselect fuses the K unrolled select passes into one
    # [K, n] block — fewer program points, but its CATEGORICAL path
    # gathers per-row from a tiny table (the pattern select avoids);
    # prefer select on categorical-heavy data until vselect is
    # hardware-timed there.  kernel = the pallas row->leaf partition
    # (ops/fused.py partition_rows): vselect's exact integer math as one
    # VMEM pass over the row blocks instead of a separate XLA program
    # point — plain dense numerical columns only (no categoricals, EFB,
    # sparse storage, or 4-bit packing)
    "tpu_partition_impl": ("str", "select", ()),
    # frontier ramp: unrolled K'=1,2,4,... pre-rounds before the full-K
    # loop (bit-identical trees, removes early rounds' dead-slot MXU
    # work; see GrowerParams.ramp).  On v5e Higgs-1M it is worth ~10%
    # (docs/PERF_NOTES.md round-3 sweep: 3.14 vs 2.84 it/s at
    # pallas2/8192/K=25)
    "tpu_ramp": ("bool", True, ()),
    # feature shards in the 2-D tree_learner=data_feature mesh: the
    # num_machines devices factor as (num_machines/f, f) over
    # ('data', 'feature'); 0 = auto (2).  The analog of the reference's
    # device x parallel template nesting (parallel_tree_learner.h:25-187)
    "tpu_feature_shards": ("int", 0, ()),
    # hosts axis of the (hosts, data, feature) topology
    # (parallel/topology.py) — the process/DCN tier every row-axis
    # collective also reduces over.  0 = auto (the live jax process
    # count; the only valid setting on real multi-host meshes).  A
    # positive value pins the axis on a SINGLE process, laying the local
    # devices out exactly as that many hosts would — the simulated
    # multi-host grid the (hosts x devices) bitwise tests sweep
    "tpu_topology_hosts": ("int", 0, ()),
    # compile-cache shape policy: quantize the padded (rows, features)
    # axes so at most this many distinct shapes exist per power-of-2
    # octave — new datasets of similar size reuse cached XLA programs
    # instead of paying the cold remote compile.  Worst-case pad waste
    # is 2/buckets (~6% at the default 32).  0 = exact block-multiple
    # padding (maximum throughput; bench.py pins this)
    "tpu_shape_buckets": ("int", 32, ()),
    # pack two 4-bit bins per byte when max_bin<=16 (reference
    # dense_nbits_bin.hpp): halves the pallas histogram row sweep's DMA
    # traffic; automatically skipped when the layout can't support it
    # (EFB bundles, gather partition, xla hist impl)
    "tpu_pack_bins": ("bool", True, ()),
    # sparse train-time storage (reference OrderedSparseBin,
    # src/io/ordered_sparse_bin.hpp / sparse_bin.hpp:73): features whose
    # nonzero-bin row fraction is <= this threshold are stored as padded
    # COO (row-id, bin) pairs instead of dense [n] columns — wide very-
    # sparse datasets stop paying dense HBM for empty rows.  Histograms
    # come from a gather contraction over the stored entries with the
    # zero bin reconstructed from leaf totals (the FixHistogram trick,
    # dataset.cpp:1044-1063).  0 disables.  Requires tree_learner=serial,
    # data, or voting, and enable_bundle=false (EFB is the alternative
    # mitigation).
    "tpu_sparse_threshold": ("float", 0.0, ()),
    # device-resident forest prediction (ops/predict.py): jitted bin-space
    # traversal for valid-score updates, score replay, and device='tpu'
    # Booster.predict.
    #   auto  - score replay goes on-device above tpu_predict_min_rows;
    #           Booster.predict uses the device path only when the default
    #           jax backend is a TPU (the native OMP walker wins on CPU)
    #   true  - always use the device predictor where structurally possible
    #   false - host/native predictors everywhere (parity oracle path)
    "tpu_predict_device": ("str", "auto", ()),
    # rows per device-predict chunk: bounds the [rows, F] bin block and the
    # [k, rows] score block shipped per kernel launch; full-size chunks are
    # padded so multi-chunk predicts reuse ONE compiled program
    "tpu_predict_chunk_rows": ("int", 65536, ()),
    # below this row count the auto mode keeps score replay on the host
    # walker (jit dispatch + compile dominate tiny valid sets)
    "tpu_predict_min_rows": ("int", 4096, ()),
    # launch-shape bucket policy (ops/predict.py BUCKET_POLICIES) shared
    # by training-time score replay, the chunked device predict path,
    # serving warmup enumeration, and bench — every layer quantizes its
    # launch shapes through the SAME ladder, so warmup can pre-compile
    # exactly the set a request can trigger.
    #   wide - rows pad on a x4 ladder from a 4096 floor, depth trip
    #          counts floor at 8, and the grower's frontier ramp steps
    #          x4: strictly fewer distinct programs (a full predict-size
    #          sweep compiles 3 instead of 7 at the default chunk), at up
    #          to 4x padded rows on small batches
    #   fine - the pre-round-6 shapes: pow2 rows from a 1024 floor, exact
    #          pow2 depth buckets, x2 ramp — lowest small-batch predict
    #          latency, most programs
    "tpu_bucket_policy": ("str", "wide", ()),
    # donate the per-iteration score buffers and the [L, G/P, B, 3]
    # histogram pool to XLA (jit donate_argnums): the pool is threaded
    # through the grower and rewritten in place across iterations instead
    # of being re-allocated per tree, and the score update reuses the old
    # scores buffer.  Outputs are bit-identical with donation on or off;
    # turn off when debugging with retained references to per-iteration
    # device arrays (donated buffers are deleted at dispatch)
    "tpu_donate_buffers": ("bool", True, ()),
    # device-parallel dataset ingest (ops/binning.py): raw rows are
    # quantized on the accelerator in streamed chunks (host key prep for
    # chunk i+1 overlaps device binning of chunk i) and the [n, F] bin
    # matrix stays device-resident — the host copy materializes lazily,
    # only when a host consumer (EFB planning, get_data, save_binary)
    # asks.  Bins are bit-identical to the host path on every backend
    # (integer-key compares, never f32 float compares).
    #   auto  - device binning only when the default jax backend is an
    #           accelerator (host numpy wins on plain CPU)
    #   true  - always route ingest through the device kernel
    #   false - host numpy binning everywhere (the reference path)
    "tpu_ingest_device": ("str", "auto", ()),
    # rows per ingest chunk: bounds the [chunk, F] key-plane upload and
    # the kernel's compare working set; every chunk reuses ONE compiled
    # program (the last partial chunk pads up to this size)
    "tpu_ingest_chunk_rows": ("int", 65536, ()),
    # below this row count ingest stays on the host even in auto mode
    # (kernel dispatch overhead dominates tiny matrices)
    "tpu_ingest_min_rows": ("int", 16384, ()),
}

_ALIAS: Dict[str, str] = {}
for _name, (_t, _d, _aliases) in _P.items():
    _ALIAS[_name] = _name
    for _a in _aliases:
        _ALIAS[_a] = _name


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("true", "1", "t", "yes", "on", "+"):
        return True
    if s in ("false", "0", "f", "no", "off", "-"):
        return False
    raise ValueError(f"cannot parse bool from {v!r}")


def parse_tristate(v: Any) -> str:
    """'true' / 'false' / 'auto' from a bool-ish or mode string — the ONE
    spelling authority for tri-state params like tpu_predict_device, so
    predict routing and training-time replay can never disagree on a
    value.  Unrecognized spellings raise: a typo silently mapped to
    'auto' would run the opposite of the requested configuration."""
    s = str(v).strip().lower()
    if s == "auto":
        return "auto"
    return "true" if _parse_bool(s) else "false"


def _coerce(typ: str, v: Any) -> Any:
    if typ == "int":
        return int(float(v)) if not isinstance(v, int) else v
    if typ == "float":
        return float(v)
    if typ == "bool":
        return _parse_bool(v)
    if typ == "str":
        return str(v)
    if typ in ("int_list", "float_list", "str_list"):
        if isinstance(v, (list, tuple)):
            items: List[Any] = list(v)
        else:
            s = str(v).strip()
            items = [x for x in s.replace(";", ",").split(",") if x != ""]
        if typ == "int_list":
            return [int(float(x)) for x in items]
        if typ == "float_list":
            return [float(x) for x in items]
        return [str(x) for x in items]
    raise ValueError(f"unknown param type {typ}")


OBJECTIVE_ALIASES = {
    "regression": "regression", "regression_l2": "regression", "l2": "regression",
    "mean_squared_error": "regression", "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "quantile": "quantile", "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank",
    "rank_xendcg": "rank_xendcg", "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg",
    "xe_ndcg_mart": "rank_xendcg", "xendcg_mart": "rank_xendcg",
    "none": "none", "null": "none", "custom": "none", "na": "none",
}


@dataclasses.dataclass
class Config:
    """Resolved training configuration.

    Construct with `Config(params_dict)` or `Config.from_string("k1=v1 k2=v2")`.
    Unknown keys are kept in `extra` (and warned about) so callers can pass
    through framework-specific knobs.
    """

    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __init__(self, params: Optional[Dict[str, Any]] = None):
        self.params = {k: (list(v) if isinstance(v, list) else v)
                       for k, (t, v, _a) in _P.items()}
        self.extra = {}
        if params:
            self.update(params)
        self._check_conflicts()

    # -- mapping-ish access ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        params = self.__dict__.get("params")
        if params is not None and name in params:
            return params[name]
        raise AttributeError(name)

    def __getitem__(self, name: str) -> Any:
        return self.params[_ALIAS.get(name, name)]

    def get(self, name: str, default: Any = None) -> Any:
        return self.params.get(_ALIAS.get(name, name), default)

    def update(self, params: Dict[str, Any]) -> None:
        for k, v in params.items():
            canon = _ALIAS.get(str(k).strip())
            if canon is None:
                self.extra[str(k)] = v
                continue
            typ = _P[canon][0]
            self.params[canon] = _coerce(typ, v)
        self._normalize()

    def _normalize(self) -> None:
        obj = str(self.params["objective"]).strip().lower()
        self.params["objective"] = OBJECTIVE_ALIASES.get(obj, obj)
        self.params["boosting"] = str(self.params["boosting"]).strip().lower()
        self.params["tree_learner"] = str(self.params["tree_learner"]).strip().lower()
        self.params["device_type"] = str(self.params["device_type"]).strip().lower()

    _MULTICLASS_OBJECTIVES = ("multiclass", "multiclassova", "softmax",
                              "multiclass_ova", "ova", "ovr")
    _MULTICLASS_METRICS = _MULTICLASS_OBJECTIVES + (
        "multi_logloss", "multi_error", "auc_mu")

    def _check_conflicts(self) -> None:
        # mirrors reference Config::CheckParamConflict (src/io/config.cpp:248)
        p = self.params
        learner = p["tree_learner"]
        if learner not in ("serial", "feature", "data", "voting",
                           "feature_parallel", "data_parallel",
                           "voting_parallel", "data_feature", "feature_data",
                           "data_feature_parallel"):
            raise ValueError(f"unknown tree_learner {learner!r}")

        # multiclass objective <-> num_class <-> metric consistency
        obj = str(p["objective"])
        num_class = int(p["num_class"])
        # custom objectives count as multiclass when num_class > 1
        # (reference config.cpp:251)
        obj_multi = obj in self._MULTICLASS_OBJECTIVES or (
            obj in ("custom", "none", "null", "na") and num_class > 1)
        if obj_multi and num_class <= 1:
            raise ValueError("num_class must be > 1 for multiclass training")
        if not obj_multi and obj and num_class != 1 \
                and str(p["task"]).lower() in ("train", "training"):
            raise ValueError("num_class must be 1 for non-multiclass "
                             "training")
        for mt in p["metric"]:
            norm = str(mt).strip().lower()
            if norm in ("", "none", "null", "na", "custom"):
                continue  # disabled/custom metrics match anything
            mt_multi = norm in self._MULTICLASS_METRICS
            if obj and (obj_multi != mt_multi):
                raise ValueError(
                    f"multiclass objective and metric {mt!r} don't match")

        # max_depth caps num_leaves (config.cpp:303-315)
        max_depth = int(p["max_depth"])
        if max_depth > 0:
            full = 2 ** min(max_depth, 30)
            if full < int(p["num_leaves"]):
                p["num_leaves"] = int(full)

        # GOSS re-weights instead of bagging (reference goss.hpp ResetGoss
        # raises Log::Fatal on bagging with goss)
        if str(p["boosting"]) == "goss" and (
                float(p["bagging_fraction"]) < 1.0
                or int(p["bagging_freq"]) > 0):
            raise ValueError("cannot use bagging in GOSS")

    # -- string parsing ----------------------------------------------------
    @staticmethod
    def str_to_map(text: str) -> Dict[str, str]:
        """Parse 'k1=v1 k2=v2' (whitespace/newline separated) into a dict.

        Mirrors reference Config::Str2Map (src/io/config.cpp:41); '#' starts
        a comment, as in reference .conf files.
        """
        out: Dict[str, str] = {}
        for raw_line in text.replace("\r", "\n").split("\n"):
            line = raw_line.split("#", 1)[0].strip()
            if not line:
                continue
            for tok in line.split():
                if "=" in tok:
                    k, v = tok.split("=", 1)
                    out[k.strip()] = v.strip()
        return out

    @staticmethod
    def load_conf_file(path: str) -> Dict[str, str]:
        """Parse a reference-style .conf file (one `key = value` per line)."""
        out: Dict[str, str] = {}
        with open(path) as f:
            for raw_line in f:
                line = raw_line.split("#", 1)[0].strip()
                if not line or "=" not in line:
                    continue
                k, v = line.split("=", 1)
                out[k.strip()] = v.strip()
        return out

    @classmethod
    def from_string(cls, text: str) -> "Config":
        return cls(cls.str_to_map(text))

    def to_dict(self) -> Dict[str, Any]:
        d = dict(self.params)
        d.update(self.extra)
        return d


def canonical_name(name: str) -> Optional[str]:
    return _ALIAS.get(name)


def resolve_device(config: "Config"):
    """The port's device rule: the card unless the caller asks for the CPU.

    `device_type` (alias `device`) equal to "cpu" selects the CPU; any
    other value — the JAX package's default "tpu", or "gpu"/"cuda" —
    selects the first CUDA device.  When CUDA is absent and the CPU was
    not asked for, this raises: the port never trains on the CPU by
    accident."""
    import torch

    if str(config.device_type).strip().lower() == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device_type={config.device_type!r} needs a CUDA device and "
            "none is available; pass device_type='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def refuse_host_predict(value: Any, where: str) -> None:
    """Refuse tpu_predict_device=false by name.  In the JAX package it
    pins predict to the f64 host walker (lightgbm_tpu/booster.py:
    _device_predict_requested), which is not ported: the port walks the
    trees on the device in f32 under `auto` and `true`.  where: how the
    value was given (a training parameter, the model text, a predict
    keyword)."""
    if parse_tristate(value) == "false":
        raise NotImplementedError(
            f"tpu_predict_device=false ({where}; the JAX package's f64 "
            "host walker) is not ported to lightgbm_tpu_torch yet")
