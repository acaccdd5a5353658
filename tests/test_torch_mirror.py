"""The port's suite mirrors the reference's: every ``def test_`` of the
reference's ``tests/test_*.py`` has a counterpart in a
``tests/test_torch_*.py``.

``MIRROR`` maps each reference test, ``"file::name"``, to the port test
that holds the same case on ``repro_torch`` (against the reference where
the reference computes something, the reference's invariant otherwise),
or to a tuple of them where the case is split, or to a one-line reason
starting ``"no counterpart: "``, allowed only for code the port does not
have (a JAX shim, an XLA flag).  Today every reference test has a
counterpart.  The test reads both sides with ``ast`` and imports neither
package, so a reference test added later fails here until it is
mirrored, and a renamed or deleted port test fails here too.
"""

import ast
import pathlib

TESTS = pathlib.Path(__file__).resolve().parent
NO_COUNTERPART = "no counterpart: "

MIRROR = {
    # test_chaos.py
    "test_chaos.py::test_hard_kill_with_recovery_loses_nothing":
        "test_torch_chaos.py::test_hard_kill_with_recovery_loses_nothing",
    "test_chaos.py::test_hard_kill_without_recovery_loses_work":
        "test_torch_chaos.py::test_hard_kill_without_recovery_loses_work",
    "test_chaos.py::test_chaos_run_is_deterministic":
        "test_torch_chaos.py::test_chaos_run_is_deterministic",
    "test_chaos.py::test_stale_lifecycle_event_against_drained_replica_is_noop":
        "test_torch_chaos.py::test_stale_lifecycle_event_against_drained_replica_is_noop",
    "test_chaos.py::test_slowdown_scales_step_interval":
        "test_torch_chaos.py::test_slowdown_scales_step_interval",
    "test_chaos.py::test_endpoint_retries_transient_failures_with_backoff":
        "test_torch_chaos.py::test_endpoint_retries_transient_failures_with_backoff",
    "test_chaos.py::test_checkpoint_units_is_non_destructive":
        "test_torch_chaos.py::test_checkpoint_units_is_non_destructive",
    "test_chaos.py::test_checkpoint_resume_restores_sampled_stream":
        "test_torch_chaos.py::test_checkpoint_resume_restores_sampled_stream",
    "test_chaos.py::test_failure_detector_ladder":
        "test_torch_chaos.py::test_failure_detector_ladder",
    "test_chaos.py::test_straggler_policy_quarantines_and_releases":
        "test_torch_chaos.py::test_straggler_policy_quarantines_and_releases",
    "test_chaos.py::test_summary_zero_fills_recovery_counters":
        "test_torch_chaos.py::test_summary_zero_fills_recovery_counters",
    # test_cloud.py
    "test_cloud.py::test_mode_c_single_rescale":
        "test_torch_cloud.py::test_mode_c_single_rescale",
    "test_cloud.py::test_mode_b_two_rescales_per_interruption_batch":
        "test_torch_cloud.py::test_mode_b_two_rescales_per_interruption_batch",
    "test_cloud.py::test_mode_ordering_c_best":
        "test_torch_cloud.py::test_mode_ordering_c_best",
    "test_cloud.py::test_complete_replacement_trigger":
        "test_torch_cloud.py::test_complete_replacement_trigger",
    "test_cloud.py::test_emergency_override_trigger":
        "test_torch_cloud.py::test_emergency_override_trigger",
    "test_cloud.py::test_timeout_trigger":
        "test_torch_cloud.py::test_timeout_trigger",
    "test_cloud.py::test_mode_a_downtime_and_rollback":
        "test_torch_cloud.py::test_mode_a_downtime_and_rollback",
    "test_cloud.py::test_overhead_scales_with_interruptions_mode_b_not_c":
        "test_torch_cloud.py::test_overhead_scales_with_interruptions_mode_b_not_c",
    "test_cloud.py::test_rebalancing_halves_overhead_vs_reactive":
        "test_torch_cloud.py::test_rebalancing_halves_overhead_vs_reactive",
    # test_cluster.py
    "test_cluster.py::test_rate_aware_beats_round_robin":
        "test_torch_cluster.py::test_rate_aware_beats_round_robin",
    "test_cluster.py::test_virtual_clock_is_deterministic":
        "test_torch_cluster.py::test_virtual_clock_is_deterministic",
    "test_cluster.py::test_measured_rates_track_heterogeneity":
        "test_torch_cluster.py::test_measured_rates_track_heterogeneity",
    "test_cluster.py::test_interruption_drain_loses_nothing":
        "test_torch_cluster.py::test_interruption_drain_loses_nothing",
    "test_cluster.py::test_drain_requeues_waiting_requests":
        "test_torch_cluster.py::test_drain_requeues_waiting_requests",
    "test_cluster.py::test_autoscaler_scales_up_under_backlog":
        "test_torch_cluster.py::test_autoscaler_scales_up_under_backlog",
    "test_cluster.py::test_spot_feed_lifecycle_ordering":
        "test_torch_cluster.py::test_spot_feed_lifecycle_ordering",
    "test_cluster.py::test_greedy_refine_base_load":
        "test_torch_cluster.py::test_greedy_refine_base_load",
    "test_cluster.py::test_engine_snapshot_restore_exact":
        "test_torch_cluster.py::test_engine_snapshot_restore_exact",
    # test_cluster_slo.py
    "test_cluster_slo.py::test_slo_aware_beats_fifo_on_interactive_attainment":
        "test_torch_cluster_slo.py::test_slo_aware_beats_fifo_on_interactive_attainment",
    "test_cluster_slo.py::test_slo_run_is_deterministic":
        "test_torch_cluster_slo.py::test_slo_run_is_deterministic",
    "test_cluster_slo.py::test_priority_admission_holds_batch_until_headroom":
        "test_torch_cluster_slo.py::test_priority_admission_holds_batch_until_headroom",
    "test_cluster_slo.py::test_fifo_admission_never_holds":
        "test_torch_cluster_slo.py::test_fifo_admission_never_holds",
    "test_cluster_slo.py::test_deadline_router_repairs_predicted_misses":
        "test_torch_cluster_slo.py::test_deadline_router_repairs_predicted_misses",
    "test_cluster_slo.py::test_deadline_router_slot_level_parallelism":
        "test_torch_cluster_slo.py::test_deadline_router_slot_level_parallelism",
    "test_cluster_slo.py::test_deadline_router_orders_by_priority_then_deadline":
        "test_torch_cluster_slo.py::test_deadline_router_orders_by_priority_then_deadline",
    "test_cluster_slo.py::test_rebalance_moves_slots_and_loses_no_tokens":
        "test_torch_cluster_slo.py::test_rebalance_moves_slots_and_loses_no_tokens",
    "test_cluster_slo.py::test_rebalance_respects_balanced_fleets":
        "test_torch_cluster_slo.py::test_rebalance_respects_balanced_fleets",
    "test_cluster_slo.py::test_multi_model_fleet_routes_and_scales_per_pool":
        "test_torch_cluster_slo.py::test_multi_model_fleet_routes_and_scales_per_pool",
    "test_cluster_slo.py::test_unserved_model_requests_wait_not_crash":
        "test_torch_cluster_slo.py::test_unserved_model_requests_wait_not_crash",
    "test_cluster_slo.py::test_closed_loop_offered_load_tracks_completions":
        "test_torch_cluster_slo.py::test_closed_loop_offered_load_tracks_completions",
    "test_cluster_slo.py::test_closed_loop_cluster_never_exceeds_n_users":
        "test_torch_cluster_slo.py::test_closed_loop_cluster_never_exceeds_n_users",
    "test_cluster_slo.py::test_closed_loop_ignores_foreign_completions":
        "test_torch_cluster_slo.py::test_closed_loop_ignores_foreign_completions",
    "test_cluster_slo.py::test_metrics_attainment_and_overdue":
        "test_torch_cluster_slo.py::test_metrics_attainment_and_overdue",
    "test_cluster_slo.py::test_request_deadline_helper":
        "test_torch_cluster_slo.py::test_request_deadline_helper",
    # test_event_runtime.py
    "test_event_runtime.py::test_event_loop_orders_by_time_then_seq":
        "test_torch_event_runtime.py::test_event_loop_orders_by_time_then_seq",
    "test_event_runtime.py::test_event_loop_cancel_and_until":
        "test_torch_event_runtime.py::test_event_loop_cancel_and_until",
    "test_event_runtime.py::test_event_loop_rejects_duplicate_and_unknown_kinds":
        "test_torch_event_runtime.py::test_event_loop_rejects_duplicate_and_unknown_kinds",
    "test_event_runtime.py::test_handlers_can_schedule_during_dispatch":
        "test_torch_event_runtime.py::test_handlers_can_schedule_during_dispatch",
    "test_event_runtime.py::test_fault_trace_materializes_lifecycle":
        "test_torch_event_runtime.py::test_fault_trace_materializes_lifecycle",
    "test_event_runtime.py::test_fault_trace_sampled_is_seeded":
        "test_torch_event_runtime.py::test_fault_trace_sampled_is_seeded",
    "test_event_runtime.py::test_fault_trace_from_file":
        "test_torch_event_runtime.py::test_fault_trace_from_file",
    "test_event_runtime.py::test_feed_is_a_view_over_a_shared_trace":
        "test_torch_event_runtime.py::test_feed_is_a_view_over_a_shared_trace",
    "test_event_runtime.py::test_arrival_processes":
        "test_torch_event_runtime.py::test_arrival_processes",
    "test_event_runtime.py::test_make_arrivals_specs":
        "test_torch_event_runtime.py::test_make_arrivals_specs",
    "test_event_runtime.py::test_cluster_event_timeline_bit_identical":
        "test_torch_event_runtime.py::test_cluster_event_timeline_bit_identical",
    "test_event_runtime.py::test_cloud_manager_timeline_bit_identical":
        "test_torch_event_runtime.py::test_cloud_manager_timeline_bit_identical",
    "test_event_runtime.py::test_one_trace_drives_training_and_serving_identically":
        "test_torch_event_runtime.py::test_one_trace_drives_training_and_serving_identically",
    "test_event_runtime.py::test_overlapping_lifecycles_on_one_target_hit_distinct_victims":
        "test_torch_event_runtime.py::test_overlapping_lifecycles_on_one_target_hit_distinct_victims",
    "test_event_runtime.py::test_same_timestamp_arrivals_coalesce_to_one_router_pass":
        "test_torch_event_runtime.py::test_same_timestamp_arrivals_coalesce_to_one_router_pass",
    "test_event_runtime.py::test_tile_runtime_replays_same_trace":
        "test_torch_event_runtime.py::test_tile_runtime_replays_same_trace",
    # test_faults.py
    "test_faults.py::test_trace_file_roundtrip":
        "test_torch_faults.py::test_trace_file_roundtrip",
    "test_faults.py::test_inject_after_bind_reaches_the_loop":
        "test_torch_faults.py::test_inject_after_bind_reaches_the_loop",
    "test_faults.py::test_equal_timestamp_events_poll_in_injection_order":
        "test_torch_faults.py::test_equal_timestamp_events_poll_in_injection_order",
    "test_faults.py::test_chaos_kinds_file_roundtrip":
        "test_torch_faults.py::test_chaos_kinds_file_roundtrip",
    "test_faults.py::test_chaos_inject_after_bind_reaches_the_loop":
        "test_torch_faults.py::test_chaos_inject_after_bind_reaches_the_loop",
    "test_faults.py::test_chaos_sampled_soup_is_seed_deterministic":
        "test_torch_faults.py::test_chaos_sampled_soup_is_seed_deterministic",
    "test_faults.py::test_market_driven_schedule_is_purchase_deterministic":
        "test_torch_market.py::test_market_driven_schedule_is_purchase_deterministic",
    # test_kernels.py
    "test_kernels.py::test_jacobi_kernel":
        "test_torch_jacobi.py::test_plain_equals_pallas_and_jax_ref",
    "test_kernels.py::test_jacobi_multi_sweep_matches_reference":
        "test_torch_jacobi.py::test_jacobi_multi_sweep_matches_reference",
    "test_kernels.py::test_flash_kernel":
        "test_torch_flash.py::test_attention_matches_pallas_kernel",
    "test_kernels.py::test_flash_kernel_bf16":
        "test_torch_flash.py::test_attention_bf16_matches_pallas_kernel",
    "test_kernels.py::test_ssd_kernel":
        "test_torch_ssd.py::test_plain_matches_jax_ref_and_pallas",
    "test_kernels.py::test_ssd_chunked_equals_sequential_recurrence":
        "test_torch_ssd.py::test_ssd_chunked_equals_sequential_recurrence",
    # test_loadbalance.py
    "test_loadbalance.py::test_greedy_assigns_all_with_lpt_bound":
        "test_torch_loadbalance.py::test_greedy_is_a_list_schedule",
    "test_loadbalance.py::test_greedy_refine_never_worse_and_migrations_bounded":
        "test_torch_loadbalance.py::test_greedy_refine_never_worse_and_moves_only_off_donors",
    "test_loadbalance.py::test_rate_aware_greedy_bounds":
        "test_torch_loadbalance.py::test_rate_aware_greedy_bounds",
    "test_loadbalance.py::test_rate_aware_moves_work_off_slow_pe":
        "test_torch_loadbalance.py::test_rate_aware_moves_work_off_slow_pe",
    "test_loadbalance.py::test_greedy_refine_keeps_balanced_assignment":
        "test_torch_loadbalance.py::test_greedy_refine_keeps_balanced_assignment",
    "test_loadbalance.py::test_no_lb_is_identity":
        "test_torch_loadbalance.py::test_no_lb_is_identity",
    "test_loadbalance.py::test_rate_monitor_ewma_and_stragglers":
        "test_torch_runtime_core.py::test_rate_monitor_ewma_and_stragglers",
    "test_loadbalance.py::test_rate_monitor_resize_preserves_history":
        "test_torch_runtime_core.py::test_rate_monitor_resize_preserves_history",
    # test_loop_properties.py
    "test_loop_properties.py::test_same_timestamp_ties_break_by_schedule_order":
        "test_torch_loop_properties.py::test_same_timestamp_ties_break_by_schedule_order",
    "test_loop_properties.py::test_journal_bit_identical_across_runs":
        "test_torch_loop_properties.py::test_journal_bit_identical_across_runs",
    "test_loop_properties.py::test_cancelled_events_never_dispatch":
        "test_torch_loop_properties.py::test_cancelled_events_never_dispatch",
    "test_loop_properties.py::test_tie_break_fixed":
        "test_torch_loop_properties.py::test_tie_break_fixed",
    "test_loop_properties.py::test_journal_identity_with_recurring_rebalance_fixed":
        "test_torch_loop_properties.py::test_journal_identity_with_recurring_rebalance_fixed",
    "test_loop_properties.py::test_cancelling_recurring_event_stops_the_chain":
        "test_torch_loop_properties.py::test_cancelling_recurring_event_stops_the_chain",
    "test_loop_properties.py::test_cancel_is_idempotent_and_none_safe":
        "test_torch_loop_properties.py::test_cancel_is_idempotent_and_none_safe",
    # test_loop_scale.py
    "test_loop_scale.py::test_run_raises_when_cap_truncates_live_work":
        "test_torch_loop_scale.py::test_run_raises_when_cap_truncates_live_work",
    "test_loop_scale.py::test_run_cap_error_names_the_next_due_event":
        "test_torch_loop_scale.py::test_run_cap_error_names_the_next_due_event",
    "test_loop_scale.py::test_run_exact_cap_with_drained_loop_is_fine":
        "test_torch_loop_scale.py::test_run_exact_cap_with_drained_loop_is_fine",
    "test_loop_scale.py::test_run_cap_ignores_events_beyond_until":
        "test_torch_loop_scale.py::test_run_cap_ignores_events_beyond_until",
    "test_loop_scale.py::test_compaction_triggers_and_shrinks_the_heap":
        "test_torch_loop_scale.py::test_compaction_triggers_and_shrinks_the_heap",
    "test_loop_scale.py::test_compaction_journal_bit_identical_to_small_reference":
        "test_torch_loop_scale.py::test_compaction_journal_bit_identical_to_small_reference",
    "test_loop_scale.py::test_compaction_digest_matches_cancel_order_permutation":
        "test_torch_loop_scale.py::test_compaction_digest_matches_cancel_order_permutation",
    "test_loop_scale.py::test_cancelled_events_never_dispatch_after_compaction":
        "test_torch_loop_scale.py::test_cancelled_events_never_dispatch_after_compaction",
    "test_loop_scale.py::test_pending_tracks_schedule_cancel_dispatch_exactly":
        "test_torch_loop_scale.py::test_pending_tracks_schedule_cancel_dispatch_exactly",
    "test_loop_scale.py::test_digest_identical_with_journal_off":
        "test_torch_loop_scale.py::test_digest_identical_with_journal_off",
    # test_market.py
    "test_market.py::test_price_path_is_seeded_and_floored":
        "test_torch_market.py::test_price_path_is_seeded_and_floored",
    "test_market.py::test_spike_multiplies_rate_and_couples_intensity":
        "test_torch_market.py::test_spike_multiplies_rate_and_couples_intensity",
    "test_market.py::test_dollars_matches_numerical_integral":
        "test_torch_market.py::test_dollars_matches_numerical_integral",
    "test_market.py::test_interruption_sampling_is_seeded_and_price_coupled":
        "test_torch_market.py::test_interruption_sampling_is_seeded_and_price_coupled",
    "test_market.py::test_catalog_rejects_bad_registrations":
        "test_torch_market.py::test_catalog_rejects_bad_registrations",
    "test_market.py::test_adjusted_shopper_walks_away_from_the_spike":
        "test_torch_market.py::test_adjusted_shopper_walks_away_from_the_spike",
    "test_market.py::test_purchase_sequence_is_deterministic":
        "test_torch_market.py::test_purchase_sequence_is_deterministic",
    "test_market.py::test_non_spot_instance_always_buys_on_demand":
        "test_torch_market.py::test_non_spot_instance_always_buys_on_demand",
    "test_market.py::test_overhead_estimate_learns_from_drain_records":
        "test_torch_market.py::test_overhead_estimate_learns_from_drain_records",
    "test_market.py::test_fallback_strategies":
        "test_torch_market.py::test_fallback_strategies",
    "test_market.py::test_make_fallback":
        "test_torch_market.py::test_make_fallback",
    "test_market.py::test_ledger_savings_and_breakdowns":
        "test_torch_market.py::test_ledger_savings_and_breakdowns",
    "test_market.py::test_market_aware_scaling_shops_effective_price":
        "test_torch_market.py::test_market_aware_scaling_shops_effective_price",
    "test_market.py::test_cluster_market_run_reports_savings":
        "test_torch_market.py::test_cluster_market_run_reports_savings",
    "test_market.py::test_cluster_market_run_is_deterministic":
        "test_torch_market.py::test_cluster_market_run_is_deterministic",
    "test_market.py::test_interrupted_units_carry_their_hop_journal":
        "test_torch_market.py::test_interrupted_units_carry_their_hop_journal",
    "test_market.py::test_queue_work_fallback_parks_until_capacity":
        "test_torch_market.py::test_queue_work_fallback_parks_until_capacity",
    "test_market.py::test_market_requires_fallback_pairing":
        "test_torch_market.py::test_market_requires_fallback_pairing",
    # test_migration.py
    "test_migration.py::test_migrate_mid_decode_bit_identical":
        "test_torch_workunit.py::test_migrate_mid_decode_bit_identical",
    "test_migration.py::test_migrate_mid_prefill_chunk_bit_identical":
        "test_torch_workunit.py::test_migrate_mid_prefill_chunk_bit_identical",
    "test_migration.py::test_double_migration_bit_identical":
        "test_torch_workunit.py::test_double_migration_bit_identical",
    "test_migration.py::test_selective_snapshot_leaves_other_slots_running":
        "test_torch_workunit.py::test_selective_snapshot_leaves_other_slots_running",
    # test_models.py
    "test_models.py::test_arch_train_step":
        "test_torch_train.py::test_arch_train_step",
    "test_models.py::test_arch_prefill_decode":
        "test_torch_models.py::test_arch_prefill_decode",
    "test_models.py::test_decode_matches_forward":
        "test_torch_models.py::test_decode_matches_forward",
    "test_models.py::test_inactive_slots_frozen":
        "test_torch_models.py::test_inactive_slots_frozen",
    "test_models.py::test_blockwise_attention_matches_full":
        "test_torch_models.py::test_blockwise_attention_matches_full",
    "test_models.py::test_grad_accum_matches_single_batch":
        "test_torch_train.py::test_grad_accum_matches_single_batch",
    "test_models.py::test_padded_vocab_masked":
        "test_torch_train.py::test_padded_vocab_masked",
    "test_models.py::test_param_counts_plausible":
        "test_torch_models.py::test_param_counts_plausible",
    # test_moe.py
    "test_moe.py::test_route_topk_valid":
        "test_torch_moe.py::test_route_topk_valid",
    "test_moe.py::test_capacity_bounds_tokens_per_expert":
        "test_torch_moe.py::test_capacity_bounds_tokens_per_expert",
    "test_moe.py::test_moe_block_no_drop_equals_dense_computation":
        "test_torch_moe.py::test_moe_block_no_drop_equals_dense_computation",
    "test_moe.py::test_moe_capacity_drops_tokens":
        "test_torch_moe.py::test_moe_capacity_drops_tokens",
    "test_moe.py::test_shared_experts_applied":
        "test_torch_moe.py::test_shared_experts_applied",
    # test_moe_impls.py
    "test_moe_impls.py::test_grouped_matches_onehot_no_drop":
        "test_torch_moe.py::test_grouped_matches_onehot_no_drop",
    "test_moe_impls.py::test_grouped_matches_onehot_with_drops_single_group":
        "test_torch_moe.py::test_grouped_matches_onehot_with_drops_single_group",
    "test_moe_impls.py::test_moe_impl_knob":
        "test_torch_moe.py::test_moe_impl_knob",
    "test_moe_impls.py::test_grouped_gradients_finite":
        "test_torch_train.py::test_grouped_gradients_finite",
    # test_multidevice.py
    "test_multidevice.py::test_spmd_stencil_matches_reference_8dev":
        "test_torch_multirank.py::test_spmd_stencil_matches_reference",
    "test_multidevice.py::test_sharded_training_matches_single_device":
        "test_torch_multirank.py::test_data_parallel_float32_matches_reference_and_one_device",
    "test_multidevice.py::test_elastic_shrink_expand_8dev":
        "test_torch_multirank.py::test_elastic_shrink_expand_4_2_4",
    "test_multidevice.py::test_zero1_state_sharding_compiles_and_runs":
        "test_torch_multirank.py::test_zero1_matches_data_parallel_and_shards_moments",
    # test_paged.py
    "test_paged.py::test_paged_kernel_matches_ref":
        "test_torch_paged_attention.py::test_plain_matches_jax_ref_and_pallas",
    "test_paged.py::test_paged_ref_bit_identical_to_dense_attention":
        "test_torch_paged_attention.py::test_plain_bit_identical_to_dense_attention",
    "test_paged.py::test_gather_pages_clamps_sentinels":
        "test_torch_paged_attention.py::test_gather_pages_clamps_sentinels",
    "test_paged.py::test_paged_engine_bit_identical":
        ("test_torch_engine.py::test_port_paged_equals_dense_bitwise", "test_torch_engine.py::test_recurrent_paged_equals_dense_bitwise"),
    "test_paged.py::test_multichunk_long_prompt_bit_identical":
        "test_torch_paged.py::test_multichunk_long_prompt_bit_identical",
    "test_paged.py::test_small_pool_capacity_gated":
        "test_torch_paged.py::test_small_pool_capacity_gated",
    "test_paged.py::test_cross_block_size_migration":
        "test_torch_workunit.py::test_cross_block_size_migration",
    "test_paged.py::test_paged_to_dense_migration":
        "test_torch_workunit.py::test_dense_paged_migration",
    "test_paged.py::test_block_allocator_never_leaks":
        "test_torch_paged.py::test_block_allocator_never_leaks",
    "test_paged.py::test_engine_interleaving_never_leaks_blocks":
        "test_torch_workunit.py::test_engine_interleaving_never_leaks_blocks",
    "test_paged.py::test_paged_steady_state_is_sync_free":
        "test_torch_paged.py::test_paged_steady_state_is_sync_free",
    "test_paged.py::test_occupancy_threads_into_cluster_summary":
        "test_torch_paged.py::test_occupancy_threads_into_cluster_summary",
    "test_paged.py::test_dense_engine_occupancy_is_slot_only":
        "test_torch_paged.py::test_dense_engine_occupancy_is_slot_only",
    # test_router_queue.py
    "test_router_queue.py::test_submit_is_fifo":
        "test_torch_router_queue.py::test_submit_is_fifo",
    "test_router_queue.py::test_requeue_prepends_preserving_relative_order":
        "test_torch_router_queue.py::test_requeue_prepends_preserving_relative_order",
    "test_router_queue.py::test_round_robin_dispatch_drains_in_fifo_order":
        "test_torch_router_queue.py::test_round_robin_dispatch_drains_in_fifo_order",
    "test_router_queue.py::test_queued_aggregates_match_a_fresh_scan":
        "test_torch_router_queue.py::test_queued_aggregates_match_a_fresh_scan",
    "test_router_queue.py::test_queued_aggregates_survive_dispatch_and_requeue":
        "test_torch_router_queue.py::test_queued_aggregates_survive_dispatch_and_requeue",
    "test_router_queue.py::test_queued_aggregates_never_go_negative":
        "test_torch_router_queue.py::test_queued_aggregates_never_go_negative",
    "test_router_queue.py::test_pool_cache_rebuilds_on_topology_epoch_bump":
        "test_torch_router_queue.py::test_pool_cache_rebuilds_on_topology_epoch_bump",
    "test_router_queue.py::test_place_cap_fills_engine_headroom_only":
        "test_torch_router_queue.py::test_place_cap_fills_engine_headroom_only",
    "test_router_queue.py::test_place_cap_scan_window_bounds_work_per_pass":
        "test_torch_router_queue.py::test_place_cap_scan_window_bounds_work_per_pass",
    "test_router_queue.py::test_place_cap_keeps_aggregates_consistent":
        "test_torch_router_queue.py::test_place_cap_keeps_aggregates_consistent",
    "test_router_queue.py::test_place_cap_respects_model_pools":
        "test_torch_router_queue.py::test_place_cap_respects_model_pools",
    # test_runtime.py
    "test_runtime.py::test_tile_runtime_matches_global_jacobi":
        "test_torch_stencil.py::test_runtime_matches_jax_and_the_oracle",
    "test_runtime.py::test_tile_runtime_lb_preserves_solution":
        "test_torch_stencil.py::test_lb_preserves_solution_and_moves_tiles",
    "test_runtime.py::test_tile_runtime_checkpoint_restore_elastic":
        "test_torch_stencil.py::test_jax_checkpoint_restores_into_port_and_back",
    "test_runtime.py::test_choose_tiling":
        "test_torch_stencil.py::test_choose_tiling",
    "test_runtime.py::test_comm_model_exposure_shrinks_with_odf":
        "test_torch_stencil.py::test_comm_model_exposure_shrinks_with_odf",
    "test_runtime.py::test_store_roundtrip":
        "test_torch_checkpointing.py::test_save_restore_exact_and_independent",
    "test_runtime.py::test_store_restore_with_sharding":
        "test_torch_checkpointing.py::test_restore_defaults_to_the_card",
    "test_runtime.py::test_synthetic_data_deterministic_and_step_addressable":
        "test_torch_data.py::test_synthetic_data_deterministic_and_step_addressable",
    "test_runtime.py::test_prefetcher_orders_batches":
        "test_torch_data.py::test_prefetcher_orders_batches",
    "test_runtime.py::test_elastic_trainer_continuity_single_device":
        "test_torch_elastic.py::test_elastic_trainer_continuity_single_device",
    # test_serving_engine.py
    "test_serving_engine.py::test_chunked_prefill_bit_identical_to_streamed":
        "test_torch_serving_engine.py::test_chunked_prefill_bit_identical_to_streamed",
    "test_serving_engine.py::test_bulk_prefill_cache_matches_streamed_cache":
        "test_torch_serving_engine.py::test_bulk_prefill_cache_matches_streamed_cache",
    "test_serving_engine.py::test_chunked_prefill_recurrent_families":
        "test_torch_engine.py::test_recurrent_chunked_prefill_matches_streamed",
    "test_serving_engine.py::test_snapshot_mid_prefill_chunk_resumes_identically":
        "test_torch_serving_engine.py::test_snapshot_mid_prefill_chunk_resumes_identically",
    "test_serving_engine.py::test_steady_state_decode_is_sync_free":
        "test_torch_serving_engine.py::test_steady_state_decode_is_sync_free",
    "test_serving_engine.py::test_host_projection_matches_device":
        "test_torch_serving_engine.py::test_host_projection_matches_device",
    "test_serving_engine.py::test_backlog_discounts_prefill_tokens":
        "test_torch_serving_engine.py::test_backlog_discounts_prefill_tokens",
    "test_serving_engine.py::test_eos_early_exit_fewer_steps_identical_tokens":
        "test_torch_serving_engine.py::test_eos_early_exit_fewer_steps_identical_tokens",
    "test_serving_engine.py::test_eos_early_exit_batch_slots_independent":
        "test_torch_serving_engine.py::test_eos_early_exit_batch_slots_independent",
    "test_serving_engine.py::test_bucket_selection":
        "test_torch_serving_engine.py::test_bucket_selection",
    # test_shapes.py
    "test_shapes.py::test_same_seed_bit_identical_stream":
        "test_torch_shapes.py::test_same_seed_bit_identical_stream",
    "test_shapes.py::test_reiterable_not_a_spent_iterator":
        "test_torch_shapes.py::test_reiterable_not_a_spent_iterator",
    "test_shapes.py::test_different_seed_different_stream":
        "test_torch_shapes.py::test_different_seed_different_stream",
    "test_shapes.py::test_monotone_count_and_rids":
        "test_torch_shapes.py::test_monotone_count_and_rids",
    "test_shapes.py::test_start_rid_offsets_the_stream":
        "test_torch_shapes.py::test_start_rid_offsets_the_stream",
    "test_shapes.py::test_rate_max_is_an_envelope":
        "test_torch_shapes.py::test_rate_max_is_an_envelope",
    "test_shapes.py::test_per_segment_empirical_rate":
        "test_torch_shapes.py::test_per_segment_empirical_rate",
    "test_shapes.py::test_long_run_mean_tracks_target_rate":
        "test_torch_shapes.py::test_long_run_mean_tracks_target_rate",
    "test_shapes.py::test_make_shape_unknown_name":
        "test_torch_shapes.py::test_make_shape_unknown_name",
    "test_shapes.py::test_base_class_is_abstract":
        "test_torch_shapes.py::test_base_class_is_abstract",
    "test_shapes.py::test_matrix_cell_journal_bit_identical_across_runs":
        "test_torch_shapes.py::test_matrix_cell_journal_bit_identical_across_runs",
    "test_shapes.py::test_matrix_cell_digest_independent_of_journal_retention":
        "test_torch_shapes.py::test_matrix_cell_digest_independent_of_journal_retention",
    "test_shapes.py::test_streaming_metrics_keep_no_per_request_traces":
        "test_torch_shapes.py::test_streaming_cell_keeps_no_per_request_records",
    # test_sharding.py
    "test_sharding.py::test_spec_dedup_never_reuses_axis":
        "test_torch_sharding.py::test_spec_dedup_never_reuses_axis",
    "test_sharding.py::test_divisibility_fallback":
        "test_torch_sharding.py::test_divisibility_fallback",
    "test_sharding.py::test_params_shardings_cover_schema":
        "test_torch_sharding.py::test_params_shardings_cover_schema",
    "test_sharding.py::test_padded_vocab_always_divides_production_axis":
        "test_torch_sharding.py::test_padded_vocab_always_divides_production_axis",
    "test_sharding.py::test_zero1_extends_first_free_dim":
        "test_torch_sharding.py::test_zero1_extends_first_free_dim",
    "test_sharding.py::test_batch_shardings_match_batch_spec":
        "test_torch_sharding.py::test_batch_shardings_match_batch_spec",
    # test_system.py
    "test_system.py::test_c1_overdecomposition_hides_latency":
        "test_torch_stencil.py::test_c1_overdecomposition_hides_latency",
    "test_system.py::test_c2_rate_aware_lb_beats_none":
        "test_torch_stencil.py::test_c2_rate_aware_lb_beats_none",
    "test_system.py::test_c4_c5_mode_comparison":
        "test_torch_cloud.py::test_c4_c5_mode_comparison",
    "test_system.py::test_training_loss_decreases":
        "test_torch_elastic.py::test_training_loss_decreases",
    "test_system.py::test_serving_engine_end_to_end":
        "test_torch_serving_engine.py::test_serving_engine_end_to_end",
    # test_vertical.py
    "test_vertical.py::test_grow_mid_flight_bit_identical":
        "test_torch_workunit.py::test_grow_mid_flight_bit_identical",
    "test_vertical.py::test_shrink_evict_resume_bit_identical":
        "test_torch_workunit.py::test_shrink_evict_resume_bit_identical",
    "test_vertical.py::test_paged_resize_grow_shrink_and_pool":
        "test_torch_workunit.py::test_paged_resize_grow_shrink_and_pool",
    "test_vertical.py::test_sim_engine_resize_mirrors_real":
        "test_torch_simengine.py::test_sim_engine_resize_mirrors_real",
    "test_vertical.py::test_decode_block_only_resize_is_free":
        "test_torch_workunit.py::test_decode_block_only_resize_is_free",
    "test_vertical.py::test_resize_rejects_bad_geometry":
        "test_torch_workunit.py::test_resize_rejects_bad_geometry",
    "test_vertical.py::test_resize_interleaving_conserves_units_sim":
        "test_torch_simengine.py::test_resize_interleaving_conserves_units_sim",
    "test_vertical.py::test_resize_interleaving_conserves_blocks_paged":
        "test_torch_workunit.py::test_resize_interleaving_conserves_blocks_paged",
    "test_vertical.py::test_resize_interleaving_property":
        ("test_torch_vertical.py::test_resize_interleaving_property_dense", "test_torch_simengine.py::test_resize_interleaving_fixed_seeds"),
    "test_vertical.py::test_qos_tier_mapping":
        "test_torch_vertical.py::test_qos_tier_mapping",
    "test_vertical.py::test_qos_shrink_evicts_best_effort_first":
        "test_torch_simengine.py::test_qos_shrink_evicts_best_effort_first",
    "test_vertical.py::test_qos_best_effort_holds_until_idle_capacity":
        "test_torch_vertical.py::test_qos_best_effort_holds_until_idle_capacity",
    "test_vertical.py::test_cluster_vertical_grow_shrink_smoke":
        "test_torch_vertical.py::test_cluster_vertical_grow_shrink_smoke",
    "test_vertical.py::test_cluster_shrink_evictions_never_lose_work":
        "test_torch_vertical.py::test_cluster_shrink_evictions_never_lose_work",
    "test_vertical.py::test_sliding_window_policy_needs_history":
        "test_torch_vertical.py::test_sliding_window_policy_needs_history",
    "test_vertical.py::test_detector_suspects_wedged_replica":
        "test_torch_vertical.py::test_detector_suspects_wedged_replica",
    "test_vertical.py::test_adaptive_checkpoint_interval":
        "test_torch_vertical.py::test_adaptive_checkpoint_interval",
    "test_vertical.py::test_summary_schema_zero_fills_vertical_keys":
        "test_torch_vertical.py::test_summary_schema_zero_fills_vertical_keys",
    # test_workunit.py
    "test_workunit.py::test_preempt_resume_mid_decode_bit_identical":
        "test_torch_workunit.py::test_preempt_resume_mid_decode_bit_identical",
    "test_workunit.py::test_preempt_resume_mid_prefill_chunk_bit_identical":
        "test_torch_workunit.py::test_preempt_resume_mid_prefill_chunk_bit_identical",
    "test_workunit.py::test_workunit_metadata":
        "test_torch_workunit.py::test_workunit_metadata",
    "test_workunit.py::test_any_interleaving_roundtrips_identically":
        "test_torch_workunit.py::test_pack_leaves_queued_work_behind",
    "test_workunit.py::test_deprecated_verbs_removed":
        "test_torch_cluster.py::test_deprecated_verbs_removed",
    "test_workunit.py::test_accelerator_replica_stages_device_resident":
        "test_torch_cluster.py::test_accelerator_replica_stages_device_resident",
    "test_workunit.py::test_slo_preemption_frees_batch_for_interactive":
        "test_torch_cluster.py::test_slo_preemption_frees_batch_for_interactive",
    "test_workunit.py::test_preemption_counts_in_traces":
        "test_torch_cluster.py::test_preemption_counts_in_traces",
    "test_workunit.py::test_cost_aware_scaling_shops_by_price_performance":
        "test_torch_cluster.py::test_cost_aware_scaling_shops_by_price_performance",
    "test_workunit.py::test_default_itype_pool_validated_at_construction":
        "test_torch_cluster.py::test_default_itype_pool_validated_at_construction",
    "test_workunit.py::test_replica_dollar_metering":
        "test_torch_cluster.py::test_replica_dollar_metering",
}


def _tests(path):
    """The ``def test_`` names at the top level of ``path``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    return {node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name.startswith("test_")}


def test_every_reference_test_has_a_port_counterpart():
    reference = {f"{p.name}::{name}"
                 for p in sorted(TESTS.glob("test_*.py"))
                 if not p.name.startswith("test_torch_")
                 for name in _tests(p)}
    port = {f"{p.name}::{name}"
            for p in sorted(TESTS.glob("test_torch_*.py"))
            for name in _tests(p)}
    assert sorted(reference - set(MIRROR)) == [], "reference tests unmapped"
    assert sorted(set(MIRROR) - reference) == [], "no such reference tests"
    for ref, mirror in MIRROR.items():
        if isinstance(mirror, str) and mirror.startswith(NO_COUNTERPART):
            assert len(mirror) > len(NO_COUNTERPART), ref
            continue
        for name in (mirror,) if isinstance(mirror, str) else mirror:
            assert name.startswith("test_torch_"), (ref, name)
            assert name in port, (ref, name)
