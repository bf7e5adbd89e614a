"""The port's counterpart of ``repro.core``: MONET's analytic model, its own
copies of the reference's numpy modules (``graph``, ``accelerators``,
``cost_model``, ``training_transform``, ``memory``, ``engine``, ``verify``,
``scheduling``), its search layer (``nsga2``, ``builders``, ``zoo``,
``fusion``, ``fusion_search``, ``checkpointing``, ``batch``), the front-end
that turns a PyTorch step into its IR (``trace``), and ``remat_policy``, the
bridge from MONET's activation-checkpointing keep-sets to the training step's
selective recompute.  The rest of the reference's core (``parallel``,
``resilience``, ``serving``, ``dse``, ``faultinject``) follows in later
slices (ROADMAP A9).  Exports what the reference's ``core/__init__.py``
exports from these modules."""

from .accelerators import (EDGE_TPU_SPACE, FUSEMAX_SPACE, TPU_V5E,
                           ClusterSpec, CoreSpec, FaultModel, HDASpec,
                           MemLevel, datacenter_cluster,
                           datacenter_fault_model, edge_cluster,
                           edge_fault_model, edge_tpu, fusemax, grid,
                           tpu_v5e_like, with_interconnect)
from .builders import GraphBuilder
from .checkpointing import (ACResult, ACSolution, PolicyResult,
                            PolicySolution, activation_set,
                            apply_checkpointing, apply_policy,
                            evaluate_checkpointing, evaluate_policy,
                            ga_checkpointing, ga_policy, knapsack_baseline,
                            recompute_flops, stored_activation_bytes,
                            uniform_policy)
from .cost_model import (CostModel, NodeCost, collective_wire, comm_cycles,
                         comm_node_cost, dma_cycles, dma_node_cost)
from .engine import (EvalEngine, GraphSigs, clear_engines, get_engine,
                     graph_sigs)
from .fusion import (FusionConfig, GroupChecker, enumerate_candidates,
                     greedy_sram_partition, layer_by_layer, manual_fusion,
                     solve_cover, solve_fusion)
from .fusion_search import (FusionCandidate, FusionSearchConfig,
                            FusionSearchResult, best_partition, decode_genome,
                            encode_partition, evaluate_partition,
                            exhaustive_fusion, fusion_partition,
                            search_fusion, search_fusion_policy)
from .graph import GraphError, Node, TensorSpec, WorkloadGraph
from .memory import (MEM_CATEGORIES, ActivationPolicy, LifetimePlan,
                     MemProfile, apply_offload, build_lifetime_plan,
                     lifetime_profile, local_capacity, schedule_priorities,
                     static_breakdown, tensor_category, tile_working_set)
from .nsga2 import (NSGA2Result, crowding_distance, fast_non_dominated_sort,
                    load_snapshot, nsga2, nsga2_int, save_snapshot)
from .remat_policy import keepset_to_policy, policy_from_keep, resolve_remat
from .scheduling import ScheduleResult, quotient_dag, schedule
from .trace import trace_fn, trace_model
from .training_transform import (OPTIMIZERS, TrainingGraph,
                                 build_training_graph)
from .verify import (RULES, Finding, VerificationError, sanitize_enabled,
                     verify_cache, verify_degrade, verify_graph,
                     verify_parallel, verify_result, verify_schedule)
from .zoo import (gpt2_decode_graph, gpt2_graph, gpt2_prefill_graph,
                  mlp_graph, resnet18_graph)

__all__ = [k for k in dir() if not k.startswith("_")]
