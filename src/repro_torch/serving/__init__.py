"""Batched quantized serving of the SO3krates force field (the port's
counterpart of ``repro.serving``)."""
from repro_torch.serving.bucketing import (BatchPlan, BucketSpec, EdgeList,
                                           Graph, assign_bucket,
                                           build_edge_list, count_edges,
                                           default_edge_capacity,
                                           pad_graphs, plan_batches,
                                           random_graph, random_graphs)
from repro_torch.serving.engine import (MoleculeResult, QuantizedEngine,
                                        ServeConfig)
from repro_torch.serving.qparams import (QTensor, QuantizedParams,
                                         quantize_so3_params, serving_bytes,
                                         serving_fp32_equiv)

__all__ = ["BatchPlan", "BucketSpec", "EdgeList", "Graph", "assign_bucket",
           "build_edge_list", "count_edges", "default_edge_capacity",
           "pad_graphs", "plan_batches", "random_graph", "random_graphs",
           "MoleculeResult", "QuantizedEngine", "ServeConfig", "QTensor",
           "QuantizedParams", "quantize_so3_params", "serving_bytes",
           "serving_fp32_equiv"]
