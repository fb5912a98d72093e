from repro_torch.parallel.sharding import (Mesh, NamedSharding, P,
                                           PartitionSpec, ShardingRules,
                                           make_shardings, choose_spec,
                                           lm_rules, LM_RULES, cache_rules,
                                           lutdnn_population_rules,
                                           zero1_shardings, batch_spec,
                                           batch_sharding, dp_axes,
                                           serving_mesh, ambient_mesh)
