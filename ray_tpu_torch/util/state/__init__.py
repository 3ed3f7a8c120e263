from ray_tpu_torch.util.state.api import (get_log, get_trace,  # noqa: F401
                                    list_actors, list_nodes, list_objects,
                                    list_placement_groups, list_tasks,
                                    list_traces, memory_summary,
                                    summarize_actors, summarize_objects,
                                    summarize_tasks, timeline)
