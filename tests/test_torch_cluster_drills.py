"""The slow drills of ``tests/test_cluster.py`` on the port: node
removal mid-workload, a many-node stress, a detached actor outliving its
driver and node, and transparent calls across an actor restart.

Each runs on the port's ``Cluster`` fixture and is held to the reference
test's own assertions (``_torch_port_copy.py``); the reference half is
the reference's own test, not run again here (each drill takes 14-37 s).
"""

from tests._torch_port_copy import export, port_copy

_ref = port_copy("test_cluster.py")
export(_ref, globals(), ["test_cluster_remove_node_survival",
                         "test_many_nodes_scale_stress",
                         "test_detached_actor_survives_driver_and_node_death",
                         "test_cluster_actor_restart_transparent_calls"])
