"""Small sizes of the cells, for runs on the CPU."""

SMALL = {
    "rs8.encode": {"config": {"payload": {"params": [["a", [1000]], ["b/c", [33, 7]], ["b/d", [5]]]}}},
    "dft64.encode": {"config": {"payload": {"elements_per_node": 1000}}},
    "dft64.rounds": {"config": {"payload": {"elements_per_node": 1000}},
                     "traffic": {"entry_options": {"kernels": None}, "call_columns": 250}},
}
