from .viewgraph import (
    covisibility_pairs,
    connected_components,
    largest_connected_component,
    maximum_spanning_tree,
    orientations_from_spanning_tree,
    extract_triplets,
    filter_pairs_by_orientation,
    loop_consistency_filter,
    mfas_position_filter,
)
