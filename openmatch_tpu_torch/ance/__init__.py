from .loop import (  # noqa: F401
    AnceConfig,
    generate_hard_negatives,
    latest_ann_data,
    run_ance_alternating,
    run_ance_generator,
    write_ann_data,
)
