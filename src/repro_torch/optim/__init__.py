from .adamw import (OptConfig, abstract_opt_state, apply_updates, global_norm,
                    init_opt_state, schedule)
