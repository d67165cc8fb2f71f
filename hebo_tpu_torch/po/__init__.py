from .sparsepo import (
    TinyLM, make_pref_data, preference_accuracy, sparse_dpo_loss, tinylm_from_flax,
    train_sparse_po,
)
