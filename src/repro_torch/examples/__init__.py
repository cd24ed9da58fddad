"""The port's workflows, run as modules: ``physics_inference`` (the paper's
train -> PTQ -> QAT -> AUC protocol) and ``train_lm`` (an LM through the
fault-tolerant loop)."""
