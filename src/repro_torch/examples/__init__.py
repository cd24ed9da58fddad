"""The port's workflows, run as modules: ``physics_inference`` (the paper's
train -> PTQ -> QAT -> AUC protocol, and the FPGA latency model),
``train_lm`` (an LM through the fault-tolerant loop) and ``quickstart``
(train, serve float vs int8, the decode step's H100 roofline)."""
