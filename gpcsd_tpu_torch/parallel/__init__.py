"""Multi-device inference over ``torch.distributed``: the (chain, trial)
mesh (:mod:`.mesh`) and the trial-sharded log-joint with the sharded NUTS,
MAP, ADVI and SMC drivers (:mod:`.sharded`)."""
