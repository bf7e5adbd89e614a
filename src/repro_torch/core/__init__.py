"""The port's counterpart of ``repro.core``: so far only ``remat_policy``,
the bridge from MONET's activation-checkpointing keep-sets to the training
step's selective recompute.  The numpy core follows in a later slice."""
