"""The port's counterparts of the JAX repository's `tools/` scripts that
show the system learns and where a train step's time goes:
`sanity_train` (train on synthetic scenes, score through the Tester),
`profile_train` (the batch-8 x 80k train step timed by stage),
`gen_synthetic_dataset` (the multi-class protocol dataset on disk) and
`protocol_run` (the three training stages and the test protocol on it),
and `protocol_run_timed` (the dataset and the protocol run on one card
inside a time budget)."""
