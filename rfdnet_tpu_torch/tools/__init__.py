"""The port's counterparts of the JAX repository's `tools/` scripts that
show the system learns and where a train step's time goes:
`sanity_train` (train on synthetic scenes, score through the Tester) and
`profile_train` (the batch-8 x 80k train step timed by stage)."""
