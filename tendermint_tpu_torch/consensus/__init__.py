"""The consensus vote path: VoteSet tallies of every round of a height,
the vote messages' wire codec, and the receive loop's vote ingest with
its vote-burst pre-verify on the device (counterpart:
tendermint_tpu/consensus/). The step machine, timeouts, the WAL, replay
and the reactor are not ported yet."""
