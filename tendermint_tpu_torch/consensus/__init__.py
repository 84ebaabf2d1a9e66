"""Consensus (counterpart: tendermint_tpu/consensus/): the step machine
of one node with its receive loop and vote-burst pre-verify on the
device, the round state and VoteSet tallies of every round of a height,
the wire messages and WAL records, the WAL and the timeout ticker, the
consensus reactor and PeerState (its gossip over p2p), and the Byzantine
plane. The Handshaker, the WAL generator, the flight recorder and the
metrics are not ported yet."""
