"""Consensus (counterpart: tendermint_tpu/consensus/): the step machine
of one node with its receive loop and vote-burst pre-verify on the
device, the round state and VoteSet tallies of every round of a height,
the wire messages and WAL records, the WAL and the timeout ticker, the
consensus reactor and PeerState (its gossip over p2p), and the Byzantine
plane, the Handshaker, the WAL generator and the consensus metrics. The
flight recorder is not ported yet (ROADMAP item 11b)."""
