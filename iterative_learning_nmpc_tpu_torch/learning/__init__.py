"""The learning stack's serving side: the policy network and its loader,
the observation and safety contracts, and the batched on-device rollouts
(expert datagen and SafeDAgger) on the device plant."""
