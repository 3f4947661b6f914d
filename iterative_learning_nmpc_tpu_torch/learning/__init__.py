"""The learning stack: the policy network (serving and training), its
loader and payloads, the observation and safety contracts, the batched
on-device rollouts (expert datagen and SafeDAgger), the replay database,
the behaviour-cloning trainer and the on-device SafeDAgger loop."""
