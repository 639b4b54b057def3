"""The LITune system: parameter spaces, reward, networks, DDPG, ET-MDP and
the top-level tuner (twin of `repro/core`)."""
