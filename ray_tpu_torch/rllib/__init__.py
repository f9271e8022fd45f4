"""The RL learners' compute, the counterpart of the JAX package's
``rllib``: the modules and their distributions (``core/rl_module.py``),
weights across the frameworks (``core/convert.py``), the ``Learner``
(``core/learner.py``), every algorithm's learner (``algorithms/``: PPO,
DQN, IMPALA and APPO, MARWIL and BC, SAC, CQL, DreamerV3) and the acting
step of the env runners (``env/policy.py``). The runtime around them (the
Algorithm loop, the learner group, env runners, replay buffers and the
numpy batch builders) stays in the JAX package; the learners take numpy
batches in its format."""
