"""Split-executing training: ``train_split`` drives the Executor over a
transport of feature-holder workers."""
