"""The `metalchat-tpu-torch` command-line program."""
