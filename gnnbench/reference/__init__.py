"""Plain references, one module a configuration, named after it. A module
gives ``Context(config, metadata graphs)``, ``Batch(context, graphs,
device)`` and ``loss(context, batch, params, dropout seed, fmt, half)``;
``common`` holds what they share. None of it imports the program."""
