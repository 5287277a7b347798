"""Task adapters, one module a task (a configuration's ``task``): the
program's model for a configuration, a minibatch of given graphs by the
program's path, and the benchmark's own layout of a raw graph's edges."""
