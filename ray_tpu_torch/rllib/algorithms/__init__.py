"""Each algorithm's learner: its loss, term for term as the JAX
package's, and its hooks."""
