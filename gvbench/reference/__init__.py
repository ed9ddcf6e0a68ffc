"""The benchmark's plain reference: frozen copies of the program's plain
PyTorch code at commit ab7fbd6 (each file names its original and what
changed). It imports nothing of the program, of JAX or of the JAX
package, and takes nothing the program made."""
